"""The host-side pieces around the port's tensor-core attention kernels,
on the CPU.

The kernels themselves (``fa_fwd_bf16_wgmma``, ``fa_bwd_dq_bf16_wgmma``,
``fa_bwd_dkv_bf16_wgmma`` and the float32 ``fa_fwd_f32_tf32x3``,
``fa_bwd_dq_f32_tf32x3`` and ``fa_bwd_dkv_f32_tf32x3`` in
``mxnet_tpu_torch/csrc``) run only on the card, where ``chip_smoke.py``
holds them against their plain versions; their plain versions are held
against the reference's Pallas kernels by
``tests/test_torch_flash_attention*.py``. Here: the build report that
``chip_smoke.py`` reads (ptxas registers and spills, SASS opcode counts),
the 16-byte alignment that TMA needs of lse and delta, and a rehearsal of
``chip_smoke.py``'s sweeps, timings and training phases on the CPU, with
the kernel wrappers replaced by plain versions at small shapes.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch import _build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

FWD = ("_ZN55_GLOBAL__N__c38aed5a_22_flash_attention_fwd_cu_74881bc317fa_fwd"
       "_bf16_wgmmaILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiifi")
OLD = "_ZN12_GLOBAL__N_111fa_fwd_bf16ILi32EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiifi"

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '%(fwd)s' for 'sm_90a'
ptxas info    : Function properties for %(fwd)s
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Function properties for _Z6helperv
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '%(old)s' for 'sm_90a'
ptxas info    : Function properties for %(old)s
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
""" % {"fwd": FWD, "old": OLD}

SASS = """\
\tcode for sm_90a
\t\tFunction : %(fwd)s
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0a10*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0a20*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;
        /*0b00*/              @P0  UTMALDG.3D [UR8], [UR6] ;
        /*0b10*/             @!P1  UTMALDG.3D [UR16], [UR6] ;
        /*0b20*/                   MOV R2, 0x1 ;  /* HGMMA in a comment */
\t\tFunction : %(old)s
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
""" % {"fwd": FWD, "old": OLD}


def test_ptxas_resources_reads_each_kernel():
    res = _build.ptxas_resources(PTXAS_LOG)
    assert set(res) == {FWD, OLD}   # the device function is no kernel
    assert res[FWD] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                        "registers": 168}
    assert res[OLD] == {"stack": 8, "spill_stores": 12, "spill_loads": 4,
                        "registers": 255}


def test_parse_sass_counts_counts_opcodes_per_kernel():
    counts = _build.parse_sass_counts(SASS, ("HGMMA", "UTMALDG"))
    assert counts == {FWD: {"HGMMA": 2, "UTMALDG": 2},
                      OLD: {"HGMMA": 0, "UTMALDG": 0}}


def test_sass_counts_without_cuobjdump_raises(monkeypatch, tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert _build.cuobjdump() is None
    with pytest.raises(MXNetError, match="cuobjdump not found"):
        _build.sass_counts("flash_attention_fwd.cu", ("HGMMA",))
    (nvcc.parent / "cuobjdump").write_text("")
    assert _build.cuobjdump() == str(nvcc.parent / "cuobjdump")


def test_backward_inputs_align_lse_and_delta():
    """TMA reads lse and delta from a 16-byte aligned base: a view 4
    bytes into its storage is copied, an aligned one passed as is."""
    bh, sq, d = 2, 5, 64
    q = torch.zeros((bh, sq, d), dtype=torch.bfloat16)
    store = torch.zeros(bh * sq + 1)
    lse = store[1:].view(bh, sq)
    delta = torch.zeros((bh, sq))
    assert lse.data_ptr() % 16 == 4
    _, _, ins = fa._bwd_inputs(q, q, q, q, lse, delta)
    assert ins[4].data_ptr() % 16 == 0 and torch.equal(ins[4], lse)
    assert ins[5].data_ptr() == delta.data_ptr()


def test_bf16_compare_limits():
    rng = np.random.default_rng(0)
    want = torch.from_numpy(rng.standard_normal((4, 64, 64))
                            .astype(np.float32))
    assert chip_smoke.bf16_compare(want.bfloat16(), want)["ok"]
    off = want.clone()
    off[0, 0, 0] += 0.5             # one element 0.5 rms(ref) off
    r = chip_smoke.bf16_compare(off, want)
    assert not r["ok"] and r["over"] > chip_smoke.BF16_ELEM_RMS
    zero = torch.zeros((2, 3))
    assert chip_smoke.bf16_compare(zero, zero)["ok"]


def _plain_dkv(q, k, v, do, lse, delta, scale, causal):
    """dK, dV by the kernels' formulas from lse and delta."""
    p = torch.exp(fa._scores(q, k, scale, causal) - lse[..., None])
    dof = do.float()
    ds = p * (dof @ v.float().transpose(-1, -2) - delta[..., None]) * scale
    return ((ds.transpose(-1, -2) @ q.float()).to(k.dtype),
            (p.transpose(-1, -2) @ dof).to(v.dtype))


def _plain_dq(q, k, v, do, lse, delta, scale, causal):
    """dQ by the kernels' formulas from lse and delta."""
    p = torch.exp(fa._scores(q, k, scale, causal) - lse[..., None])
    ds = p * (do.float() @ v.float().transpose(-1, -2)
              - delta[..., None]) * scale
    return (ds @ k.float()).to(q.dtype)


def test_edge_sweep_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's edge sweep at small shapes on the CPU, the kernel
    wrappers replaced by plain versions, at a head dim of each route
    (16: mma.sync, 64: wgmma): every case passes its limits, the
    exactly-zero dQ and dK cases (S = 1 causal, Sk = 1) included."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SWEEP_HEADS", (1, 2))
    monkeypatch.setattr(chip_smoke, "SWEEP_DIMS", (16, 64))
    monkeypatch.setattr(chip_smoke, "SWEEP_LENGTHS",
                        ((1, 1), (65, 65), (40, 96), (96, 40)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _plain_dq)
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _plain_dkv)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    worst = chip_smoke.edge_sweep(torch)
    assert 0 <= worst["fwd"] < 0.05 and 0 <= worst["dkv"] < 0.05
    assert 0 <= worst["dq"] < 0.05
    assert lines[-1].startswith("edge sweep: 32 cases of K1 bf16, K2 and K3")
    zero = [ln for ln in lines if "zero in exact arithmetic" in ln]
    assert len(zero) == 8 and all("dq kernel max" in ln and "dk kernel max"
                                  in ln for ln in zero)
    # every other case compares dQ under the bf16 limits
    assert sum(" dq max " in ln for ln in lines) == 32 - 8


def test_f32_sweep_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's f32 sweep of K1 f32, K2 f32 and K3 f32 at small
    shapes on the CPU (the forward wrapper takes the plain version
    there, the backward wrappers are replaced by plain versions): every
    case is logged and held to KERNEL_ATOL, the exactly-zero dQ and dK
    cases (S = 1 causal, Sk = 1) to ZERO_GRAD_ATOL, and a case that
    disagrees ends the run."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "F32_SWEEP_HEADS", (1, 2))
    monkeypatch.setattr(chip_smoke, "F32_SWEEP_DIMS", (16, 64))
    monkeypatch.setattr(chip_smoke, "F32_SWEEP_LENGTHS",
                        ((1, 1), (65, 65), (40, 96), (96, 40)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _plain_dq)
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _plain_dkv)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    worst = chip_smoke.f32_sweep(torch)
    assert worst["fwd"] == 0.0
    assert 0 <= worst["dq"] < 1e-5 and 0 <= worst["dkv"] < 1e-5
    assert lines[-1].startswith("f32 sweep: 32 cases of K1 f32, K2 f32 and "
                                "K3 f32")
    cases = [ln for ln in lines if ln.startswith("  f32 sweep d=")]
    assert len(cases) == 32 and all(" dv " in ln for ln in cases)
    assert sum("zero in exact arithmetic" in ln for ln in cases) == 8

    plain = fa.flash_attention_fwd

    def off(q, k, v, scale, causal):
        o, lse = plain(q, k, v, scale, causal)
        return o + 2e-4, lse
    monkeypatch.setattr(fa, "flash_attention_fwd", off)
    with pytest.raises(chip_smoke.SmokeFailure, match="f32 sweep d=16 bh=1"):
        chip_smoke.f32_sweep(torch)
    monkeypatch.setattr(fa, "flash_attention_fwd", plain)

    def dkv_off(*args):
        dk, dv = _plain_dkv(*args)
        return dk, dv + 2e-4
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", dkv_off)
    with pytest.raises(chip_smoke.SmokeFailure, match=r"\['dv'\] disagree"):
        chip_smoke.f32_sweep(torch)


def test_head_dim_sweep_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's head-dim sweep at small shapes on the CPU, where
    flash_attention and its backward take the plain versions at the
    padded head dim: every padded dim (48, 80) and D 256, f32 and bf16,
    passes its limits against the plain versions at the real D, and a
    head dim above 256 raises naming ROADMAP B7."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "HEAD_DIM_SWEEP_DIMS", (48, 80, 256))
    monkeypatch.setattr(chip_smoke, "HEAD_DIM_SWEEP_HEADS", (1, 2))
    monkeypatch.setattr(chip_smoke, "HEAD_DIM_SWEEP_LENGTHS", (65,))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    worst = chip_smoke.head_dim_sweep(torch)
    assert max(worst["f32"].values()) < 1e-5
    assert max(worst["bf16"].values()) < 0.05
    cases = [ln for ln in lines if ln.startswith("  head-dim sweep d=")]
    assert len(cases) == 3 * 2 * 2 * 2
    assert any("D 320 raises ValueError" in ln and "B7" in ln for ln in lines)
    assert lines[-1].startswith("head-dim sweep: 24 cases")


def test_tf32x3_bound_and_the_fma_bound():
    """At the serving shape (BH 16, S 1024, D 128, causal) the forward's
    3xTF32 bound takes 3 x 4.30 GFLOP at 495 TFLOP/s; the FMA bound,
    logged beside it, 4.30 GFLOP at 67 TFLOP/s."""
    ms, by, fma_ms, flops, nbytes = chip_smoke.f32_attention_bounds(
        "fwd", 16, 1024, 1024, 128, True)
    assert by == "operations"
    assert flops == pytest.approx(4.30e9, rel=1e-3)
    assert ms == pytest.approx(3 * flops / 495e12 * 1e3)
    assert nbytes / 3.35e12 * 1e3 < ms
    assert nbytes == 4.0 * (4 * 16 * 1024 * 128 + 16 * 1024)
    assert fma_ms == pytest.approx(0.0642, abs=1e-4)
    assert fma_ms > ms


def test_prompt_buckets_follow_the_server_ladder():
    """The burst's prompts land in the serving ladder's power-of-two
    buckets from the page up, as the engine's prompt_bucket puts them."""
    from mxnet_tpu_torch.serve.bucketing import decode_buckets
    buckets = chip_smoke.prompt_buckets()
    assert buckets == [32, 64, 256, 256, 512, 1024, 1024, 1024]
    ladder = decode_buckets(chip_smoke.MAX_SEQ, chip_smoke.PAGE)
    for n, b in zip(chip_smoke.PROMPT_LENS, buckets):
        assert b in ladder and n <= b and (b == ladder[0] or
                                           ladder[ladder.index(b) - 1] < n)


class _Event:
    """A CUDA event stand-in on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class _Trace:
    """A torch.profiler stand-in whose traces hold the kernel rows of
    ``traces``, one list of (device us, kernel records) per trace taken:
    an empty list is a trace in which CUPTI delivered no device activity,
    a count that is no multiple of the calls one that lost records."""

    def __init__(self, traces):
        self.traces = list(traces)
        self.taken = 0

    def __call__(self, activities):
        self.taken += 1
        cuda = torch.autograd.DeviceType.CUDA
        return _Profile([type("Row", (), {"device_type": cuda,
                                          "self_device_time_total": us,
                                          "count": n})
                         for us, n in self.traces.pop(0)])


class _Profile:
    def __init__(self, rows):
        self.rows = rows

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return self.rows


@pytest.mark.parametrize("traces,taken,want", [
    # a whole trace: one kernel a call, another twice a call
    ([[(40.0, 4), (20.0, 8)]], 1, 0.015),
    # records lost: means per kernel give the same time
    ([[(30.0, 3), (17.5, 7)]], 1, 0.015),
    # a kernel seen once in four calls adds its time over the calls
    ([[(40.0, 4), (3.0, 1)]], 1, 0.01075),
    # an empty trace, taken again
    ([[], [(40.0, 4)]], 2, 0.01),
    # every trace empty: CUDA events
    ([[], [], []], 3, None),
])
def test_kernel_ms_survives_lost_records(monkeypatch, traces, taken, want):
    """Profiler traces on the card lose kernel records, and one held none
    (chip_smoke then divided by a kernel time of 0): kernel_ms reads each
    kernel's mean duration times its launches per call, takes an empty
    trace again, and falls back to CUDA events when every trace is
    empty; it never returns 0."""
    import time
    import torch.profiler
    trace = _Trace(traces)
    monkeypatch.setattr(torch.profiler, "profile", trace)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "log", lambda *a: None)
    ms = chip_smoke.kernel_ms(torch, lambda: time.sleep(1e-4), iters=4)
    assert trace.taken == taken and ms > 0
    if want is not None:
        assert ms == pytest.approx(want)


def test_timing_reports_median_spread_and_host_time(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    t = chip_smoke.timing(torch, lambda: calls.append(1), iters=4, windows=5)
    assert len(calls) == 3 + 5 * 4          # warm-up, then the windows
    assert t["lo"] <= t["ms"] <= t["hi"] and t["host_us"] >= 0
    # the stand-in events bracket the host's loop: device >= host time
    assert t["host_us"] / 1e3 <= t["hi"]
    assert t["host_bound"] == (t["host_us"] / 1e3 >= t["ms"])
    assert "over 5 windows" in chip_smoke.spread(t)


def _fake_build(monkeypatch, log, counts, tool="cuobjdump"):
    monkeypatch.setattr(_build, "build_log", lambda source: log)
    monkeypatch.setattr(_build, "cuobjdump", lambda: tool)

    def sass(source, opcodes):
        if isinstance(counts, Exception):
            raise counts
        return counts
    monkeypatch.setattr(_build, "sass_counts", sass)
    monkeypatch.setattr(chip_smoke, "WGMMA_KERNELS",
                        {"flash_attention_fwd_bf16": ("flash_attention_fwd.cu",
                                                      "fa_fwd_bf16_wgmma")})
    monkeypatch.setattr(chip_smoke, "MMA_KERNELS", {})
    monkeypatch.setattr(chip_smoke, "BUILD_REPORT", {})
    monkeypatch.setattr(chip_smoke, "log", lambda *a: None)


def test_wgmma_report_records_registers_and_instructions(monkeypatch):
    _fake_build(monkeypatch, PTXAS_LOG, {FWD: {"HGMMA": 2, "UTMALDG": 2}})
    chip_smoke.wgmma_report(_build)
    report = chip_smoke.BUILD_REPORT["flash_attention_fwd_bf16"]
    assert report["ptxas"][FWD]["registers"] == 168
    assert report["ptxas"][FWD]["serialized"] is False
    assert report["sass"] == {FWD: {"HGMMA": 2, "UTMALDG": 2}}


@pytest.mark.parametrize("log, counts, match", [
    (PTXAS_LOG.replace("0 bytes spill stores", "8 bytes spill stores", 1),
     {FWD: {"HGMMA": 2, "UTMALDG": 2}}, "spills 8 bytes"),
    (PTXAS_LOG, {FWD: {"HGMMA": 0, "UTMALDG": 2}}, "HGMMA and UTMALDG"),
    (PTXAS_LOG, {}, "HGMMA and UTMALDG"),
    (PTXAS_LOG.replace(FWD, "other"), {}, "no ptxas report"),
], ids=["spill", "no-hgmma", "no-sass", "no-kernel"])
def test_wgmma_report_fails(monkeypatch, log, counts, match):
    _fake_build(monkeypatch, log, counts)
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.wgmma_report(_build)


def test_wgmma_report_without_cuobjdump_still_checks_spills(monkeypatch):
    _fake_build(monkeypatch, PTXAS_LOG, MXNetError("cuobjdump not found"),
                tool=None)
    chip_smoke.wgmma_report(_build)
    assert chip_smoke.BUILD_REPORT["flash_attention_fwd_bf16"]["sass"] is None
    spilled = PTXAS_LOG.replace("0 bytes spill stores", "8 bytes spill stores",
                                1)
    _fake_build(monkeypatch, spilled, {}, tool=None)
    with pytest.raises(chip_smoke.SmokeFailure, match="spills 8 bytes"):
        chip_smoke.wgmma_report(_build)


def test_wgmma_report_ends_on_a_failing_cuobjdump(monkeypatch):
    """A cuobjdump that is there but fails (a truncated library, say)
    ends the run: only its absence skips the SASS check."""
    _fake_build(monkeypatch, PTXAS_LOG,
                MXNetError("cuobjdump -sass flash_attention_fwd.cu failed "
                           "(exit 255)"))
    with pytest.raises(MXNetError, match="failed"):
        chip_smoke.wgmma_report(_build)


DQ = ("_ZN55_GLOBAL__N__c38aed5a_22_flash_attention_bwd_cu_a1b2c3d420fa_bwd"
      "_dq_bf16_wgmmaILi128EEEv14CUtensorMap_stS1_S1_S1_S1_S1_P13__nv_bfloat16"
      "iifi")
TF32 = ("_ZN55_GLOBAL__N__c38aed5a_22_flash_attention_fwd_cu_74881bc317fa_fwd"
        "_f32_tf32x3ILi128ELi32ELi2EEEvPKfS2_S2_PfS3_iifi")
DQF32 = ("_ZN55_GLOBAL__N__c38aed5a_22_flash_attention_bwd_cu_a1b2c3d420fa_bwd"
         "_dq_f32_tf32x3ILi128ELi32ELi2EEEvPKfS2_S2_S2_S2_S2_Pfiifi")
DKVF32 = ("_ZN55_GLOBAL__N__c38aed5a_22_flash_attention_bwd_cu_a1b2c3d421fa_bwd"
          "_dkv_f32_tf32x3ILi128ELi32ELb0EEEvPKfS2_S2_S2_S2_S2_PfS3_iifi")


def _entry(name, spill=0, regs=168):
    return ("ptxas info    : Compiling entry function '%s' for 'sm_90a'\n"
            "ptxas info    : Function properties for %s\n"
            "    0 bytes stack frame, %d bytes spill stores, 0 bytes spill "
            "loads\n"
            "ptxas info    : Used %d registers, used 1 barriers\n"
            % (name, name, spill, regs))


def _fake_tables(monkeypatch, logs, counts):
    """The build report over the real kernel tables, with each source's
    ptxas log and SASS counts given."""
    monkeypatch.setattr(_build, "build_log", lambda source: logs[source])
    monkeypatch.setattr(_build, "cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(_build, "sass_counts",
                        lambda source, opcodes: counts[source])
    monkeypatch.setattr(chip_smoke, "BUILD_REPORT", {})
    monkeypatch.setattr(chip_smoke, "log", lambda *a: None)


def _tables_ok():
    dkv = FWD.replace("fwd_cu", "bwd_cu").replace("fa_fwd_bf16_wgmma",
                                                  "fa_bwd_dkv_bf16_wgmma")
    logs = {"flash_attention_fwd.cu": _entry(FWD) + _entry(TF32, regs=200),
            "flash_attention_bwd.cu": _entry(DQ) + _entry(dkv) +
            _entry(DQF32, regs=190) + _entry(DKVF32, regs=210)}
    wg = {"HGMMA": 60, "UTMALDG": 10}
    mma = {"HGMMA": 0, "UTMALDG": 0, "HMMA": 240}
    counts = {"flash_attention_fwd.cu": {FWD: dict(wg, HMMA=0),
                                         TF32: dict(mma)},
              "flash_attention_bwd.cu": {DQ: dict(wg, HMMA=0),
                                         dkv: dict(wg, HMMA=0),
                                         DQF32: dict(mma),
                                         DKVF32: dict(mma)}}
    return logs, counts


def test_report_covers_the_new_tensor_core_kernels(monkeypatch):
    """The real tables name K2's wgmma kernel (HGMMA and UTMALDG) and
    the 3xTF32 kernels of K1 f32, K2 f32 and K3 f32 (HMMA); a clean
    build of all six passes and is recorded under each kernel's record
    name."""
    assert chip_smoke.WGMMA_KERNELS["flash_attention_bwd_dq"] == (
        "flash_attention_bwd.cu", "fa_bwd_dq_bf16_wgmma")
    assert chip_smoke.MMA_KERNELS == {
        "flash_attention_fwd": ("flash_attention_fwd.cu",
                                "fa_fwd_f32_tf32x3"),
        "flash_attention_bwd_dq_f32": ("flash_attention_bwd.cu",
                                       "fa_bwd_dq_f32_tf32x3"),
        "flash_attention_bwd_dkv_f32": ("flash_attention_bwd.cu",
                                        "fa_bwd_dkv_f32_tf32x3")}
    logs, counts = _tables_ok()
    _fake_tables(monkeypatch, logs, counts)
    chip_smoke.wgmma_report(_build)
    report = chip_smoke.BUILD_REPORT
    assert set(report) == {"flash_attention_fwd_bf16", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "flash_attention_fwd",
                           "flash_attention_bwd_dq_f32",
                           "flash_attention_bwd_dkv_f32"}
    assert list(report["flash_attention_bwd_dq"]["ptxas"]) == [DQ]
    assert report["flash_attention_fwd"]["ptxas"][TF32]["registers"] == 200
    assert list(report["flash_attention_bwd_dq_f32"]["ptxas"]) == [DQF32]
    assert report["flash_attention_bwd_dkv_f32"]["sass"][DKVF32]["HMMA"] == 240


@pytest.mark.parametrize("source, name, opcode, match", [
    ("flash_attention_bwd.cu", DQ, "HGMMA", "HGMMA and UTMALDG"),
    ("flash_attention_bwd.cu", DQ, "UTMALDG", "HGMMA and UTMALDG"),
    ("flash_attention_fwd.cu", TF32, "HMMA", r"HMMA expected"),
    ("flash_attention_bwd.cu", DQF32, "HMMA", r"HMMA expected"),
    ("flash_attention_bwd.cu", DKVF32, "HMMA", r"HMMA expected"),
], ids=["dq-no-hgmma", "dq-no-utmaldg", "f32-no-hmma", "dq-f32-no-hmma",
        "dkv-f32-no-hmma"])
def test_report_ends_the_run_without_tensor_core_instructions(
        monkeypatch, source, name, opcode, match):
    """A dQ kernel whose SASS lacks HGMMA or UTMALDG, or a K1 f32 kernel
    without HMMA (the f32 route off the tensor cores), ends the run."""
    logs, counts = _tables_ok()
    counts[source][name][opcode] = 0
    _fake_tables(monkeypatch, logs, counts)
    with pytest.raises(chip_smoke.SmokeFailure, match=match):
        chip_smoke.wgmma_report(_build)


def test_report_ends_the_run_on_a_spilling_f32_kernel(monkeypatch):
    logs, counts = _tables_ok()
    logs["flash_attention_fwd.cu"] = _entry(FWD) + _entry(TF32, spill=16)
    _fake_tables(monkeypatch, logs, counts)
    with pytest.raises(chip_smoke.SmokeFailure, match="spills 16 bytes"):
        chip_smoke.wgmma_report(_build)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_report_ends_the_run_on_a_spilling_f32_backward_kernel(monkeypatch,
                                                               kernel):
    logs, counts = _tables_ok()
    logs["flash_attention_bwd.cu"] = logs["flash_attention_bwd.cu"].replace(
        _entry(DQF32 if kernel == "dq" else DKVF32,
               regs=190 if kernel == "dq" else 210),
        _entry(DQF32 if kernel == "dq" else DKVF32, spill=8))
    _fake_tables(monkeypatch, logs, counts)
    with pytest.raises(chip_smoke.SmokeFailure, match="spills 8 bytes"):
        chip_smoke.wgmma_report(_build)


def _counting(plain):
    """A kernel wrapper stand-in around a plain version, counting its
    calls by input dtype as the real wrappers count their launches."""
    def wrapper(*args):
        key = "bf16" if args[0].dtype == torch.bfloat16 else "f32"
        wrapper.launches[key] += 1
        return plain(*args)
    wrapper.launches = {"f32": 0, "bf16": 0}
    return wrapper


@pytest.fixture
def small_lm(monkeypatch):
    """chip_smoke's training phases on the CPU: the zoo LM at a small
    width, counting wrappers around the plain attention versions, and
    the CUDA-only calls (events, memory statistics) stood in for."""
    import mxnet_tpu_torch as mt
    for name, value in (("DEVICE", "cpu"), ("VOCAB", 64), ("LAYERS", 2),
                        ("D_MODEL", 32), ("HEADS", 2), ("D_FF", 64),
                        ("MAX_SEQ", 16), ("TRAIN_BATCH", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _counting(_plain_dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _counting(_plain_dkv))
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    return lines


@pytest.mark.parametrize("phase, dtype", [("train_f32_phase", "f32"),
                                          ("train_phase", "bf16")])
def test_train_phases_rehearsal_on_cpu(small_lm, monkeypatch, phase, dtype):
    """train_f32_phase (amp off) and train_phase (amp bf16) at a small
    width on the CPU: the step-1 cross-entropy agrees with the plain
    forward, the loss falls, and each attention kernel ran once per layer
    per counted step with inputs of the phase's dtype only, which the
    phase writes into the kernel table. The f32 step keeps the card's
    CE_TOL (1e-3); the bf16 step's loss over these 32 tokens moves by
    bf16 roundings of ~1e-3 that the card's 8192 tokens average away,
    so it is held to 1e-2 here."""
    lines = small_lm
    if dtype == "bf16":
        monkeypatch.setattr(chip_smoke, "CE_TOL", 1e-2)
    kernels = {n: {} for n in (
        "flash_attention_fwd", "flash_attention_fwd_bf16",
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32")}
    getattr(chip_smoke, phase)(torch, np, kernels)
    if dtype == "f32":
        steps = 1 + chip_smoke.TRAIN_F32_WARM + chip_smoke.TRAIN_F32_TIMED
        names = ("flash_attention_bwd_dq_f32", "flash_attention_bwd_dkv_f32")
        assert kernels["flash_attention_fwd"]["train_f32_launches"] == \
            steps * 2
        prefix = "train f32: "
    else:
        steps = 1 + chip_smoke.TRAIN_WARM + chip_smoke.TRAIN_TIMED
        names = ("flash_attention_fwd_bf16", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
        prefix = "train: "
    for name in names:
        assert kernels[name]["launches"] == steps * 2     # 2 layers
    assert any(ln.startswith(prefix + "step-1 cross-entropy")
               for ln in lines)
    assert any(ln.startswith(prefix + "loss per step") for ln in lines)


def test_train_f32_phase_ends_on_a_bf16_launch(small_lm, monkeypatch):
    """A bf16 launch in the f32 training phase (amp left on) ends the
    run (the loss check held to 1e-2, as for the bf16 rehearsal)."""
    import mxnet_tpu_torch as mt
    monkeypatch.setattr(chip_smoke, "CE_TOL", 1e-2)
    mt.amp.init("bfloat16")
    try:
        with pytest.raises(chip_smoke.SmokeFailure, match="f32 only"):
            chip_smoke.train_f32_phase(torch, np, {
                n: {} for n in ("flash_attention_fwd",
                                "flash_attention_bwd_dq_f32",
                                "flash_attention_bwd_dkv_f32")})
    finally:
        mt.amp.off()


def test_f32_backward_and_d256_timing_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's timing of K2 f32 / K3 f32 beside SDPA f32's backward,
    and of the six D 256 instances, at small shapes on the CPU with the
    kernel wrappers replaced by plain versions: every reading and both
    bounds are there."""
    for name, value in (("DEVICE", "cpu"), ("TRAIN_BATCH", 1), ("HEADS", 2),
                        ("MAX_SEQ", 32), ("D_MODEL", 32)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(chip_smoke, "kernel_ms", lambda torch, fn: 1.0)
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _plain_dq)
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _plain_dkv)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    t = chip_smoke.f32_backward_timing(torch)
    assert set(t) == {"dq", "dkv", "library", "plain_ms"}
    for what in ("dq", "dkv"):
        assert t[what]["device_ms"] == 1.0 and t[what]["ms"] > 0
        assert t[what]["bound_ms"] <= t[what]["fma_ms"]
        assert t[what]["bound_ms"] == pytest.approx(
            chip_smoke.f32_attention_bounds(what, 2, 32, 32, 16, True)[0])
    assert sum(ln.startswith("flash_attention_bwd_") for ln in lines) == 2
    d256 = chip_smoke.d256_timing(torch)
    assert {tag: set(v) for tag, v in d256.items()} == {
        "f32": {"fwd", "dq", "dkv"}, "bf16": {"fwd", "dq", "dkv"}}
    assert sum(ln.startswith("d256 ") for ln in lines) == 6


def test_f32_backward_bounds_at_the_training_shape():
    """At BH 128, S 1024, D 128, causal: dQ 51.6 GFLOP, 0.313 ms on
    3xTF32 (0.770 on FMAs) against 336.6 MB, 0.100 ms; dK/dV 68.8
    GFLOP, 0.417 ms (1.027) against 403.7 MB, 0.120 ms: operations bound
    both."""
    for what, gflop, ms, fma, mb in (("dq", 51.59, 0.3127, 0.7700, 336.6),
                                     ("dkv", 68.79, 0.4169, 1.0267, 403.7)):
        bound, by, fma_ms, flops, nbytes = chip_smoke.f32_attention_bounds(
            what, 128, 1024, 1024, 128, True)
        assert by == "operations"
        assert flops / 1e9 == pytest.approx(gflop, abs=0.01)
        assert bound == pytest.approx(ms, abs=1e-4)
        assert fma_ms == pytest.approx(fma, abs=1e-4)
        assert nbytes / 1e6 == pytest.approx(mb, abs=0.1)


def test_f32_backward_of_another_checkout_needs_a_card():
    """``chip_smoke.py --pairs-of CHECKOUT f32-backward`` imports the
    package of that checkout and, without a card, ends with exit code 1
    and no readings."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(chip_smoke.__file__).resolve().parent
    r = subprocess.run([sys.executable, str(root / "chip_smoke.py"),
                        "--pairs-of", str(root), "f32-backward"],
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1
    assert "package %s" % (root / "mxnet_tpu_torch" / "__init__.py") in r.stdout
    assert "is_available() is False" in r.stderr
    assert "dq" not in r.stdout


@pytest.mark.parametrize("what,rc", [("rtc", 1), ("fit-loop", 1),
                                     ("attention", 2)])
def test_pairs_of_another_checkout(what, rc):
    """``--pairs-of CHECKOUT rtc`` imports that checkout's package and,
    without a card, ends with exit code 1 and no readings; a part that
    the option does not know ends with exit code 2 before any import."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(chip_smoke.__file__).resolve().parent
    r = subprocess.run([sys.executable, str(root / "chip_smoke.py"),
                        "--pairs-of", str(root), what],
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == rc
    assert ("package %s" % (root / "mxnet_tpu_torch" / "__init__.py")
            in r.stdout) == (rc == 1)
    assert ("is_available() is False" if rc == 1 else "WHAT one of") \
        in r.stderr
    assert "relu" not in r.stdout


@pytest.fixture
def small_resnet(monkeypatch):
    """chip_smoke's ResNet phases on the CPU: ResNet-18 (v2, s2d stem)
    at 64x64, batch 4, 10 classes, with counting wrappers around the
    plain attention versions (which must not run) and the CUDA-only
    calls stood in for. The amp bf16 step-1 cross-entropy of 4 images
    moves by bf16 roundings of up to 2e-2 (measured 0.0198) that the
    card's 128 images average down, so it is held to 5e-2 here; every
    other limit is the card's."""
    import mxnet_tpu_torch as mt
    for name, value in (("DEVICE", "cpu"), ("RESNET_LAYERS", 18),
                        ("RESNET_CLASSES", 10), ("RESNET_BATCH", 4),
                        ("RESNET_IMAGE", 64), ("RESNET_WARM", 1),
                        ("RESNET_TIMED", 2), ("RESNET_F32_WARM", 1),
                        ("RESNET_F32_TIMED", 1), ("RESNET_CE_TOL", 5e-2)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", _counting(_plain_dq))
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _counting(_plain_dkv))
    for flag in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flag, "allow_tf32", False)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    return lines


def test_resnet_phase_rehearsal_on_cpu(small_resnet):
    """resnet_phase (amp bf16, then f32) on a small ResNet: the step-1
    cross-entropy agrees with the plain forward (its 7x7 stem against
    the port's s2d one), the moving statistics with its batch
    statistics, the loss falls and no attention kernel runs."""
    lines = small_resnet
    chip_smoke.resnet_phase(torch, np)
    for what in ("resnet: ", "resnet f32: "):
        assert any(ln.startswith(what + "step-1 cross-entropy")
                   for ln in lines)
        assert any(ln.startswith(what + "step-1 moving statistics of 19 "
                                 "BatchNorms") for ln in lines)
        assert any(ln.startswith(what + "loss per step") for ln in lines)
    assert any(ln.startswith("resnet device time by kind") for ln in lines)


def _wrong_batch_norm(kind):
    """BatchNorm whose moving statistics are wrong: torch's momentum
    (the weight of the new value), or never committed."""
    from mxnet_tpu_torch.ops import get_op
    right = get_op("BatchNorm").fn

    def fn(data, gamma, beta, moving_mean, moving_var, **kw):
        out, mean, var, new_mm, new_mv = right(
            data, gamma, beta, moving_mean, moving_var, **kw)
        if kind == "uncommitted":
            return out, mean, var, moving_mean, moving_var
        m = kw.get("momentum", 0.9)
        return (out, mean, var, (1 - m) * moving_mean + m * mean.detach(),
                (1 - m) * moving_var + m * var.detach())
    fn.__signature__ = __import__("inspect").signature(right)
    return fn


@pytest.mark.parametrize("kind", ["torch_momentum", "uncommitted"])
def test_resnet_phase_ends_on_wrong_moving_statistics(small_resnet,
                                                      monkeypatch, kind):
    from mxnet_tpu_torch.ops import get_op
    monkeypatch.setattr(get_op("BatchNorm"), "fn", _wrong_batch_norm(kind))
    with pytest.raises(chip_smoke.SmokeFailure,
                       match="moving statistics of .* off by"):
        run = chip_smoke.train_resnet(torch, np, {}, 0, 1, "resnet f32")
        chip_smoke.check_resnet(np, "resnet f32", run,
                                chip_smoke.RESNET_F32_CE_TOL,
                                chip_smoke.RESNET_F32_STATS_RTOL,
                                chip_smoke.PEAK_FP32_FLOPS, "f32")


def test_resnet_phase_ends_on_an_attention_launch(small_resnet):
    run = chip_smoke.train_resnet(torch, np, {}, 0, 1, "resnet f32")
    run["launches"] = {"flash_attention_fwd": {"f32": 1, "bf16": 0}}
    with pytest.raises(chip_smoke.SmokeFailure, match="flash-attention"):
        chip_smoke.check_resnet(np, "resnet f32", run,
                                chip_smoke.RESNET_F32_CE_TOL,
                                chip_smoke.RESNET_F32_STATS_RTOL,
                                chip_smoke.PEAK_FP32_FLOPS, "f32")


@pytest.fixture
def small_gluon(small_resnet, monkeypatch):
    """chip_smoke's Gluon phase on the CPU: resnet18_v1 at the small
    ResNet's size, the tape check of the attention kernels at B 1, H 2,
    S 64, D 32 through the counting stand-ins (``_dispatch`` says every
    tensor is on the card), Conv2DTranspose at 2 x 16 -> 8 x 4 x 4."""
    for name, value in (("GLUON_TIMED", 2),
                        ("TAPE_ATTENTION_SHAPE", (1, 2, 64, 32)),
                        ("DECONV_SHAPE", (2, 16, 8, 4))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    return small_resnet


def test_gluon_phase_rehearsal_on_cpu(small_gluon):
    """gluon_phase on the CPU: the tape drives the three attention
    stand-ins once each per dtype and matches the plain versions, the
    Conv2DTranspose matches its plain form, and resnet18_v1 trains in
    amp bf16 and f32 with its step-1 loss, running statistics, eager
    step and timing lines."""
    lines = small_gluon
    chip_smoke.gluon_phase(torch, np)
    for dtype in ("bf16", "f32"):
        assert any(ln.startswith("tape attention %s: B 1 H 2" % dtype)
                   for ln in lines)
    assert any(ln.startswith("deconvolution d weight") for ln in lines)
    for what in ("gluon: ", "gluon f32: "):
        for head in ("step-1 cross-entropy", "step-1 moving statistics of "
                     "20 BatchNorms", "the same net un-hybridized",
                     "loss per step"):
            assert any(ln.startswith(what + head) for ln in lines), head
    assert any(ln.startswith("gluon f32: from the initial parameters")
               for ln in lines)


def test_tape_check_ends_on_a_missing_launch(small_gluon, monkeypatch):
    def uncounted(*args):
        return _plain_dq(*args)
    uncounted.launches = {"f32": 0, "bf16": 0}
    monkeypatch.setattr(fa, "flash_attention_bwd_dq", uncounted)
    with pytest.raises(chip_smoke.SmokeFailure, match="launches rose"):
        chip_smoke.tape_attention_check(torch, np)


def test_gluon_phase_ends_on_a_differing_eager_step(small_gluon):
    run = chip_smoke.train_gluon(torch, np, {}, 0, 1, "gluon f32", True)
    chip_smoke.check_gluon(np, "gluon f32", run,
                           chip_smoke.RESNET_F32_CE_TOL,
                           chip_smoke.RESNET_F32_STATS_RTOL,
                           chip_smoke.PEAK_FP32_FLOPS, "f32")
    run["eager"]["worst"] = 2e-5
    with pytest.raises(chip_smoke.SmokeFailure, match="eager step differs"):
        chip_smoke.check_gluon(np, "gluon f32", run,
                               chip_smoke.RESNET_F32_CE_TOL,
                               chip_smoke.RESNET_F32_STATS_RTOL,
                               chip_smoke.PEAK_FP32_FLOPS, "f32")
