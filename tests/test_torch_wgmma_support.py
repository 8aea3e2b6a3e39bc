"""The host-side pieces around the port's wgmma + TMA attention kernels,
on the CPU.

The kernels themselves (``fa_fwd_bf16_wgmma``, ``fa_bwd_dq_bf16_wgmma``,
``fa_bwd_dkv_bf16_wgmma`` and the float32 forward ``fa_fwd_f32_tf32x3`` in
``mxnet_tpu_torch/csrc``) run only on the card, where ``chip_smoke.py``
holds them against their plain versions; their plain versions are held
against the reference's Pallas kernels by
``tests/test_torch_flash_attention*.py``. Here: the build report that
``chip_smoke.py`` reads (ptxas registers and spills, SASS opcode counts),
the 16-byte alignment that TMA needs of lse and delta, and a rehearsal of
``chip_smoke.py``'s sweeps and timing on the CPU, with the kernel
wrappers replaced by plain versions at small shapes.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch import _build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa

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
    """chip_smoke's f32 sweep of K1 f32 at small shapes on the CPU (the
    wrapper takes the plain version there): every case is logged and
    held to KERNEL_ATOL, and a case that disagrees ends the run."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "F32_SWEEP_HEADS", (1, 2))
    monkeypatch.setattr(chip_smoke, "F32_SWEEP_DIMS", (16, 64))
    monkeypatch.setattr(chip_smoke, "F32_SWEEP_LENGTHS",
                        ((1, 1), (65, 65), (40, 96), (96, 40)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    assert chip_smoke.f32_sweep(torch) == 0.0
    assert lines[-1].startswith("f32 sweep: 32 cases of K1 f32")
    assert sum(ln.startswith("  f32 sweep d=") for ln in lines) == 32

    plain = fa.flash_attention_fwd

    def off(q, k, v, scale, causal):
        o, lse = plain(q, k, v, scale, causal)
        return o + 2e-4, lse
    monkeypatch.setattr(fa, "flash_attention_fwd", off)
    with pytest.raises(chip_smoke.SmokeFailure, match="f32 sweep d=16 bh=1"):
        chip_smoke.f32_sweep(torch)


def test_tf32x3_bound_and_the_fma_bound():
    """At the serving shape (BH 16, S 1024, D 128, causal) the 3xTF32
    bound takes 3 x 4.30 GFLOP at 495 TFLOP/s; the FMA bound, logged
    beside it, 4.30 GFLOP at 67 TFLOP/s."""
    ms, by, flops, nbytes = chip_smoke.tf32x3_bound(16, 1024, 128)
    assert by == "operations"
    assert flops == pytest.approx(4.30e9, rel=1e-3)
    assert ms == pytest.approx(3 * flops / 495e12 * 1e3)
    assert nbytes / 3.35e12 * 1e3 < ms
    fma_ms, fma_by = chip_smoke.flash_bound(16, 1024, 128)
    assert fma_by == "operations" and fma_ms == pytest.approx(0.0642,
                                                              abs=1e-4)
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
        "_f32_tf32x3ILi128ELi2ELi2EEEvPKfS2_S2_PfS3_iifi")


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
            "flash_attention_bwd.cu": _entry(DQ) + _entry(dkv)}
    wg = {"HGMMA": 60, "UTMALDG": 10}
    counts = {"flash_attention_fwd.cu": {FWD: dict(wg, HMMA=0),
                                         TF32: {"HGMMA": 0, "UTMALDG": 0,
                                                "HMMA": 240}},
              "flash_attention_bwd.cu": {DQ: dict(wg), dkv: dict(wg)}}
    return logs, counts


def test_report_covers_the_new_tensor_core_kernels(monkeypatch):
    """The real tables name K2's wgmma kernel (HGMMA and UTMALDG) and
    K1 f32's 3xTF32 kernel (HMMA); a clean build of all four passes and
    is recorded under each kernel's record name."""
    assert chip_smoke.WGMMA_KERNELS["flash_attention_bwd_dq"] == (
        "flash_attention_bwd.cu", "fa_bwd_dq_bf16_wgmma")
    assert chip_smoke.MMA_KERNELS["flash_attention_fwd"] == (
        "flash_attention_fwd.cu", "fa_fwd_f32_tf32x3")
    logs, counts = _tables_ok()
    _fake_tables(monkeypatch, logs, counts)
    chip_smoke.wgmma_report(_build)
    report = chip_smoke.BUILD_REPORT
    assert set(report) == {"flash_attention_fwd_bf16", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "flash_attention_fwd"}
    assert list(report["flash_attention_bwd_dq"]["ptxas"]) == [DQ]
    assert report["flash_attention_fwd"]["ptxas"][TF32]["registers"] == 200


@pytest.mark.parametrize("source, name, opcode, match", [
    ("flash_attention_bwd.cu", DQ, "HGMMA", "HGMMA and UTMALDG"),
    ("flash_attention_bwd.cu", DQ, "UTMALDG", "HGMMA and UTMALDG"),
    ("flash_attention_fwd.cu", TF32, "HMMA", r"HMMA expected"),
], ids=["dq-no-hgmma", "dq-no-utmaldg", "f32-no-hmma"])
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
