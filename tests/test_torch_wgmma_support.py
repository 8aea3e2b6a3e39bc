"""The host-side pieces around the port's wgmma + TMA attention kernels,
on the CPU.

The kernels themselves (``fa_fwd_bf16_wgmma``, ``fa_bwd_dkv_bf16_wgmma``
in ``mxnet_tpu_torch/csrc``) run only on the card, where ``chip_smoke.py``
holds them against their plain versions; their plain versions are held
against the reference's Pallas kernels by
``tests/test_torch_flash_attention*.py``. Here: the build report that
``chip_smoke.py`` reads (ptxas registers and spills, SASS opcode counts),
the 16-byte alignment that TMA needs of lse and delta, and a rehearsal of
``chip_smoke.py``'s edge sweep and timing on the CPU, with the kernel
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


def test_edge_sweep_rehearsal_on_cpu(monkeypatch):
    """chip_smoke's edge sweep at small shapes on the CPU, the kernel
    wrappers replaced by plain versions, at a head dim of each route
    (16: mma.sync, 64: wgmma): every case passes its limits, the
    exactly-zero dK cases (S = 1 causal, Sk = 1) included."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SWEEP_HEADS", (1, 2))
    monkeypatch.setattr(chip_smoke, "SWEEP_DIMS", (16, 64))
    monkeypatch.setattr(chip_smoke, "SWEEP_LENGTHS",
                        ((1, 1), (65, 65), (40, 96), (96, 40)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv", _plain_dkv)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    worst = chip_smoke.edge_sweep(torch)
    assert 0 <= worst["fwd"] < 0.05 and 0 <= worst["dkv"] < 0.05
    assert lines[-1].startswith("edge sweep: 32 cases")
    assert sum("zero in exact arithmetic" in ln for ln in lines) == 8


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
