"""Time the compiled optimizer update against the eager one.

Builds the parameter set of a model (the zoo transformer LM at a given
width and depth, or ResNet-50 v1's), draws weights and gradients on the
device from a seed, and runs one optimizer over them two ways:

* the compiled update (``_fused.FusedUpdater``, the program
  ``Trainer.step``, ``Module.update`` and ``Module._fit_step`` run): the
  first call's seconds (its compile, ``compile_s``), then the median
  of ``--windows`` windows of ``--calls`` calls between CUDA events
  (host clock on the CPU);
* the eager grouped update (``Updater.update_multi``, ``torch._foreach_*``)
  timed alike.

``--backend`` replaces the route's backend (inductor on the card,
``aot_eager`` on the CPU) for this process, to price another one.

Usage::

    python -m mxnet_tpu_torch.tools.update_bench [--device cuda|cpu]
        [--model lm|resnet50] [--optimizer adam|sgd] [--layers N]
        [--d-model D] [--d-ff F] [--vocab V] [--backend NAME]

Prints one JSON line. The run uses the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Tuple


def lm_shapes(layers: int, d: int, d_ff: int, vocab: int) -> List[tuple]:
    """The zoo LM's trained parameter shapes (embedding, per layer two
    LayerNorms, the fused QKV and output projections, the two FFN
    layers, the final LayerNorm and the head)."""
    shapes = [(vocab, d)]
    for _ in range(layers):
        shapes += [(d,), (d,), (3 * d, d), (3 * d,), (d, d), (d,), (d,),
                   (d,), (d_ff, d), (d_ff,), (d, d_ff), (d,)]
    return shapes + [(d,), (d,), (vocab, d), (vocab,)]


def resnet50_v1_shapes() -> List[tuple]:
    """ResNet-50 v1's trained parameter shapes (convolution weights,
    BatchNorm gammas and betas, the classifier)."""
    shapes = [(64, 3, 7, 7), (64,), (64,)]
    cin = 64
    for n, c in ((3, 64), (4, 128), (6, 256), (3, 512)):
        for i in range(n):
            shapes += [(c, cin, 1, 1), (c,), (c,), (c, c, 3, 3), (c,), (c,),
                       (4 * c, c, 1, 1), (4 * c,), (4 * c,)]
            if i == 0:
                shapes += [(4 * c, cin, 1, 1), (4 * c,), (4 * c,)]
            cin = 4 * c
    return shapes + [(1000, 2048), (1000,)]


def run(device: str, shapes: List[tuple], optimizer: str, windows: int,
        calls: int, seed: int = 0) -> dict:
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import _fused, optimizer as opt
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(s, scale):
        return torch.randn(s, generator=gen, device=dev) * scale

    params = {"adam": {"learning_rate": 1e-4, "wd": 1e-4},
              "sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}}
    o = opt.create(optimizer, rescale_grad=1.0 / 8, **params[optimizer])
    fused_upd, eager_upd = opt.get_updater(o), opt.get_updater(o)
    fused = _fused.FusedUpdater(fused_upd)
    idxs = list(range(len(shapes)))
    ws = [mt.nd.NDArray(draw(s, 0.02)) for s in shapes]
    eager_ws = [mt.nd.NDArray(w.data.clone()) for w in ws]
    gs = [draw(s, 1.0) for s in shapes]
    items = [(i, w, g) for i, w, g in zip(idxs, ws, gs)]
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / calls
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3 / calls

    def compiled():
        if not fused(items):
            raise RuntimeError("the compiled update declined the step")

    def eager():
        eager_upd.update_multi(idxs, eager_ws, gs)

    sync()
    with mt.profiler.counter_delta() as d:
        t0 = time.perf_counter()
        compiled()
        sync()
        compile_s = time.perf_counter() - t0
        eager()
        sync()
        comp, eag = [], []
        for _ in range(windows):
            comp.append(timed(compiled))
            eag.append(timed(eager))
    return {
        "device": str(dev), "optimizer": optimizer,
        "backend": _fused._GPU_BACKEND if cuda else _fused.CPU_BACKEND,
        "tensors": len(shapes),
        "values": sum(w.data.numel() for w in ws),
        "compile_s": compile_s,
        "compiled_ms": statistics.median(comp),
        "eager_ms": statistics.median(eag),
        "compiled_windows_ms": comp, "eager_windows_ms": eag,
        "counters": {k: d.get(k) for k in (
            "trainer_step_compile", "trainer_step_cache_hit",
            "trainer_step_recompile", "trainer_step_fallback")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", default="lm", choices=("lm", "resnet50"))
    ap.add_argument("--optimizer", default="adam", choices=("adam", "sgd"))
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--d-ff", type=int, default=8192)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--backend", default=None,
                    help="the compiled route's backend for this run")
    args = ap.parse_args(argv)
    import torch
    from mxnet_tpu_torch import _fused
    if args.device == "cuda" and not torch.cuda.is_available():
        print("update_bench: no CUDA device (pass --device cpu for the "
              "host)", file=sys.stderr)
        return 2
    if args.device == "cpu":
        torch.set_num_threads(min(torch.get_num_threads(), 4))
    if args.backend:
        _fused.CPU_BACKEND = _fused._GPU_BACKEND = args.backend
    shapes: List[Tuple[int, ...]] = (
        lm_shapes(args.layers, args.d_model, args.d_ff, args.vocab)
        if args.model == "lm" else resnet50_v1_shapes())
    print(json.dumps(run(args.device, shapes, args.optimizer, args.windows,
                         args.calls)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
