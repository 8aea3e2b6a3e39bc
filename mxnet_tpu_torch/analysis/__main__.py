"""``python -m mxnet_tpu_torch.analysis`` — the analyzer CLI.

The port of the reference's ``analysis/__main__.py``. Subcommands:

* ``graph <symbol.json | zoo:name>`` — run the graph passes over a saved
  symbol JSON or a model-zoo net (``zoo:resnet8``, ``zoo:mlp``,
  ``zoo:transformer``), with ``--shape name=1,3,224,224`` bindings.
* ``lint <paths...>`` — the AST concurrency/perf lint; ``--baseline``
  fails on drift in either direction (new findings AND stale
  suppressions), ``--write-baseline <file>`` regenerates an arbitrary
  baseline, ``--update-baseline`` regenerates the checked-in baseline
  (``mxnet_tpu_torch/tools/analysis_baseline.json`` over
  ``mxnet_tpu_torch``).
* ``audit [targets...]`` — the efficiency auditor: memory/remat report
  + roofline classification per zoo net, its forward run once on the
  card (``--cpu``: on the host). Default targets: ``mlp resnet8
  transformer``. The reference's mesh targets (``tp-mesh``,
  ``islands``) audit sharded programs, which are ROADMAP A9: they exit
  2 naming it.
* ``self-check`` — the CI gate: model-zoo nets must analyze with zero
  ERROR-level findings, and a small async ``fit()`` on the card
  (``--cpu``: on the host) must show a clean pipeline.

Exit status: 0 clean, 1 findings at/above the failure threshold
(``--fail-on``, default ERROR for ``graph``/``audit``; any baseline
drift for ``lint``), 2 usage errors.
"""
from __future__ import annotations

import argparse
import os
import sys

from .findings import Severity

__all__ = ["main"]

# the reference's audit targets that need a device mesh
_MESH_TARGETS = ("tp-mesh", "islands")


def _parse_shapes(specs):
    shapes = {}
    for spec in specs or ():
        if "=" not in spec:
            raise SystemExit("--shape expects name=d0,d1,... got %r" % spec)
        name, dims = spec.split("=", 1)
        shapes[name] = tuple(int(d) for d in dims.split(",") if d)
    return shapes


def _zoo_symbol(name: str):
    """Small-config model-zoo builds: fast to analyze, same op surface as
    the production sizes."""
    from .. import models
    from ..models import transformer as _transformer
    if name.startswith("resnet"):
        layers = int(name[len("resnet"):] or 8)
        return (models.get_resnet(num_classes=10, num_layers=layers,
                                  image_shape="3,32,32"),
                {"data": (2, 3, 32, 32), "softmax_label": (2,)})
    if name == "mlp":
        from ..models import mlp
        return (mlp.get_symbol(num_classes=10),
                {"data": (2, 784), "softmax_label": (2,)})
    if name == "transformer":
        return (_transformer.get_symbol(vocab_size=128, num_layers=2,
                                        d_model=32, n_heads=2, seq_len=16),
                {"data": (2, 16), "softmax_label": (2, 16)})
    raise SystemExit("unknown zoo model %r (try resnet8, resnet20, mlp, "
                     "transformer)" % name)


def _context(args):
    """The device an audit or self-check runs on: the card unless
    ``--cpu`` asks for the host."""
    from ..context import cpu, gpu
    return cpu() if args.cpu else gpu(0)


def _cmd_graph(args) -> int:
    from . import analyze_symbol
    if args.target.startswith("zoo:"):
        sym, shapes = _zoo_symbol(args.target[4:])
        shapes.update(_parse_shapes(args.shape))
    else:
        from ..symbol import load
        sym = load(args.target)
        shapes = _parse_shapes(args.shape)
    report = analyze_symbol(sym, input_shapes=shapes or None,
                            context=args.target, calibrate_remat=False)
    print(report.format(min_severity=Severity[args.min_severity]))
    fail_at = Severity[args.fail_on]
    return 1 if report.at_least(fail_at) else 0


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def baseline_path() -> str:
    """The port's checked-in lint baseline."""
    return os.path.join(_repo_root(), "mxnet_tpu_torch", "tools",
                        "analysis_baseline.json")


def _cmd_lint(args) -> int:
    from . import (diff_baseline, lint_paths, load_baseline,
                   stale_baseline, write_baseline)
    if args.update_baseline:
        # regenerate the CHECKED-IN baseline with its canonical paths
        # and root, so "fix the drift" is one copy-pasteable command
        root = _repo_root()
        report = lint_paths([os.path.join(root, "mxnet_tpu_torch")])
        target = baseline_path()
        n_keys = write_baseline(report, target, root)
        print("updated %s: %d finding key(s) (%d finding(s))"
              % (target, n_keys, len(report)))
        return 0
    if not args.paths:
        # usage error -> 2, per the module contract (SystemExit with a
        # string message would exit 1 — indistinguishable from drift)
        print("lint needs paths (or --update-baseline)", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    report = lint_paths(args.paths)
    if args.write_baseline:
        n_keys = write_baseline(report, args.write_baseline, root)
        print("wrote %d finding key(s) (%d finding(s)) to %s"
              % (n_keys, len(report), args.write_baseline))
        return 0
    if args.baseline:
        baseline = load_baseline(args.baseline)
        fresh = diff_baseline(report, baseline, root)
        stale = stale_baseline(report, baseline, root)
        known = len(report) - len(fresh)
        if not fresh and not stale:
            print("lint: no baseline drift (%d baselined)" % known)
            return 0
        if fresh:
            print("lint: %d NEW finding(s) (%d baselined):"
                  % (len(fresh), known))
            for f in fresh:
                print(f.format())
        if stale:
            print("lint: %d STALE baseline suppression(s) — the debt "
                  "was paid off; run `python -m mxnet_tpu_torch.analysis "
                  "lint --update-baseline` so the next real finding at "
                  "these keys is not masked:" % len(stale))
            for k, excess in stale.items():
                print("  %s (x%d)" % (k, excess))
        return 1
    print(report.format())
    return 1 if report.findings else 0


# ------------------------------------------------------------------ audit


def _audit_zoo_net(name: str, fail_at, ctx) -> int:
    """Memory/remat + roofline audit of one zoo net; returns 1 on
    findings at/above ``fail_at``."""
    from . import analyze_symbol, roofline
    from .findings import Severity as S
    from ..context import resolve_device
    if name.startswith("zoo:"):
        name = name[4:]           # accept the graph subcommand's spelling
    sym, shapes = _zoo_symbol(name)
    dev = resolve_device(ctx)
    # audits always calibrate the remat prediction (one block forward +
    # backward on zeros) — this is the offline path where that cost
    # belongs
    report = analyze_symbol(sym, input_shapes=shapes, context=name,
                            calibrate_remat=True, device=dev)
    cost = report.extras.get("cost", {})
    remat = report.extras.get("remat", {})
    print("== %s: %.3g GFLOP, est peak %.3g MB (%.3g MB activations)"
          % (name, cost.get("flops", 0) / 1e9,
             cost.get("peak_bytes", 0) / 1e6,
             cost.get("activation_peak_bytes", 0) / 1e6))
    sug = remat.get("suggestion")
    if sug:
        cands = remat.get("candidates", [])
        print("   remat: %d candidate(s), ~%.3g MB recoverable; top: %s"
              % (len(cands), sug["est_bytes_saved"] / 1e6,
                 ", ".join("%s(%s, %.3g MB)"
                           % (c["node"], c["op"], c["bytes"] / 1e6)
                           for c in cands[:3])))
        print("   suggestion: %s" % sug["hint"])
    else:
        print("   remat: no candidates")
    # roofline: run the bound forward once under the counting mode and
    # reconcile with the model
    try:
        import torch
        ex = sym.simple_bind(ctx, grad_req="null", **shapes)
        args = {n: a.data for n, a in ex.arg_dict.items()}
        aux = {n: a.data for n, a in ex.aux_dict.items()}
        with torch.no_grad():
            roofline.analyze_executable(
                lambda a, x: ex._fn(a, x, False, dev)[0], args, aux,
                model_flops=float(cost.get("flops") or 0) or None,
                context=name, report=report)
        roof = report.extras.get("roofline", {})
        cls = ("%s-bound, attainable MFU %.2f (%s)"
               % (roof["bound"], roof["attainable_mfu"],
                  _device_name(dev))
               if "bound" in roof else "roofline unknown for %s "
               "(set MXNET_TPU_OBS_PEAK_FLOPS/MXNET_TPU_ANALYZE_HBM_GBPS)"
               % _device_name(dev))
        print("   roofline: counted %.3g GFLOP vs model %.3g GFLOP "
              "(ratio %s); %s"
              % (roof.get("compiled_flops", 0) / 1e9,
                 cost.get("flops", 0) / 1e9,
                 roof.get("model_ratio", "n/a"), cls))
    except Exception as exc:                                # noqa: BLE001
        print("   roofline: unavailable (%s: %s)"
              % (type(exc).__name__,
                 (str(exc).splitlines() or [""])[0][:100]))
    for f in report.at_least(S.WARNING):
        print("   " + f.format())
    return 1 if report.at_least(fail_at) else 0


def _device_name(dev) -> str:
    if dev.type == "cuda":
        import torch
        return torch.cuda.get_device_name(dev)
    return "the host CPU"


def _cmd_audit(args) -> int:
    fail_at = Severity[args.fail_on]
    targets = args.targets or ["mlp", "resnet8", "transformer"]
    mesh = [t for t in targets if t in _MESH_TARGETS]
    if mesh:
        print("audit targets %s audit sharded programs across a device "
              "mesh: that is ROADMAP.md queue A9 (parallelism)" % mesh,
              file=sys.stderr)
        return 2
    ctx = _context(args)
    failed = 0
    for t in targets:
        try:
            failed += _audit_zoo_net(t, fail_at, ctx)
        except SystemExit as exc:
            # a mistyped target is a USAGE error (exit 2), not an
            # audit failure (exit 1) — CI keys on the distinction
            print(exc, file=sys.stderr)
            return 2
    return 1 if failed else 0


def _cmd_self_check(args) -> int:
    """Model-zoo nets must produce zero ERROR-level graph findings — the
    analyzer's own regression gate (a pass that starts mis-firing on
    known-good nets fails CI here, not in user binds) — plus the
    async-loop counter gate: a small async ``fit()`` must do ZERO
    per-batch host syncs and ZERO steady-state recompiles (the loop_*
    profiler counters the fit pipeline reports)."""
    from . import analyze_symbol
    failed = 0
    for name in ("resnet8", "mlp", "transformer"):
        sym, shapes = _zoo_symbol(name)
        report = analyze_symbol(sym, input_shapes=shapes, context=name,
                                calibrate_remat=False)
        errs = report.errors
        status = "FAIL (%d errors)" % len(errs) if errs else "ok"
        cost = report.extras.get("cost", {})
        print("%-12s %-18s %.3g GFLOP, est peak %.3g MB"
              % (name, status, cost.get("flops", 0) / 1e9,
                 cost.get("peak_bytes", 0) / 1e6))
        for f in errs:
            print("  " + f.format())
        failed += bool(errs)
    failed += _async_loop_counter_check(_context(args))
    return 1 if failed else 0


def _async_loop_counter_check(ctx) -> int:
    """One tiny async fit() on ``ctx``; the loop counters must show a
    clean pipeline: 0 per-batch host syncs, 0 steady-state recompiles,
    every batch fed by the device-prefetch stage."""
    import numpy as np
    from .. import config, io, module, profiler, symbol
    from ..initializer import Uniform

    data = symbol.Variable("data")
    fc = symbol.FullyConnected(data, num_hidden=8, name="fc1")
    net = symbol.SoftmaxOutput(fc, name="softmax")
    rng = np.random.RandomState(0)
    it = io.NDArrayIter(rng.uniform(-1, 1, (48, 16)).astype(np.float32),
                        rng.randint(0, 8, (48,)).astype(np.float32),
                        batch_size=8)
    mod = module.Module(net, context=ctx)
    # pin every loop knob: the gate asserts exact counter values, and an
    # ambient MXNET_TPU_DEVICE_PREFETCH=0 (say) would fail the check on
    # healthy code — the check targets the code, not the environment
    knobs = {"MXNET_TPU_ASYNC_WINDOW": 2, "MXNET_TPU_DEVICE_PREFETCH": 2,
             "MXNET_TPU_DEVICE_METRICS": True}
    for k, v in knobs.items():
        config.set(k, v)
    try:
        with profiler.counter_delta() as d:
            mod.fit(it, eval_metric="acc", num_epoch=2, optimizer="sgd",
                    initializer=Uniform(0.01),
                    optimizer_params={"learning_rate": 0.1})
        c = d.all()
    finally:
        for k in knobs:
            config.reset(k)
    checks = (
        ("loop_host_sync", c.get("loop_host_sync", 0), 0),
        ("loop_recompile", c.get("loop_recompile", 0), 0),
        ("loop_prefetch_placed", c.get("loop_prefetch_placed", 0), 12),
    )
    bad = [(k, got, want) for k, got, want in checks if got != want]
    status = "FAIL %s" % bad if bad else "ok"
    print("%-12s %-18s async fit counters on %s: %s"
          % ("async-loop", status, ctx,
             {k: v for k, v in sorted(c.items()) if k.startswith("loop_")}))
    return 1 if bad else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m mxnet_tpu_torch.analysis",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("graph", help="graph passes over a symbol")
    g.add_argument("target", help="symbol JSON path or zoo:<name>")
    g.add_argument("--shape", action="append",
                   help="input shape binding name=d0,d1,... (repeatable)")
    g.add_argument("--min-severity", default="INFO",
                   choices=[s.name for s in Severity])
    g.add_argument("--fail-on", default="ERROR",
                   choices=[s.name for s in Severity])
    g.set_defaults(fn=_cmd_graph)

    l = sub.add_parser("lint", help="AST concurrency/perf lint")
    l.add_argument("paths", nargs="*")
    l.add_argument("--baseline", help="fail on drift vs this baseline "
                                      "JSON (new findings AND stale "
                                      "suppressions)")
    l.add_argument("--write-baseline", help="regenerate the baseline file "
                                            "and exit 0")
    l.add_argument("--update-baseline", action="store_true",
                   help="regenerate the checked-in baseline "
                        "(mxnet_tpu_torch/tools/analysis_baseline.json "
                        "over mxnet_tpu_torch) and exit 0")
    l.add_argument("--root", default=".",
                   help="path findings are keyed relative to (default .)")
    l.set_defaults(fn=_cmd_lint)

    a = sub.add_parser("audit",
                       help="efficiency audit: memory/remat + roofline "
                            "per zoo net")
    a.add_argument("targets", nargs="*",
                   help="zoo:<name> style targets (default: mlp resnet8 "
                        "transformer)")
    a.add_argument("--fail-on", default="ERROR",
                   choices=[s.name for s in Severity])
    a.add_argument("--cpu", action="store_true",
                   help="run on the host instead of the card")
    a.set_defaults(fn=_cmd_audit)

    s = sub.add_parser("self-check",
                       help="model zoo must analyze with zero ERRORs")
    s.add_argument("--cpu", action="store_true",
                   help="run the async fit on the host instead of the "
                        "card")
    s.set_defaults(fn=_cmd_self_check)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
