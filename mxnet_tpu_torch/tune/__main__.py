"""CLI: ``python -m mxnet_tpu_torch.tune``.

Two modes:

* ``--probe spec.json`` — INTERNAL: the probe child. Runs one candidate
  in this process and prints its score as the last JSON line (the
  parent in :mod:`.probe` parses exactly that). Not for humans.
* ``--net <zoo name> | --symbol file.json`` — the user-facing search:
  tune a model against a budget and print the winner + audit trail.

The search's probes and its static model run on the card unless
``--cpu`` asks for the host.

Examples::

    python -m mxnet_tpu_torch.tune --net mlp --budget 16G
    python -m mxnet_tpu_torch.tune --net transformer --steps 8 \\
        --max-probes 4
    python -m mxnet_tpu_torch.tune --symbol net.json --shape data=32,784 \\
        --shape softmax_label=32 --optimizer adam
"""
from __future__ import annotations

import argparse
import json
import sys


def _cmd_probe(path: str) -> int:
    with open(path) as f:
        spec = json.load(f)
    from .probe import run_probe_child
    try:
        score = run_probe_child(spec)
    except Exception as exc:   # scored failure, not a traceback dump
        score = {"ok": False, "why": "%s: %s"
                 % (type(exc).__name__, exc)}
    sys.stdout.flush()
    print(json.dumps(score))
    return 0 if score.get("ok") else 3


def _zoo(name: str, batch: int):
    """Probe-scale zoo builds: (symbol, data_shapes, label_shapes,
    data_dtypes)."""
    from ..analysis.__main__ import _zoo_symbol
    sym, shapes = _zoo_symbol(name)
    data_shapes, label_shapes = [], []
    for n, s in shapes.items():
        s = (batch,) + tuple(s[1:])
        (label_shapes if "label" in n else data_shapes).append((n, s))
    dtypes = {"data": "int32"} if name == "transformer" else {}
    return sym, data_shapes, label_shapes, dtypes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tune",
        description="search the training-config space for a model")
    p.add_argument("--probe", metavar="SPEC",
                   help=argparse.SUPPRESS)   # internal child mode
    p.add_argument("--net", help="zoo model (mlp, resnet8, transformer)")
    p.add_argument("--symbol", help="symbol JSON file")
    p.add_argument("--shape", action="append", default=[],
                   metavar="name=d0,d1,...",
                   help="input shape (repeatable; required with "
                        "--symbol, overrides zoo defaults)")
    p.add_argument("--batch", type=int, default=32,
                   help="batch size for zoo nets (default 32)")
    p.add_argument("--budget", default=None,
                   help="HBM budget, e.g. 16G (default: unbudgeted)")
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--mode", choices=("auto", "static"), default="auto",
                   help="static = model-only, no probe subprocesses")
    p.add_argument("--steps", type=int, default=None,
                   help="measured steps per probe "
                        "(default MXNET_TPU_TUNE_PROBE_STEPS)")
    p.add_argument("--max-probes", type=int, default=None,
                   help="probe budget (default MXNET_TPU_TUNE_MAX_PROBES)")
    p.add_argument("--deadline", type=float, default=None,
                   help="per-probe deadline seconds "
                        "(default MXNET_TPU_TUNE_PROBE_SECS)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-store", action="store_true",
                   help="do not read/write the persisted config store")
    p.add_argument("--json", action="store_true",
                   help="print the full TunedConfig record as JSON")
    p.add_argument("--cpu", action="store_true",
                   help="probe and calibrate on the host, not the card")
    args = p.parse_args(argv)

    if args.probe:
        return _cmd_probe(args.probe)

    if not args.net and not args.symbol:
        p.error("one of --net / --symbol is required")

    from ..analysis.__main__ import _parse_shapes
    dtypes = {}
    if args.net:
        if args.net not in ("mlp", "transformer") and \
                not args.net.startswith("resnet"):
            p.error("--net: mlp, resnet<N> (resnet8, resnet20) or "
                    "transformer")
        sym, data_shapes, label_shapes, dtypes = _zoo(args.net,
                                                      args.batch)
        over = _parse_shapes(args.shape)
        data_shapes = [(n, over.get(n, s)) for n, s in data_shapes]
        label_shapes = [(n, over.get(n, s)) for n, s in label_shapes]
    else:
        from ..symbol import load
        sym = load(args.symbol)
        shapes = _parse_shapes(args.shape)
        if not shapes:
            p.error("--symbol requires at least one --shape")
        data_shapes = [(n, s) for n, s in shapes.items()
                       if "label" not in n]
        label_shapes = [(n, s) for n, s in shapes.items()
                        if "label" in n]

    from .search import search
    cfg = search(sym, data_shapes, label_shapes,
                 optimizer=args.optimizer, budget=args.budget,
                 mode=args.mode, probe_steps=args.steps,
                 probe_deadline_s=args.deadline,
                 max_probes=args.max_probes, seed=args.seed,
                 data_dtypes=dtypes, use_store=not args.no_store,
                 log=lambda m: print(m, file=sys.stderr),
                 device="cpu" if args.cpu else None)

    if args.json:
        print(json.dumps(cfg.to_dict(), indent=1, sort_keys=True))
    else:
        print("winner (%s): %s" % (cfg.source, cfg.candidate.to_dict()))
        if cfg.score:
            print("score: mfu=%s steps/s=%s"
                  % (cfg.score.get("mfu"),
                     cfg.score.get("steps_per_sec")))
        if cfg.baseline and cfg.score:
            b, w = cfg.baseline, cfg.score
            if b.get("steps_per_sec"):
                print("vs default: %.2fx steps/s"
                      % (float(w.get("steps_per_sec") or 0)
                         / float(b["steps_per_sec"])))
        print("searched %.1fs, %d probed, %d pruned statically"
              % (cfg.searched_s, cfg.n_probed, cfg.n_pruned))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
