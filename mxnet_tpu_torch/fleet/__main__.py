"""Fleet process entry points (the reference package's
``fleet/__main__.py``).

::

    python -m mxnet_tpu_torch.fleet replica --port P --rank R --model-json S
        One decode replica behind the fleet wire (the gateway's
        supervisor launches these; running one by hand is fine too).

    python -m mxnet_tpu_torch.fleet serve --spec S [--replicas N] [--port P]
                                    [--metrics-port M]
        The gateway: supervises N replicas of the spec'd model, serves
        the client wire on --port (0 = ephemeral, announced on stdout)
        and the federated /metrics on --metrics-port. Implies
        MXNET_TPU_FLEET=1 — invoking the entry point IS the opt-in.

    python -m mxnet_tpu_torch.fleet stats --address HOST:PORT
        One STATS round-trip against a gateway or replica, printed as
        JSON (the operator's curl).
"""
from __future__ import annotations

import json
import signal
import sys
import time


def _parse_address(s: str):
    host, _, port = s.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _run_serve(argv) -> int:
    import argparse
    parser = argparse.ArgumentParser(prog="mxnet_tpu_torch.fleet serve")
    parser.add_argument("--spec", required=True,
                        help="replica model spec (JSON)")
    parser.add_argument("--replicas", type=int, default=None)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--metrics-port", type=int, default=None)
    args = parser.parse_args(argv)
    from .. import config as _config
    _config.set("MXNET_TPU_FLEET", True)    # the entry point IS the opt-in
    from .gateway import Gateway
    gw = Gateway(spec=json.loads(args.spec), replicas=args.replicas,
                 port=args.port, metrics_port=args.metrics_port)
    flags = {"stop": False}

    def _on_sig(_sig, _frm):                # flag-only handler
        flags["stop"] = True

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_sig)
        except (ValueError, OSError):
            pass
    print(json.dumps({"event": "ready", "port": gw.port,
                      "metrics_port": gw.metrics_port,
                      "replicas": len(gw._replicas)}), flush=True)
    while not flags["stop"]:
        time.sleep(0.2)
    gw.close(drain=True, timeout=30.0)
    return 0


def _run_stats(argv) -> int:
    import argparse
    parser = argparse.ArgumentParser(prog="mxnet_tpu_torch.fleet stats")
    parser.add_argument("--address", required=True)
    args = parser.parse_args(argv)
    from . import wire as _wire
    snap = _wire.request_value(_parse_address(args.address), "STATS")
    json.dump(snap, sys.stdout, indent=2, sort_keys=True)
    print()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "replica":
        from .replica import run_replica
        return run_replica(rest)
    if cmd == "serve":
        return _run_serve(rest)
    if cmd == "stats":
        return _run_stats(rest)
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
