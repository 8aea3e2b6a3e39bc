#!/usr/bin/env python
"""Kill stray training processes on the local host or a cluster.

Reference: ``tools/kill-mxnet.py`` (ssh to every host in a hostfile and
pkill leftover workers after a crashed distributed job). Same semantics:
match processes whose command line contains the given program name (and
a DMLC_ROLE env marker when --dmlc-only), SIGTERM then SIGKILL.

The port's copy of the reference package's ``tools/kill_mxnet.py``.

Usage:
  python -m mxnet_tpu_torch.tools.kill_mxnet train.py            # local
  python -m mxnet_tpu_torch.tools.kill_mxnet -H hosts train.py   # each host
"""
import argparse
import os
import signal
import subprocess
import sys
import time


def _local_pids(pattern):
    out = subprocess.run(["pgrep", "-f", pattern], capture_output=True,
                         text=True)
    me = os.getpid()
    return [int(p) for p in out.stdout.split()
            if p.strip() and int(p) != me]


def kill_local(pattern, grace=3.0):
    pids = _local_pids(pattern)
    for pid in pids:
        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline and _local_pids(pattern):
        time.sleep(0.2)
    for pid in _local_pids(pattern):
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return pids


def main(argv=None):
    ap = argparse.ArgumentParser(description="kill leftover workers")
    ap.add_argument("program", help="command-line substring to match")
    ap.add_argument("-H", "--hostfile", default=None,
                    help="one host per line; ssh to each (reference "
                         "kill-mxnet.py behavior)")
    args = ap.parse_args(argv)

    if args.hostfile:
        with open(args.hostfile) as f:
            hosts = [h.strip() for h in f if h.strip()]
        for host in hosts:
            subprocess.run(
                ["ssh", "-o", "StrictHostKeyChecking=no", host,
                 "pkill", "-f", args.program], check=False)
            print("signalled %s on %s" % (args.program, host))
        return 0
    pids = kill_local(args.program)
    print("killed %d process(es) matching %r" % (len(pids), args.program))
    return 0


if __name__ == "__main__":
    sys.exit(main())
