#!/usr/bin/env python
"""Parse a training log into a per-epoch table (reference:
tools/parse_log.py — same log grammar: the Speedometer/fit lines
``Epoch[N] Batch [M] Speed: S samples/sec metric=V``,
``Epoch[N] Train-metric=V``, ``Epoch[N] Time cost=T`` and
``Epoch[N] Validation-metric=V``).

The port's copy of the reference package's ``tools/parse_log.py``: the
port's ``fit`` logs the same lines.

Usage: python -m mxnet_tpu_torch.tools.parse_log train.log \
           [--format markdown|csv]
"""
from __future__ import annotations

import argparse
import re
import sys
from collections import defaultdict

RE_BATCH = re.compile(
    r"Epoch\[(\d+)\] Batch \[\d+\]\s+Speed: ([\d.]+) samples/sec")
RE_TRAIN = re.compile(r"Epoch\[(\d+)\] Train-([\w-]+)=([\d.naninf-]+)")
RE_VAL = re.compile(r"Epoch\[(\d+)\] Validation-([\w-]+)=([\d.naninf-]+)")
RE_TIME = re.compile(r"Epoch\[(\d+)\] Time cost=([\d.]+)")


def parse(lines):
    rows = defaultdict(dict)
    speeds = defaultdict(list)
    for line in lines:
        m = RE_BATCH.search(line)
        if m:
            speeds[int(m.group(1))].append(float(m.group(2)))
            continue
        m = RE_TRAIN.search(line)
        if m:
            rows[int(m.group(1))]["train-" + m.group(2)] = float(m.group(3))
            continue
        m = RE_VAL.search(line)
        if m:
            rows[int(m.group(1))]["val-" + m.group(2)] = float(m.group(3))
            continue
        m = RE_TIME.search(line)
        if m:
            rows[int(m.group(1))]["time"] = float(m.group(2))
    for e, ss in speeds.items():
        rows[e]["speed"] = sum(ss) / len(ss)
    return dict(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("logfile")
    ap.add_argument("--format", choices=("markdown", "csv"),
                    default="markdown")
    args = ap.parse_args(argv)
    with open(args.logfile) as f:
        rows = parse(f)
    if not rows:
        print("no epochs found", file=sys.stderr)
        return 1
    cols = ["epoch"] + sorted({k for r in rows.values() for k in r})
    if args.format == "csv":
        print(",".join(cols))
        for e in sorted(rows):
            print(",".join([str(e)] + ["%g" % rows[e].get(c, float("nan"))
                                       for c in cols[1:]]))
    else:
        print("| " + " | ".join(cols) + " |")
        print("|" + "|".join("---" for _ in cols) + "|")
        for e in sorted(rows):
            vals = ["%g" % rows[e][c] if c in rows[e] else ""
                    for c in cols[1:]]
            print("| " + " | ".join([str(e)] + vals) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
