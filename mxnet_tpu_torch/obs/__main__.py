"""``python -m mxnet_tpu_torch.obs`` — offline observability tooling.

The port's copy of the reference package's ``obs/__main__.py`` (stdlib
only): the same file names, verdict and merged timeline, so either
package's command reads the other's recorder files.

``blackbox <dir>`` merges every rank's flight-recorder file
(``blackbox-p<rank>[-coord].jsonl``, written by :mod:`.blackbox`) plus
any per-rank chrome traces (``profile-p<rank>.json``) into ONE
rank-laned, clock-aligned chrome-trace timeline
(``<dir>/pod-timeline.json``; load it in Perfetto), and prints the
post-mortem verdict:

* which rank stopped first (no clean-exit flush, earliest last event),
* that rank's last recorded event and the fault spec armed on it,
* each survivor's view of the death (its pod-transition events —
  dead-host detection, adjudication, election, fail-over, drain),
* every fail-over transition across the pod, clock-ordered.

Clock alignment: each recorder header carries the host's wall anchor
and its ``clock_offset_s`` vs the control-plane host (estimated from
the PodKV clock exchange at rendezvous), so
``aligned = wall - clock_offset_s`` puts every rank on the leader's
timebase; chrome traces align through the ``trace0_wall`` anchor the
recorder stamps (the wall time of profiler tick 0).

The verdict is also emitted machine-readably as one
``POD-BLACKBOX-VERDICT {json}`` line.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional

_FILE_RE = re.compile(r"^blackbox-p(\d+)(-coord)?\.jsonl$")
_TRACE_RE = re.compile(r"^profile-p(\d+)\.json$")

# lanes for recorder events in the merged trace (chrome tids; the
# per-rank chrome traces keep their own registered lane ids, which the
# profiler allocates from 1 upward — far from this range)
_TID_CHILD = 990
_TID_COORD = 991


def _load_recorder_files(directory: str) -> List[Dict[str, Any]]:
    out = []
    for path in sorted(glob.glob(os.path.join(directory,
                                              "blackbox-p*.jsonl"))):
        m = _FILE_RE.match(os.path.basename(path))
        if not m:
            continue
        try:
            with open(path) as f:
                lines = [ln for ln in f.read().splitlines() if ln.strip()]
        except OSError:
            continue
        if not lines:
            continue
        try:
            header = json.loads(lines[0])
        except ValueError:
            continue
        events = []
        for ln in lines[1:]:
            try:
                events.append(json.loads(ln))
            except ValueError:
                continue    # lenient: a foreign tool may have torn a line
        off = float(header.get("clock_offset_s") or 0.0)
        for ev in events:
            ev["aligned"] = float(ev.get("t", 0.0)) - off
        out.append({"path": path, "rank": int(m.group(1)),
                    "role": "coord" if m.group(2) else "child",
                    "header": header, "events": events,
                    "offset": off})
    return out


def _rank_summary(files: List[Dict[str, Any]]) -> Dict[int, Dict[str, Any]]:
    ranks: Dict[int, Dict[str, Any]] = {}
    for rec in files:
        r = rec["rank"]
        info = ranks.setdefault(r, {"files": [], "clean": False,
                                    "crashed": False, "last": None,
                                    "armed": [], "fault": None})
        info["files"].append(rec)
        reason = rec["header"].get("flush_reason")
        if reason == "exit":
            info["clean"] = True
        info["armed"] = sorted(set(info["armed"])
                               | set(rec["header"].get("faults_armed")
                                     or []))
        for ev in rec["events"]:
            if info["last"] is None or ev["aligned"] > \
                    info["last"]["aligned"]:
                info["last"] = ev
            if ev.get("kind") == "crash":
                info["crashed"] = True
            if ev.get("kind") == "fault":
                if info["fault"] is None or ev["aligned"] >= \
                        info["fault"]["aligned"]:
                    info["fault"] = ev
    return ranks


def _verdict(ranks: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    dead = sorted(r for r, info in ranks.items()
                  if not info["clean"] or info["crashed"])
    survivors = sorted(r for r in ranks if r not in dead)
    first_dead = None
    if dead:
        first_dead = min(
            dead, key=lambda r: ranks[r]["last"]["aligned"]
            if ranks[r]["last"] else float("inf"))
    out: Dict[str, Any] = {"ranks": sorted(ranks),
                           "dead": dead, "survivors": survivors,
                           "first_dead": first_dead}
    if first_dead is not None:
        info = ranks[first_dead]
        last = info["last"]
        out["last_event"] = None if last is None else {
            "t": last["aligned"], "kind": last.get("kind"),
            "name": last.get("name"), "data": last.get("data")}
        out["armed_faults"] = info["armed"]
        fault = info["fault"]
        out["last_fault"] = None if fault is None else {
            "t": fault["aligned"], "site": fault.get("name"),
            "data": fault.get("data")}
    views: Dict[str, List[Dict[str, Any]]] = {}
    failovers: List[Dict[str, Any]] = []
    for r, info in sorted(ranks.items()):
        view = []
        for rec in info["files"]:
            for ev in rec["events"]:
                if ev.get("kind") != "pod":
                    continue
                name = ev.get("name")
                if name in ("dead-hosts", "adjudicate", "drain",
                            "failover", "stall", "coordsvc-kill",
                            "child-exit"):
                    view.append({"t": ev["aligned"], "name": name,
                                 "data": ev.get("data")})
                if name == "failover":
                    failovers.append({"rank": r, "t": ev["aligned"],
                                      "data": ev.get("data")})
        if view and r in survivors:
            views[str(r)] = sorted(view, key=lambda e: e["t"])[:20]
    out["survivor_views"] = views
    out["failovers"] = sorted(failovers, key=lambda e: e["t"])
    return out


def _merged_trace(directory: str, files: List[Dict[str, Any]]
                  ) -> Dict[str, Any]:
    """One chrome trace: pid = pod rank, recorder events on dedicated
    lanes, per-rank chrome traces re-based onto the aligned clock."""
    aligned_min = None
    for rec in files:
        for ev in rec["events"]:
            if aligned_min is None or ev["aligned"] < aligned_min:
                aligned_min = ev["aligned"]
    if aligned_min is None:
        aligned_min = 0.0
    events: List[Dict[str, Any]] = []
    seen_pids = set()
    for rec in files:
        pid = rec["rank"]
        tid = _TID_COORD if rec["role"] == "coord" else _TID_CHILD
        if pid not in seen_pids:
            seen_pids.add(pid)
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": "rank %d" % pid}})
            events.append({"name": "process_sort_index", "ph": "M",
                           "pid": pid, "args": {"sort_index": pid}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid,
                       "args": {"name": "blackbox/%s" % rec["role"]}})
        for ev in rec["events"]:
            ts = (ev["aligned"] - aligned_min) * 1e6
            name = "%s:%s" % (ev.get("kind"), ev.get("name")) \
                if ev.get("name") else str(ev.get("kind"))
            base = {"name": name, "cat": str(ev.get("kind")),
                    "pid": pid, "tid": tid, "ts": round(ts, 1)}
            if ev.get("data") is not None:
                base["args"] = {"data": ev["data"]}
            dur = (ev.get("dur_ms") if ev.get("kind") == "span"
                   else None)
            if dur:
                base.update({"ph": "X", "dur": round(dur * 1e3, 1),
                             "ts": round(ts - dur * 1e3, 1)})
            else:
                base.update({"ph": "i", "s": "t"})
            events.append(base)
        # this rank's chrome trace, shifted onto the aligned clock
        header = rec["header"]
        trace0 = header.get("trace0_wall")
        if trace0 is None or rec["role"] == "coord":
            continue
        tpath = os.path.join(directory, "profile-p%d.json" % pid)
        if not os.path.exists(tpath) and len(files) == 1:
            tpath = os.path.join(directory, "profile.json")
        if not os.path.exists(tpath):
            continue
        try:
            with open(tpath) as f:
                trace = json.load(f)
        except (OSError, ValueError):
            continue
        shift = (float(trace0) - rec["offset"] - aligned_min) * 1e6
        for tev in trace.get("traceEvents", []):
            tev = dict(tev)
            tev["pid"] = pid
            if "ts" in tev:
                tev["ts"] = round(float(tev["ts"]) + shift, 1)
            events.append(tev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def cmd_blackbox(directory: str, out: Optional[str] = None) -> int:
    files = _load_recorder_files(directory)
    if not files:
        print("no blackbox-p*.jsonl recorder files under %s" % directory)
        return 2
    ranks = _rank_summary(files)
    verdict = _verdict(ranks)
    merged = _merged_trace(directory, files)
    out = out or os.path.join(directory, "pod-timeline.json")
    with open(out, "w") as f:
        json.dump(merged, f)
    # ------------------------------------------------- human-readable
    print("pod flight-recorder post-mortem over %d file(s), %d rank(s)"
          % (len(files), len(ranks)))
    for r in sorted(ranks):
        info = ranks[r]
        state = "clean exit" if r in verdict["survivors"] else "DEAD"
        last = info["last"]
        print("  rank %d: %s; last event %s"
              % (r, state,
                 "%s:%s @ %.3f" % (last.get("kind"), last.get("name"),
                                   last["aligned"])
                 if last else "<none>"))
    if verdict["first_dead"] is not None:
        fd = verdict["first_dead"]
        print("first dead: rank %d" % fd)
        if verdict.get("last_fault"):
            lf = verdict["last_fault"]
            print("  armed fault spec(s): %s; last fault fired: %s @ "
                  "%.3f" % (", ".join(verdict.get("armed_faults") or
                                      ["<none>"]),
                            lf["site"], lf["t"]))
        for r, view in sorted(verdict["survivor_views"].items()):
            print("  rank %s saw: %s" % (r, ", ".join(
                "%s@%.3f" % (e["name"], e["t"]) for e in view[:6])))
    else:
        print("every rank exited cleanly — nothing to blame")
    for fo in verdict["failovers"]:
        print("fail-over: rank %d re-pointed at %s @ %.3f"
              % (fo["rank"], (fo.get("data") or {}).get("addr", "?"),
                 fo["t"]))
    print("merged timeline: %s (%d events)"
          % (out, len(merged["traceEvents"])))
    print("POD-BLACKBOX-VERDICT %s" % json.dumps(verdict, sort_keys=True))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.obs",
        description="observability tooling (flight-recorder post-mortem)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    bb = sub.add_parser("blackbox",
                        help="merge flight-recorder files into one "
                             "clock-aligned timeline + verdict")
    bb.add_argument("dir", help="directory holding blackbox-p*.jsonl")
    bb.add_argument("--out", default=None,
                    help="merged chrome-trace path "
                         "(default <dir>/pod-timeline.json)")
    args = parser.parse_args(argv)
    if args.cmd == "blackbox":
        return cmd_blackbox(args.dir, args.out)
    parser.error("unknown command")
    return 2


if __name__ == "__main__":
    sys.exit(main())
