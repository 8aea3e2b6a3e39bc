"""AST-based concurrency/perf lint for the codebase itself.

The port of the reference's ``analysis/lint.py``, with its codes, its
``# mx-lint: allow(...)`` suppressions and its baseline functions. The
serving and executor layers mix Python locks with device work, and the
shapes that cause deadlocks and latency bugs are visible in the AST
without running anything:

* ``lock-host-sync`` (ERROR) — a host sync (``.asnumpy()``,
  ``block_until_ready``, ``future.result()``, and torch's ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``,
  ``Event.synchronize``, ``Stream.synchronize``) while a lock/condition
  is held: every other thread needing that lock now waits on the
  device, and if the synced computation needs the lock-holder
  (callback re-entry) the process deadlocks.
* ``lock-dispatch`` (WARNING) — device dispatch (``torch.*``, and the
  reference's ``jax.*``/``jnp.*`` calls, ``nd.array``) under a lock:
  serializes the card behind a Python mutex and widens every race
  window.
* ``wall-clock`` (WARNING) — ``time.time()`` in latency/throughput math:
  wall clocks jump with NTP; deadlines and p99s must use
  ``time.monotonic()``/``perf_counter()``.
* ``eager-loop-sync`` (WARNING) — a host sync lexically inside the batch
  loop of a training/eval-loop function (``fit``, ``score``, or
  ``*_loop``): one sync per batch serializes the whole pipeline behind
  host round-trips — the regime the async fit loop eliminates. The
  deferred-sync pattern is not flagged: syncs inside ``get`` /
  ``get_name_value`` / ``_sync*`` bodies (the metric log-boundary fetch)
  live outside loop-function bodies by construction.

* ``signal-unsafe`` (ERROR/WARNING) — lock acquisition or
  allocation-heavy calls lexically inside a **registered signal
  handler** (a function installed via ``signal.signal``): a signal can
  land while the interrupted frame already holds the very lock the
  handler wants (logging's module lock, a profiler counter lock, the
  GIL-guarded allocator arenas), deadlocking the process — the hazard
  class the checkpoint SIGTERM handler dodges by hand by setting ONE flag and
  returning (``checkpoint/manager.py`` ``install_sigterm``).

Intentional sites are suppressed inline with ``# mx-lint: allow(<code>)``
(on the offending line or the enclosing ``with`` line); historical debt is
carried by a checked-in baseline (:func:`load_baseline`/:func:`diff_baseline`)
so CI fails only on NEW findings — and :func:`stale_baseline` reports
suppressions the code no longer needs, which the CI gate treats as
findings too (a baseline that only grows is a baseline nobody trusts).
"""
from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, List, Optional, Tuple

from .findings import Finding, Report, Severity

__all__ = ["lint_paths", "lint_source", "load_baseline", "write_baseline",
           "diff_baseline", "stale_baseline", "baseline_key"]

_LOCK_NAME = re.compile(r"(lock|cond|mutex|sem)", re.IGNORECASE)
_ALLOW = re.compile(r"#\s*mx-lint:\s*allow\(([\w\s,-]+)\)")

# attribute-call names that synchronize with the device / block the
# thread: the reference's, then torch's (.item() is in both)
_HOST_SYNC_METHODS = {"asnumpy", "wait_to_read", "block_until_ready",
                      "device_get", "item", "result",
                      "tolist", "cpu", "numpy", "synchronize"}
# the subset that is unambiguous in a batch loop (`.result()`/`.item()`
# are too generic to flag outside a lock context)
_LOOP_SYNC_METHODS = {"asnumpy", "asscalar", "wait_to_read",
                      "block_until_ready", "device_get", "synchronize"}
# training/eval-loop owners: one sync per iteration here gates steps/s
_LOOP_FUNC = re.compile(r"^(fit|score)$|_loop$")
# module roots whose calls dispatch device work
_DISPATCH_ROOTS = {"jax", "jnp", "torch"}
_DISPATCH_ARRAY_FNS = {"array", "asarray", "device_put"}


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted-name rendering of a call target / with-context."""
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return "%s.%s" % (base, node.attr) if base else node.attr
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    return ""


def _is_lock_expr(expr: ast.AST) -> bool:
    return bool(_LOCK_NAME.search(_dotted(expr)))


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, report: Report):
        self.path = path
        self.lines = source.splitlines()
        self.report = report
        self.lock_stack: List[Tuple[str, int]] = []   # (lock name, line)
        self.func_stack: List[str] = []
        self.loop_depth = 0

    # ------------------------------------------------------- suppression
    def _allowed(self, code: str, *lines: int) -> bool:
        for ln in lines:
            if ln is None or not (1 <= ln <= len(self.lines)):
                continue
            m = _ALLOW.search(self.lines[ln - 1])
            if m and code in [c.strip() for c in m.group(1).split(",")]:
                return True
        return False

    def _add(self, code: str, severity: Severity, message: str,
             line: int) -> None:
        lock_lines = [ln for _, ln in self.lock_stack]
        if self._allowed(code, line, *lock_lines):
            return
        self.report.add(code, severity, message, path=self.path, line=line,
                        func=".".join(self.func_stack) or "<module>")

    # -------------------------------------------------------- traversal
    def visit_ClassDef(self, node):
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    def visit_FunctionDef(self, node):
        self.func_stack.append(node.name)
        # a new function body does NOT inherit the enclosing with-lock
        # textually... but nested defs under `with lock:` are usually
        # callbacks invoked elsewhere — reset the lock context for them
        saved, self.lock_stack = self.lock_stack, []
        saved_loops, self.loop_depth = self.loop_depth, 0
        self.generic_visit(node)
        self.lock_stack = saved
        self.loop_depth = saved_loops
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        # a lambda built under a lock runs later, outside it — same
        # deferred-callback reset as nested defs
        saved, self.lock_stack = self.lock_stack, []
        self.generic_visit(node)
        self.lock_stack = saved

    def visit_With(self, node):
        held = [(_dotted(item.context_expr), item.context_expr.lineno)
                for item in node.items if _is_lock_expr(item.context_expr)]
        self.lock_stack.extend(held)
        self.generic_visit(node)
        if held:
            del self.lock_stack[-len(held):]

    visit_AsyncWith = visit_With

    def visit_For(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_AsyncFor = visit_For
    visit_While = visit_For

    def _in_loop_func(self) -> bool:
        return bool(self.loop_depth) and bool(self.func_stack) and \
            bool(_LOOP_FUNC.search(self.func_stack[-1]))

    def visit_Call(self, node):
        name = _dotted(node.func)
        leaf = name.rsplit(".", 1)[-1]
        root = name.split(".", 1)[0]
        line = node.lineno

        if name == "time.time":
            self._add(
                "wall-clock", Severity.WARNING,
                "time.time() is wall-clock (jumps with NTP) — use "
                "time.monotonic()/perf_counter() for latency/deadline "
                "math", line)

        if self._in_loop_func() and (
                leaf in _LOOP_SYNC_METHODS or name in (
                    "jax.block_until_ready", "jax.device_get")):
            self._add(
                "eager-loop-sync", Severity.WARNING,
                "host sync %r inside the batch loop of %r — one device "
                "round-trip per batch gates steps/s; accumulate on "
                "device and defer the fetch to a log boundary "
                "(EvalMetric.update_device / InflightWindow)"
                % (name + "()", self.func_stack[-1]), line)

        if self.lock_stack:
            locks = ", ".join(l for l, _ in self.lock_stack)
            if leaf in _HOST_SYNC_METHODS or name in (
                    "jax.block_until_ready", "jax.device_get"):
                self._add(
                    "lock-host-sync", Severity.ERROR,
                    "host sync %r while holding lock(s) [%s] — other "
                    "threads queue behind the device, and callback "
                    "re-entry deadlocks"
                    % (name + "()", locks), line)
            elif root in _DISPATCH_ROOTS or (
                    leaf in _DISPATCH_ARRAY_FNS and
                    root in ("nd", "nd_mod", "ndarray", "jax", "jnp")):
                self._add(
                    "lock-dispatch", Severity.WARNING,
                    "device dispatch %r under lock(s) [%s] — the card is "
                    "serialized behind a Python mutex" % (name, locks),
                    line)

        # bare acquire()/release() participates in lock_stack exactly
        # like `with` — the try/finally idiom must not be invisible to
        # the under-lock checks above (function exit still resets the
        # stack, bounding an unmatched acquire to its function)
        if isinstance(node.func, ast.Attribute):
            recv = _dotted(node.func.value)
            if leaf == "acquire" and _LOCK_NAME.search(recv):
                self.lock_stack.append((recv, line))
            elif leaf == "release" and _LOCK_NAME.search(recv):
                for i in range(len(self.lock_stack) - 1, -1, -1):
                    if self.lock_stack[i][0] == recv:
                        del self.lock_stack[i]
                        break
        self.generic_visit(node)


# methods that take a lock / block — fatal if the interrupted frame
# already holds the other side (python's own signal docs: handlers must
# be reentrant). The first set is unambiguous; the second is flagged
# only when the receiver's name looks synchronization-flavored
# (str.join / dict.get would otherwise drown the rule in noise).
_SIGNAL_LOCKING_METHODS = {"acquire", "notify", "notify_all"}
_SIGNAL_BLOCKING_METHODS = {"wait", "join", "put", "get", "set"}
_SIGNAL_SYNC_RECEIVER = re.compile(
    r"(lock|cond|mutex|sem|queue|thread|event)", re.IGNORECASE)
# call roots that allocate heavily or take module-level locks (logging's
# handler lock is the classic signal deadlock)
_SIGNAL_HEAVY_ROOTS = {"logging", "jax", "jnp", "np", "numpy", "nd",
                       "print", "open"}


class _SignalScanner:
    """Second pass: find functions registered via ``signal.signal`` and
    flag lock-taking / allocation-heavy calls lexically inside them.
    Registration-by-name is resolved within the file (plain names AND
    ``self._handler``-style attributes, both common in this codebase)."""

    def __init__(self, path: str, source: str, report: Report):
        self.path = path
        self.lines = source.splitlines()
        self.report = report

    def _allowed(self, line: int) -> bool:
        if not (1 <= line <= len(self.lines)):
            return False
        m = _ALLOW.search(self.lines[line - 1])
        return bool(m and "signal-unsafe" in
                    [c.strip() for c in m.group(1).split(",")])

    def scan(self, tree: ast.AST) -> None:
        defs: Dict[str, ast.AST] = {}
        handlers: List[Tuple[ast.AST, str]] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[node.name] = node
            elif isinstance(node, ast.Call) and \
                    _dotted(node.func) in ("signal.signal",
                                           "signal.sigaction") and \
                    len(node.args) >= 2:
                target = node.args[1]
                if isinstance(target, ast.Lambda):
                    handlers.append((target, "<lambda>"))
                elif isinstance(target, ast.Name):
                    handlers.append((target.id, target.id))
                elif isinstance(target, ast.Attribute):
                    handlers.append((target.attr, target.attr))
        seen = set()
        for target, name in handlers:
            node = defs.get(target) if isinstance(target, str) else target
            if node is None or id(node) in seen:
                continue
            seen.add(id(node))
            self._scan_handler(node, name)

    def _scan_handler(self, fn: ast.AST, name: str) -> None:
        for node in ast.walk(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if _is_lock_expr(item.context_expr):
                        self._add(
                            Severity.ERROR, name,
                            "acquires lock %r" % _dotted(item.context_expr),
                            item.context_expr.lineno)
            elif isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                leaf = dotted.rsplit(".", 1)[-1]
                root = dotted.split(".", 1)[0]
                receiver = dotted.rsplit(".", 1)[0] if "." in dotted else ""
                if leaf in _SIGNAL_LOCKING_METHODS and "." in dotted:
                    self._add(
                        Severity.ERROR, name,
                        "calls %s() — takes a lock/blocks" % dotted,
                        node.lineno)
                elif leaf in _SIGNAL_BLOCKING_METHODS and \
                        _SIGNAL_SYNC_RECEIVER.search(receiver):
                    self._add(
                        Severity.ERROR, name,
                        "calls %s() — takes a lock/blocks" % dotted,
                        node.lineno)
                elif root in _SIGNAL_HEAVY_ROOTS:
                    self._add(
                        Severity.WARNING, name,
                        "calls %s() — allocation-heavy / takes module "
                        "locks" % dotted, node.lineno)

    def _add(self, severity: Severity, handler: str, what: str,
             line: int) -> None:
        if self._allowed(line):
            return
        self.report.add(
            "signal-unsafe", severity,
            "registered signal handler %r %s: a signal can land while "
            "the interrupted frame holds the other side and deadlock "
            "the process — handlers must only set a flag (the "
            "install_sigterm discipline)" % (handler, what),
            path=self.path, line=line, func=handler)


def lint_source(source: str, path: str = "<string>",
                report: Optional[Report] = None,
                concurrency: bool = True) -> Report:
    """Lint one source blob. ``concurrency=True`` (the default) also runs
    the whole-program lock-order pass over this single file — right for
    standalone snippets and fixtures; ``lint_paths`` passes ``False`` and
    runs that pass ONCE over all files so cross-module cycles resolve."""
    report = report if report is not None else Report(context="lint")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        report.add("parse-error", Severity.ERROR,
                   "cannot parse: %s" % exc, path=path,
                   line=exc.lineno or 0)
        return report
    _FileLinter(path, source, report).visit(tree)
    _SignalScanner(path, source, report).scan(tree)
    if concurrency:
        from .concurrency import analyze_sources
        analyze_sources([(path, source, tree)], report)
    return report


def lint_paths(paths, report: Optional[Report] = None,
               exclude=("native/vendor",)) -> Report:
    """Lint every ``.py`` file under ``paths`` (files or directories),
    then run the whole-program concurrency pass over the full file set
    (lock names and helper calls resolve across modules)."""
    report = report if report is not None else Report(context="lint")
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for f in sorted(filenames):
                full = os.path.join(dirpath, f)
                if f.endswith(".py") and not any(e in full
                                                 for e in exclude):
                    files.append(full)
    units = []
    for f in sorted(files):
        with open(f, "r", encoding="utf-8") as fh:
            src = fh.read()
        lint_source(src, path=f, report=report, concurrency=False)
        units.append((f, src))
    from .concurrency import analyze_sources
    analyze_sources(units, report)
    return report


# ------------------------------------------------------------------ baseline
# Keys are (relpath, code, enclosing function) with a count — stable under
# line-number drift, so refactors that merely move debt don't churn the
# file, while any NEW site in a function bumps its count and fails CI.


def baseline_key(f: Finding, root: str) -> str:
    rel = os.path.relpath(f.path, root) if f.path else "<none>"
    return "%s::%s::%s" % (rel.replace(os.sep, "/"), f.code,
                           f.func or "<module>")


def _key_counts(report: Report, root: str) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for f in report:
        if f.code == "cost-model":
            continue
        k = baseline_key(f, root)
        counts[k] = counts.get(k, 0) + 1
    return counts


def write_baseline(report: Report, path: str, root: str) -> int:
    """Write the aggregated baseline; returns the number of KEYS written
    (several same-key findings collapse into one counted key)."""
    payload = {
        "__doc__": "mx-lint baseline: known findings keyed by "
                   "path::code::function with counts; CI fails on drift "
                   "in EITHER direction — a count exceeding its baseline "
                   "(new finding) or a baseline exceeding the count "
                   "(stale suppression). Regenerate with `python -m "
                   "mxnet_tpu_torch.analysis lint --update-baseline`.",
        "findings": _key_counts(report, root),
    }
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return len(payload["findings"])


def load_baseline(path: str) -> Dict[str, int]:
    with open(path) as fh:
        payload = json.load(fh)
    return {k: int(v) for k, v in payload.get("findings", {}).items()}


def stale_baseline(report: Report, baseline: Dict[str, int],
                   root: str) -> Dict[str, int]:
    """Baseline keys whose counted debt the code no longer carries
    (key -> excess). Stale suppressions are findings too: they mask the
    next REAL finding introduced at that key, so the CI gate fails on
    drift in *either* direction and the fix is
    ``python -m mxnet_tpu_torch.analysis lint --update-baseline``."""
    counts = _key_counts(report, root)
    return {k: v - counts.get(k, 0) for k, v in sorted(baseline.items())
            if v > counts.get(k, 0)}


def diff_baseline(report: Report, baseline: Dict[str, int],
                  root: str) -> List[Finding]:
    """Findings NOT covered by the baseline (per-key overflow keeps the
    textually-last findings of that key, which skews new-at-the-bottom —
    good enough for a gate whose fix is 'look at this function')."""
    budget = dict(baseline)
    fresh: List[Finding] = []
    for f in report:
        if f.code == "cost-model":
            continue
        k = baseline_key(f, root)
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            fresh.append(f)
    return fresh
