"""Whole-program lock-order analysis — the static half of the
concurrency verifier (runtime half: ``mxnet_tpu_torch.lockcheck``).

The port of the reference's ``analysis/concurrency.py``. The lexical
linter sees a host sync under a ``with lock:`` only when both are in
one function; a deadlock that crosses a function or thread boundary
(the sync one helper call down, a flush ordering spanning two modules)
needs the whole program. This pass is the classic static lockset
construction (Eraser's discipline applied to an AST): name every lock
object in the package, walk every function with a held-set, resolve
calls ONE level through package-local helpers, and check the resulting
acquires-while-holding graph.

Graph model
-----------
*Nodes* are named lock objects:

* module globals assigned a ``threading``/``lockcheck`` factory call
  (``_ring_lock = threading.Lock()``, ``lockcheck.Lock(name=...)``) —
  ``<module>.<name>``;
* instance attributes assigned one in any method (``self._lock =
  lockcheck.Lock(...)``) — ``<module>.<Class>.<attr>``; a
  ``Condition(self.other)`` aliases to the lock it shares; a
  list-comprehension of factory calls names the COLLECTION
  (``<...>.<attr>[]`` — its members are one node, matching the runtime
  witness's creation-site keying);
* lock-named expressions the tables can't resolve get a node scoped to
  their function — they still participate locally but never unify
  across functions (no false cycles from guessing).

Receivers other than ``self`` resolve through two tables: a module
function registered as a ``Thread(target=...)`` from class ``C``
resolves ``srv._lock``-style attrs against ``C`` (the scheduler-loop
idiom), and an attr defined by exactly one class in the program resolves
globally.

*Edges* ``A -> B`` mean "B acquired while A held", from three sources:
``with``-nesting, bare ``acquire()``/``release()`` pair tracking, and —
the interprocedural step — a call made while holding ``A`` into a
package-local helper that acquires ``B``.

Findings
--------
* ``lock-order-cycle`` (ERROR): a cycle in the edge graph; the message
  names every edge's acquisition chain with file:line. Two threads
  driving any two edges of the cycle concurrently can deadlock.
* ``lock-host-sync`` (ERROR, interprocedural upgrade): a call made while
  holding a lock into a helper whose body host-syncs (``asnumpy`` et
  al.) — exactly the depth-1 shape the lexical pass cannot see. Depth-0
  syncs stay the lexical linter's job (never double-reported here).
* ``unlocked-shared-state`` (WARNING): an instance attribute written
  under a lock in one method but written with NO lock held on a
  thread-entry path (a ``Thread(target=...)`` function or a helper it
  calls) — the lock discipline exists but has a hole. ``__init__``
  writes are exempt (``Thread.start()`` is the happens-before edge).

Suppression uses the shared ``# mx-lint: allow(<code>)`` machinery: a
finding is dropped when any line materially involved (the acquisition
lines of a cycle's edges, the call line / callee sync line of an
interprocedural sync, the unlocked write line) carries the annotation.
Findings flow through the ordinary :class:`Report`, so the baseline and
CI drift gates of ``python -m mxnet_tpu_torch.analysis lint`` apply
unchanged.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Report, Severity
from .lint import _ALLOW, _HOST_SYNC_METHODS, _LOCK_NAME, _dotted

__all__ = ["analyze_sources"]

_FACTORY_LEAVES = {"Lock", "RLock", "Condition"}
_FACTORY_ROOTS = {"threading", "_threading", "lockcheck", "_lockcheck",
                  "mx", "mxnet_tpu", "mt", "mxnet_tpu_torch"}
_SYNC_FULL = {"jax.block_until_ready", "jax.device_get"}
_THREAD_LEAVES = {"Thread"}


def _is_factory(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    d = _dotted(call.func)
    if not d:
        return False
    leaf = d.rsplit(".", 1)[-1]
    if leaf not in _FACTORY_LEAVES:
        return False
    if "." not in d:
        return True                      # `from threading import Lock`
    return d.split(".", 1)[0] in _FACTORY_ROOTS


def _lockish(node: ast.AST) -> str:
    """Dotted rendering that also unwraps one trailing subscript
    (``self._iter_locks[i]`` -> ``self._iter_locks[]``)."""
    if isinstance(node, ast.Subscript):
        base = _lockish(node.value)
        return base + "[]" if base else ""
    return _dotted(node)


class _Event:
    __slots__ = ("kind", "line", "name", "held", "allow_lines")

    def __init__(self, kind, line, name, held=(), allow_lines=()):
        self.kind = kind          # "acquire" | "sync" | "call" | "write"
        self.line = line
        self.name = name          # lock id / sync name / callee / attr
        self.held = tuple(held)   # lock ids held at the event
        self.allow_lines = tuple(allow_lines)


class _Func:
    __slots__ = ("mod", "cls", "name", "node", "events", "entry_cls")

    def __init__(self, mod, cls, name, node):
        self.mod = mod
        self.cls = cls            # enclosing class name or None
        self.name = name          # "Class.meth" or "fn"
        self.node = node
        self.events: List[_Event] = []
        self.entry_cls: Optional[str] = None   # class that Thread()s us


class _Module:
    __slots__ = ("path", "key", "tree", "lines", "globals", "attr_locks",
                 "imports", "funcs", "thread_targets")

    def __init__(self, path: str, source: str, tree: ast.AST):
        self.path = path
        base = os.path.basename(path)
        self.key = base[:-3] if base.endswith(".py") else base
        self.tree = tree
        self.lines = source.splitlines()
        self.globals: Dict[str, str] = {}            # name -> lock id
        self.attr_locks: Dict[str, Dict[str, str]] = {}   # cls -> attr -> id
        self.imports: Dict[str, str] = {}            # alias -> module key
        self.funcs: Dict[str, _Func] = {}            # qualname -> _Func
        # (target dotted-name, enclosing class or None, line)
        self.thread_targets: List[Tuple[str, Optional[str], int]] = []


# --------------------------------------------------------------- phase 1a


def _scan_module(mod: _Module) -> None:
    """Lock tables, imports, function index, Thread(target=) registry."""
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and _is_factory(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    mod.globals[tgt.id] = "%s.%s" % (mod.key, tgt.id)

    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = alias.asname or alias.name.rsplit(".", 1)[-1]
                mod.imports[name] = alias.name.rsplit(".", 1)[-1]

    def walk_funcs(body, cls: Optional[str]):
        for node in body:
            if isinstance(node, ast.ClassDef):
                walk_funcs(node.body, node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = "%s.%s" % (cls, node.name) if cls else node.name
                mod.funcs[qual] = _Func(mod, cls, qual, node)
                _scan_locks_and_threads(mod, cls, node)

    walk_funcs(mod.tree.body, None)


def _scan_locks_and_threads(mod: _Module, cls: Optional[str],
                            fn: ast.AST) -> None:
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Attribute) and \
                isinstance(node.targets[0].value, ast.Name) and \
                node.targets[0].value.id == "self" and cls:
            attr = node.targets[0].attr
            table = mod.attr_locks.setdefault(cls, {})
            val = node.value
            if _is_factory(val):
                # Condition(self.other) shares the other lock's node
                aliased = None
                if _dotted(val.func).rsplit(".", 1)[-1] == "Condition" \
                        and val.args:
                    other = _dotted(val.args[0])
                    if other.startswith("self."):
                        aliased = table.get(other[5:])
                table[attr] = aliased or "%s.%s.%s" % (mod.key, cls, attr)
            elif isinstance(val, ast.ListComp) and _is_factory(val.elt):
                table[attr] = "%s.%s.%s[]" % (mod.key, cls, attr)
        elif isinstance(node, ast.Call) and \
                _dotted(node.func).rsplit(".", 1)[-1] in _THREAD_LEAVES:
            for kw in node.keywords:
                if kw.arg == "target":
                    tgt = _dotted(kw.value)
                    if tgt:
                        mod.thread_targets.append((tgt, cls, node.lineno))


# --------------------------------------------------------------- phase 1b


class _FnWalk(ast.NodeVisitor):
    """Per-function event walk with a held-lock stack (``with`` plus bare
    ``acquire()``/``release()``), resolving lock expressions through the
    module tables as it goes."""

    def __init__(self, prog: "_Program", func: _Func):
        self.prog = prog
        self.func = func
        self.held: List[Tuple[str, int]] = []    # (lock id, line)

    def run(self) -> None:
        for stmt in self.func.node.body:
            self.visit(stmt)

    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        return self.prog.resolve_lock(self.func, expr)

    def _emit(self, kind, line, name):
        allow = [line] + [ln for _, ln in self.held]
        self.func.events.append(_Event(
            kind, line, name, held=[l for l, _ in self.held],
            allow_lines=allow))

    # deferred-callback discipline: a nested def/lambda body runs later,
    # outside the enclosing held-set — and its own lock use is opaque to
    # the tables, so it is skipped (the runtime witness covers it)
    def visit_FunctionDef(self, node):
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_With(self, node):
        pushed = 0
        for item in node.items:
            expr = item.context_expr
            lock = self._resolve_lock(expr)
            if lock is not None:
                self._emit("acquire", expr.lineno, lock)
                self.held.append((lock, expr.lineno))
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        if pushed:
            del self.held[-pushed:]

    visit_AsyncWith = visit_With

    def visit_Assign(self, node):
        self.visit(node.value)
        for tgt in node.targets:
            self._note_write(tgt)

    def visit_AugAssign(self, node):
        self.visit(node.value)
        self._note_write(node.target)

    def _note_write(self, tgt: ast.AST) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._note_write(el)
            return
        if isinstance(tgt, ast.Subscript):
            tgt = tgt.value             # d[k] = v mutates d
        if not (isinstance(tgt, ast.Attribute) and
                isinstance(tgt.value, ast.Name)):
            return
        recv, attr = tgt.value.id, tgt.attr
        cls = self.func.cls or self.func.entry_cls
        if recv != "self" and self.func.entry_cls is None:
            return
        if cls and attr in self.prog.mod_of(self.func).attr_locks.get(
                cls, {}):
            return                       # the lock attr itself
        self._emit("write", tgt.lineno, "%s.%s" % (cls or "?", attr))

    def visit_Call(self, node):
        d = _dotted(node.func)
        leaf = d.rsplit(".", 1)[-1] if d else ""
        if leaf == "acquire" and isinstance(node.func, ast.Attribute):
            lock = self._resolve_lock(node.func.value)
            if lock is not None:
                self._emit("acquire", node.lineno, lock)
                self.held.append((lock, node.lineno))
        elif leaf == "release" and isinstance(node.func, ast.Attribute):
            lock = self._resolve_lock(node.func.value)
            if lock is not None:
                for i in range(len(self.held) - 1, -1, -1):
                    if self.held[i][0] == lock:
                        del self.held[i]
                        break
        elif leaf in _HOST_SYNC_METHODS or d in _SYNC_FULL:
            self._emit("sync", node.lineno, d)
        elif d and d not in ("super",):
            self._emit("call", node.lineno, d)
        self.generic_visit(node)


# ----------------------------------------------------------------- program


class _Program:
    def __init__(self, modules: List[_Module]):
        self.modules = modules
        self.by_key = {m.key: m for m in modules}
        # attr -> [(module, class, lock id)] across the program
        self.attr_index: Dict[str, List[Tuple[_Module, str, str]]] = {}
        for m in modules:
            for cls, table in m.attr_locks.items():
                for attr, lock in table.items():
                    self.attr_index.setdefault(attr, []).append(
                        (m, cls, lock))
        # method name -> [funcs] across the program
        self.meth_index: Dict[str, List[_Func]] = {}
        for m in modules:
            for qual, fn in m.funcs.items():
                self.meth_index.setdefault(
                    qual.rsplit(".", 1)[-1], []).append(fn)

    def mod_of(self, func: _Func) -> _Module:
        return self.by_key[func.mod.key]

    # ------------------------------------------------------- resolution
    def resolve_lock(self, func: _Func, expr: ast.AST) -> Optional[str]:
        mod = func.mod
        d = _lockish(expr)
        if not d:
            return None
        named = bool(_LOCK_NAME.search(d))
        parts = d.split(".")
        if len(parts) == 1:
            if d in mod.globals:
                return mod.globals[d]
            return "%s:%s:%s" % (mod.key, func.name, d) if named else None
        recv, attr = ".".join(parts[:-1]), parts[-1]
        if recv == "self" and func.cls:
            lock = mod.attr_locks.get(func.cls, {}).get(attr)
            if lock:
                return lock
        if recv in mod.imports:
            other = self.by_key.get(mod.imports[recv])
            if other and attr in other.globals:
                return other.globals[attr]
        if recv != "self":
            # thread-entry functions resolve foreign receivers against
            # the class that spawned them (the scheduler-loop idiom)
            if func.entry_cls:
                lock = mod.attr_locks.get(func.entry_cls, {}).get(attr)
                if lock:
                    return lock
            owners = self.attr_index.get(attr, ())
            if len(owners) == 1:
                return owners[0][2]
        if named:
            return "%s:%s:%s" % (mod.key, func.name, d)
        return None

    def resolve_callee(self, func: _Func, dotted: str) -> Optional[_Func]:
        mod = func.mod
        parts = dotted.split(".")
        if len(parts) == 1:
            return mod.funcs.get(dotted)
        recv, meth = ".".join(parts[:-1]), parts[-1]
        if recv == "self" and func.cls:
            hit = mod.funcs.get("%s.%s" % (func.cls, meth))
            if hit:
                return hit
        if recv in mod.imports:
            other = self.by_key.get(mod.imports[recv])
            if other:
                hit = other.funcs.get(meth)
                if hit:
                    return hit
        if func.entry_cls:
            hit = mod.funcs.get("%s.%s" % (func.entry_cls, meth))
            if hit:
                return hit
        owners = self.meth_index.get(meth, ())
        if len(owners) == 1:
            return owners[0]
        return None

    # ------------------------------------------------------ suppression
    def allowed(self, code: str,
                sites: Sequence[Tuple[_Module, int]]) -> bool:
        for mod, line in sites:
            if not (1 <= line <= len(mod.lines)):
                continue
            m = _ALLOW.search(mod.lines[line - 1])
            if m and code in [c.strip() for c in m.group(1).split(",")]:
                return True
        return False


def _loc(mod: _Module, line: int) -> str:
    return "%s:%d" % (mod.path, line)


# ------------------------------------------------------------- entry point


def analyze_sources(units, report: Optional[Report] = None) -> Report:
    """Run the whole-program pass over ``units`` — an iterable of
    ``(path, source)`` or ``(path, source, tree)`` covering every file
    that should resolve against each other (``lint_paths`` hands it the
    package; tests hand it fixtures)."""
    report = report if report is not None else Report(context="concurrency")
    modules: List[_Module] = []
    for unit in units:
        path, source = unit[0], unit[1]
        tree = unit[2] if len(unit) > 2 else None
        if tree is None:
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError:
                continue                 # lint_source already reported it
        modules.append(_Module(path, source, tree))
    if not modules:
        return report

    for mod in modules:
        _scan_module(mod)
    prog = _Program(modules)

    # thread-entry registry must exist before the event walk: entry
    # functions resolve foreign receivers through their spawning class
    entries: List[_Func] = []
    for mod in modules:
        for tgt, cls, _line in mod.thread_targets:
            fn = None
            if tgt.startswith("self.") and cls:
                fn = mod.funcs.get("%s.%s" % (cls, tgt[5:]))
            elif "." not in tgt:
                fn = mod.funcs.get(tgt)
            if fn is not None:
                if fn.entry_cls is None:
                    fn.entry_cls = None if fn.cls else cls
                entries.append(fn)

    for mod in modules:
        for fn in mod.funcs.values():
            _FnWalk(prog, fn).run()

    _check_interprocedural_sync(prog, report)
    _check_lock_order(prog, report)
    _check_unlocked_shared_state(prog, entries, report)
    return report


# ------------------------------------------------- interprocedural sync


def _check_interprocedural_sync(prog: _Program, report: Report) -> None:
    seen: Set[Tuple[str, int, str]] = set()
    for mod in prog.modules:
        for fn in mod.funcs.values():
            for ev in fn.events:
                if ev.kind != "call" or not ev.held:
                    continue
                g = prog.resolve_callee(fn, ev.name)
                if g is None or g is fn:
                    continue
                gmod = prog.mod_of(g)
                for sev in g.events:
                    if sev.kind != "sync":
                        continue
                    key = (mod.path, ev.line, sev.name)
                    if key in seen:
                        continue
                    seen.add(key)
                    sites = [(mod, ln) for ln in ev.allow_lines] + \
                            [(gmod, ln) for ln in sev.allow_lines]
                    if prog.allowed("lock-host-sync", sites):
                        continue
                    report.add(
                        "lock-host-sync", Severity.ERROR,
                        "call %s() while holding lock(s) [%s] reaches "
                        "host sync %s() at %s — the helper blocks on "
                        "the device under the caller's lock (a sync "
                        "under a lock, one call deep)"
                        % (ev.name, ", ".join(ev.held), sev.name,
                           _loc(gmod, sev.line)),
                        path=mod.path, line=ev.line, func=fn.name)


# --------------------------------------------------------- lock ordering


class _Edge:
    __slots__ = ("chain", "sites")

    def __init__(self, chain: str, sites):
        self.chain = chain               # human acquisition chain
        self.sites = sites               # [(module, line)] for allow()


def _collect_edges(prog: _Program) -> Dict[Tuple[str, str], _Edge]:
    edges: Dict[Tuple[str, str], _Edge] = {}

    def add(a: str, b: str, chain: str, sites) -> None:
        if a == b:
            return
        edges.setdefault((a, b), _Edge(chain, sites))

    for mod in prog.modules:
        for fn in mod.funcs.values():
            for ev in fn.events:
                if ev.kind == "acquire" and ev.held:
                    for a in ev.held:
                        add(a, ev.name,
                            "%s (%s) acquires %s while holding %s"
                            % (fn.name, _loc(mod, ev.line), ev.name, a),
                            [(mod, ln) for ln in ev.allow_lines])
                elif ev.kind == "call" and ev.held:
                    g = prog.resolve_callee(fn, ev.name)
                    if g is None or g is fn:
                        continue
                    gmod = prog.mod_of(g)
                    for gev in g.events:
                        if gev.kind != "acquire":
                            continue
                        for a in ev.held:
                            add(a, gev.name,
                                "%s (%s) calls %s() which acquires %s "
                                "at %s while the caller holds %s"
                                % (fn.name, _loc(mod, ev.line), ev.name,
                                   gev.name, _loc(gmod, gev.line), a),
                                [(mod, ln) for ln in ev.allow_lines] +
                                [(gmod, ln) for ln in gev.allow_lines])
    return edges


def _find_cycles(edges: Dict[Tuple[str, str], _Edge],
                 limit: int = 64) -> List[List[str]]:
    """Elementary cycles, shortest-first per start node, deduped by node
    set; bounded so a pathological graph can't hang the lint."""
    graph: Dict[str, List[str]] = {}
    for a, b in edges:
        graph.setdefault(a, []).append(b)
    cycles: List[List[str]] = []
    seen_sets: Set[frozenset] = set()
    for start in sorted(graph):
        # BFS over simple paths from start back to start
        queue: List[List[str]] = [[start]]
        steps = 0
        while queue and steps < 10000 and len(cycles) < limit:
            steps += 1
            path = queue.pop(0)
            for nxt in graph.get(path[-1], ()):
                if nxt == start and len(path) > 1:
                    key = frozenset(path)
                    if key not in seen_sets:
                        seen_sets.add(key)
                        cycles.append(path[:])
                elif nxt not in path and len(path) < 6:
                    queue.append(path + [nxt])
    return cycles


def _check_lock_order(prog: _Program, report: Report) -> None:
    edges = _collect_edges(prog)
    for cycle in _find_cycles(edges):
        ring = cycle + [cycle[0]]
        used = [edges[(ring[i], ring[i + 1])] for i in range(len(cycle))]
        sites = [s for e in used for s in e.sites]
        if prog.allowed("lock-order-cycle", sites):
            continue
        chains = "; ".join(e.chain for e in used)
        anchor_mod, anchor_line = used[0].sites[0]
        report.add(
            "lock-order-cycle", Severity.ERROR,
            "lock-order cycle %s: %s — two threads driving different "
            "edges of this cycle concurrently deadlock; pick one global "
            "order (or collapse the locks)"
            % (" -> ".join(ring), chains),
            path=anchor_mod.path, line=anchor_line,
            func=used[0].chain.split(" ", 1)[0])


# ------------------------------------------------- unlocked shared state


def _check_unlocked_shared_state(prog: _Program, entries: List[_Func],
                                 report: Report) -> None:
    # entry-reachable = the Thread targets plus their one-level callees
    reach: Set[int] = set()
    for fn in entries:
        reach.add(id(fn))
        for ev in fn.events:
            if ev.kind == "call":
                g = prog.resolve_callee(fn, ev.name)
                if g is not None:
                    reach.add(id(g))

    # (module, class.attr) -> locked write / unlocked-in-entry write
    locked: Dict[Tuple[str, str], Tuple[_Module, _Func, int]] = {}
    unlocked: Dict[Tuple[str, str], Tuple[_Module, _Func, int]] = {}
    for mod in prog.modules:
        for fn in mod.funcs.values():
            leaf = fn.name.rsplit(".", 1)[-1]
            for ev in fn.events:
                if ev.kind != "write" or ev.name.startswith("?."):
                    continue
                key = (mod.key, ev.name)
                if ev.held:
                    locked.setdefault(key, (mod, fn, ev.line))
                elif id(fn) in reach and leaf != "__init__":
                    unlocked.setdefault(key, (mod, fn, ev.line))

    for key in sorted(set(locked) & set(unlocked)):
        lmod, lfn, lline = locked[key]
        umod, ufn, uline = unlocked[key]
        if prog.allowed("unlocked-shared-state", [(umod, uline)]):
            continue
        report.add(
            "unlocked-shared-state", Severity.WARNING,
            "attribute %s is written under a lock in %s (%s) but "
            "written with NO lock held on the thread-entry path %s — "
            "the lock discipline protecting it has a hole (torn "
            "read/write across threads)"
            % (key[1], lfn.name, _loc(lmod, lline), ufn.name),
            path=umod.path, line=uline, func=ufn.name)
