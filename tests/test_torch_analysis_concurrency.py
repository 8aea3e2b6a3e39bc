"""The port's whole-program lock-order pass
(``mxnet_tpu_torch.analysis.concurrency``) against every test of the
reference's ``tests/test_analysis_concurrency.py``.

Each reference test runs as written, on its own source strings, with its
``lint_paths`` / ``lint_source`` replaced by a pair that runs both
packages' analyzers and requires the same findings (code, severity,
function, file and line) before handing the test the port's report: the
reference test's assertions then hold the port. Beside them, the port's
own lock factories (``mxnet_tpu_torch.lockcheck``, ``mt.lockcheck``) are
named nodes, and torch's syncs reach the interprocedural check.
"""
import importlib.util
import inspect
import os
import textwrap

import pytest
import torch

from mxnet_tpu import analysis as jan
from mxnet_tpu_torch import analysis as tan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)


def _reference_tests():
    spec = importlib.util.spec_from_file_location(
        "_reference_analysis_concurrency",
        os.path.join(REPO, "tests", "test_analysis_concurrency.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_tests()
REF_TESTS = sorted(n for n, f in vars(REF).items()
                   if n.startswith("test_") and callable(f))


def summary(report):
    return sorted((f.code, f.severity.name, f.func,
                   os.path.basename(f.path or ""), f.line) for f in report)


def _paired_lint_paths(paths, **kw):
    port = tan.lint_paths(paths, **kw)
    assert summary(port) == summary(jan.lint_paths(paths, **kw))
    return port


def _paired_lint_source(source, **kw):
    port = tan.lint_source(source, **kw)
    assert summary(port) == summary(jan.lint_source(source, **kw))
    return port


def test_every_reference_test_is_held():
    assert len(REF_TESTS) == 20


@pytest.mark.parametrize("name", REF_TESTS)
def test_reference_oracle_on_the_port(name, tmp_path, monkeypatch):
    monkeypatch.setattr(REF, "lint_paths", _paired_lint_paths)
    monkeypatch.setattr(REF, "lint_source", _paired_lint_source)
    fn = getattr(REF, name)
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path)
    else:
        fn()


def _tree(tmp_path, **files):
    for name, src in files.items():
        (tmp_path / (name + ".py")).write_text(textwrap.dedent(src))
    return tan.lint_paths([str(tmp_path)])


@pytest.mark.parametrize("factory", [
    "from mxnet_tpu_torch import lockcheck\nmk = lockcheck.Lock",
    "import mxnet_tpu_torch as mt\nmk = mt.lockcheck.Lock",
    "import mxnet_tpu_torch\nmk = mxnet_tpu_torch.lockcheck.Lock"])
def test_port_lock_factories_are_named(factory, tmp_path):
    """Locks made by the port's lockcheck factories are nodes of the
    graph: an ABBA between two of them is a cycle."""
    call = factory.rsplit("= ", 1)[1]
    head = factory.split("\n")[0]
    report = _tree(tmp_path, mod=head + """

LA = %s(name="A")
LB = %s(name="B")

def fa():
    with LA:
        with LB:
            pass

def fb():
    with LB:
        with LA:
            pass
""" % (call, call))
    found = [f for f in report if f.code == "lock-order-cycle"]
    assert len(found) == 1, [str(f) for f in report]
    assert "mod.LA" in found[0].message and "mod.LB" in found[0].message


@pytest.mark.parametrize("sync", ["x.item()", "x.cpu()",
                                  "torch.cuda.synchronize()",
                                  "self._event.synchronize()"])
def test_helper_hidden_torch_sync_under_lock_fires(sync, tmp_path):
    """The interprocedural check knows torch's syncs: one call deep
    under the caller's lock, each fires, naming the helper."""
    report = _tree(tmp_path, trainer="""
        import threading, torch

        class Trainer:
            def __init__(self):
                self._lock = threading.Lock()

            def _fetch(self, x):
                return %s

            def step(self, x):
                with self._lock:
                    return self._fetch(x)
    """ % sync)
    found = [f for f in report if f.code == "lock-host-sync"]
    assert len(found) == 1, [str(f) for f in report]
    assert "_fetch" in found[0].message and "Trainer._lock" in \
        found[0].message
    assert found[0].func == "Trainer.step"
