"""The port's ``mt.viz`` (``visualization.py``) against the reference's
``mx.viz``, on the CPU.

For zoo nets built by each package's own ``models`` (the MLP, LeNet,
ResNet-20 at 3x32x32 and the transformer LM), ``print_summary`` must
print the reference's text character for character (layer names and
types, output shapes, parameter counts, previous layers) and return
the same total; ``plot_network``'s graphviz source must equal the
reference's (graphviz is installed here), and without graphviz both
raise ``ImportError``.
"""
import builtins
import contextlib
import importlib
import io

import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

NETS = {
    "mlp": (lambda pkg: pkg.models.mlp.get_symbol(num_classes=10),
            {"data": (4, 784)}),
    "lenet": (lambda pkg: pkg.models.lenet.get_symbol(num_classes=10),
              {"data": (2, 1, 28, 28)}),
    "resnet20": (lambda pkg: pkg.models.resnet.get_symbol(
        num_classes=10, num_layers=20, image_shape="3,32,32"),
        {"data": (2, 3, 32, 32)}),
    "transformer": (lambda pkg: importlib.import_module(
        pkg.__name__ + ".models.transformer").get_symbol(
        vocab_size=100, num_layers=2, d_model=32, n_heads=2, seq_len=16),
        {"data": (2, 16), "softmax_label": (2, 16)}),
}


def build_net(pkg, name):
    """Zoo net ``name`` under a fresh name manager: auto-named nodes
    (``elemwiseadd<N>``) count from 0 in both packages."""
    with pkg.name.NameManager():
        return NETS[name][0](pkg)


def summary(pkg, name, shape=True):
    shapes = NETS[name][1]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        total = pkg.viz.print_summary(build_net(pkg, name),
                                      shape=shapes if shape else None)
    return total, out.getvalue()


@pytest.mark.parametrize("name", sorted(NETS))
def test_print_summary_is_the_references(name):
    want_total, want = summary(mx, name)
    got_total, got = summary(mt, name)
    assert got == want
    assert got_total == want_total > 0
    assert "Total params: %d" % got_total in got


def test_print_summary_without_shapes():
    assert summary(mt, "lenet", shape=False) == \
        summary(mx, "lenet", shape=False)


@pytest.mark.parametrize("name", ["lenet", "resnet20"])
def test_plot_network_source_is_the_references(name):
    shapes = NETS[name][1]
    want = mx.viz.plot_network(build_net(mx, name), title=name, shape=shapes)
    got = mt.viz.plot_network(build_net(mt, name), title=name, shape=shapes)
    assert got.source == want.source
    assert got.format == "pdf" and got.name == name


def test_plot_network_raises_without_graphviz(monkeypatch):
    real = builtins.__import__

    def no_graphviz(name, *args, **kwargs):
        if name == "graphviz":
            raise ImportError("no graphviz here")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_graphviz)
    for pkg in (mx, mt):
        with pytest.raises(ImportError, match="graphviz"):
            pkg.viz.plot_network(build_net(pkg, "mlp"))
