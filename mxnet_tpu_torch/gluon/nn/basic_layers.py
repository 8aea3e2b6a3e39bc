"""Basic Gluon layers: the port's copy of the reference's
``gluon/nn/basic_layers.py`` — Sequential, HybridSequential, Dense,
Activation, Dropout, BatchNorm, LeakyReLU, Embedding, Flatten, Lambda,
HybridLambda.

``BatchNorm`` follows the aux protocol of the ``BatchNorm`` op: its
running statistics are parameters without gradient, handed to the op as
aux states, and ``imperative_invoke`` commits the op's new values into
them after a training call (once per call, hybridized or not).
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "LeakyReLU", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "MoE"]


class Sequential(Block):
    """Stack of Blocks (reference: basic_layers.py:26)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children:
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]


class HybridSequential(HybridBlock):
    """Stack of HybridBlocks (reference: basic_layers.py:65)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children:
            x = block.forward(x) if isinstance(block, HybridBlock) \
                else block(x)
        return x

    def hybrid_forward(self, F, x):
        for block in self._children:
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]


class Dense(HybridBlock):
    """Fully-connected layer (reference: basic_layers.py:104)."""

    def __init__(self, units, activation=None, use_bias=True,
                 flatten=True, weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as init_mod
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self._flatten = flatten
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,),
                    init=init_mod.Zero() if bias_initializer == "zeros"
                    else bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def shape_update(self, x, *args):
        # flatten=False applies the projection to the last axis only
        # (reference basic_layers.py Dense(flatten=False))
        in_units = (int(x.shape[-1]) if not self._flatten
                    else int(np.prod(x.shape[1:])))
        self.weight.shape = (self._units, in_units)
        if self.bias is not None:
            self.bias.shape = (self._units,)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None,
                               flatten=self._flatten)
        if self.act is not None:
            out = self.act(out)
        return out

    def __repr__(self):
        return "Dense(%s -> %s)" % (self.weight.shape[1] or None, self._units)


class Activation(HybridBlock):
    """(reference: basic_layers.py:187)."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class Dropout(HybridBlock):
    """(reference: basic_layers.py:219)."""

    def __init__(self, rate=0.5, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate)

    def __repr__(self):
        return "Dropout(p = %s)" % self._rate


class BatchNorm(HybridBlock):
    """(reference: basic_layers.py:255)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as init_mod
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        self._in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=init_mod.One(),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=init_mod.Zero(),
                allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=init_mod.Zero(), allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=init_mod.One(), allow_deferred_init=True,
                differentiable=False)

    def shape_update(self, x, *args):
        ch = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            p.shape = (ch,)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           eps=self._epsilon, momentum=self._momentum,
                           fix_gamma=not self._scale,
                           use_global_stats=self._use_global_stats,
                           axis=self._axis)

    def __repr__(self):
        return "BatchNorm(axis=%d, channels=%s)" % (
            self._axis, self.gamma.shape[0] or None)


class LeakyReLU(HybridBlock):
    """(reference: basic_layers.py:342)."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "LeakyReLU(%s)" % self._alpha


class Embedding(HybridBlock):
    """(reference: basic_layers.py:375)."""

    def __init__(self, input_dim, output_dim, dtype=np.float32,
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._dtype = dtype
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def __repr__(self):
        return "Embedding(%d -> %d)" % (self._input_dim, self._output_dim)


class Flatten(HybridBlock):
    """(reference: basic_layers.py:416)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """Wrap a function into a Block (reference: later-era gluon Lambda —
    provided for custom-op ergonomics)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if not callable(function):
            raise ValueError("Lambda needs a callable, got %r" % (function,))
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """Wrap a function into a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if not callable(function):
            raise ValueError("HybridLambda needs a callable, got %r"
                             % (function,))
        self._func = function

    def hybrid_forward(self, F, *args):
        return self._func(F, *args)


class MoE(HybridBlock):
    """The reference's mixture-of-experts FFN layer (over its ``MoE``
    op). Not ported: the op and its expert parallelism are ROADMAP.md
    queue A9."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("nn.MoE is not ported yet: the MoE op and expert "
                         "parallelism are ROADMAP.md queue A9")

