"""Weight initializers (numpy draws, written into the port's arrays).

The port's own copy of the reference's ``initializer.py`` (jax-free
there too, but importing it would run the reference package's
``__init__``, which imports jax): ``InitDesc``, the name-pattern
dispatch of ``Initializer``, and ``Uniform``, ``Normal``,
``Orthogonal``, ``Xavier``, ``MSRAPrelu``, ``Bilinear``, ``LSTMBias``,
``FusedRNN``, ``Zero``, ``One`` and ``Constant``, with ``Load`` (from a
saved parameter dict) and ``Mixed`` (by name pattern), which are called
with a name and an array as the others are; :func:`create` also takes the
names Gluon's layers use, ``"zeros"`` and ``"ones"``. Draws come from
numpy, so the same initializer with the same ``set_rng`` generator
gives the same weights in both packages; they are staged on the host
(``ctx=cpu()``) and copied into the array on its device.
"""
from __future__ import annotations

import json
import logging
import re
from typing import Dict

import numpy as np

from . import ndarray as nd
from .context import cpu
from .ndarray import NDArray

__all__ = ["InitDesc", "Initializer", "Load", "Mixed", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "FusedRNN", "One", "Zero", "Constant", "register", "create"]

_INITIALIZER_REGISTRY: Dict[str, type] = {}


def register(klass):
    _INITIALIZER_REGISTRY[klass.__name__.lower()] = klass
    return klass


_ALIASES = {"zeros": "zero", "ones": "one"}


def create(name, **kwargs) -> "Initializer":
    """An initializer by (class) name; an Initializer passes through."""
    if isinstance(name, Initializer):
        return name
    key = name.lower()
    return _INITIALIZER_REGISTRY[_ALIASES.get(key, key)](**kwargs)


class InitDesc(str):
    """Name + attrs descriptor passed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer(object):
    """Base initializer with the reference's name-pattern dispatch:
    ``*upsampling`` to a bilinear kernel, ``*bias`` and ``*beta`` to 0,
    ``*gamma`` to 1, ``*weight`` to the subclass's draw, the moving
    statistics ``*moving_mean``, ``*moving_inv_var`` and ``*moving_avg``
    to 0 and ``*moving_var`` to 1."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self._rng = None

    def set_rng(self, rng) -> "Initializer":
        """Draw from an explicit numpy ``Generator`` instead of the
        process-global ``np.random`` state. Returns ``self``."""
        self._rng = rng
        return self

    @property
    def rng(self):
        return self._rng if self._rng is not None else np.random

    def dumps(self) -> str:
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr: NDArray):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        if desc.attrs.get("__init__"):
            klass, kwargs = json.loads(desc.attrs["__init__"])
            create(klass, **kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("upsampling"):
            self._init_bilinear(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_inv_var"):
            self._init_zero(desc, arr)
        elif name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_bilinear(self, name, arr):
        """A bilinear upsampling kernel over the last two axes."""
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype=np.float32)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = nd.array(weight.reshape(shape), ctx=cpu())

    def _init_zero(self, name, arr):
        arr[:] = 0.0

    def _init_one(self, name, arr):
        arr[:] = 1.0

    def _init_bias(self, name, arr):
        arr[:] = 0.0

    def _init_gamma(self, name, arr):
        arr[:] = 1.0

    def _init_beta(self, name, arr):
        arr[:] = 0.0

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization "
            "is now limited to weight/bias/gamma/beta. Use "
            "sym.Variable(init=...) to set per-variable initializers."
            % name)


@register
class Load(object):
    """Initialize from a parameter dict (name -> array, or a file that
    ``nd.load`` reads; ``arg:`` / ``aux:`` prefixes dropped), and the
    names it lacks from ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            param = nd.load(param, ctx=cpu())
        self.param = {}
        for name, arr in param.items():
            if not isinstance(arr, NDArray):
                arr = np.asarray(arr)
                arr = nd.array(arr, ctx=cpu(), dtype=arr.dtype)
            self.param[name[4:] if name.startswith(("arg:", "aux:"))
                       else name] = arr
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if arr.shape != self.param[name].shape:
                raise ValueError("Parameter %s shape mismatch: %s vs %s"
                                 % (name, arr.shape, self.param[name].shape))
            arr[:] = self.param[name]
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise ValueError("Cannot Initialize %s. Not found in loaded "
                                 "param and no default initializer" % name)
            self.default_init(name, arr)


@register
class Mixed(object):
    """The first initializer whose regex pattern matches the name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must have same "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError("Parameter %s did not match any pattern. Consider "
                         "adding a \".*\" pattern at the end." % name)


class _FillInitializer(Initializer):
    """Fill with one value for any name (a per-variable ``init=`` attr
    still wins)."""

    _fill_value = 0.0

    def __call__(self, desc, arr):
        if isinstance(desc, InitDesc) and desc.attrs.get("__init__"):
            return Initializer.__call__(self, desc, arr)
        arr[:] = self._fill_value

    def _init_weight(self, name, arr):
        arr[:] = self._fill_value


@register
class Zero(_FillInitializer):
    _fill_value = 0.0


@register
class One(_FillInitializer):
    _fill_value = 1.0


@register
class Constant(_FillInitializer):
    """Fill with ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self._fill_value = value


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        arr[:] = nd.array(self.rng.uniform(-self.scale, self.scale,
                                            arr.shape).astype(np.float32),
                          ctx=cpu())


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        arr[:] = nd.array(self.rng.normal(0, self.sigma,
                                           arr.shape).astype(np.float32),
                          ctx=cpu())


@register
class Xavier(Initializer):
    """Uniform or gaussian over the avg / in / out fan."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to vector "
                             "%s. It requires at least 2D." % name)
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[:] = nd.array(self.rng.uniform(-scale, scale,
                                                shape).astype(np.float32),
                              ctx=cpu())
        elif self.rnd_type == "gaussian":
            arr[:] = nd.array(self.rng.normal(0, scale,
                                               shape).astype(np.float32),
                              ctx=cpu())
        else:
            raise ValueError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """He initialization for a PReLU of slope ``slope``: gaussian, with
    magnitude 2 / (1 + slope²)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel (a deconvolution's weight)."""

    def _init_weight(self, name, arr):
        self._init_bilinear(name, arr)


@register
class Orthogonal(Initializer):
    """An orthogonal matrix from the SVD of a uniform (or gaussian)
    draw, times ``scale``."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = self.rng.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = self.rng.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        arr[:] = nd.array(self.scale * res.reshape(arr.shape).astype(
            np.float32), ctx=cpu())


@register
class LSTMBias(Initializer):
    """An LSTM's bias: zero, except ``forget_bias`` on the forget gate
    (the second quarter, gate order i, f, c, o)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = nd.array(b, ctx=cpu())

    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """The fused RNN op's packed parameter vector: each weight block
    (W_x, W_h per layer and direction, in the packed order) drawn by
    ``init`` (default ``Xavier()``), the biases zero except, for an
    LSTM, ``forget_bias / 2`` on the forget gate of both b_x and b_h."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        super().__init__(init=init.dumps() if hasattr(init, "dumps")
                         else None, num_hidden=num_hidden,
                         num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init if init is not None else Xavier()
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .ops.rnn_op import _GATES
        gates = _GATES[self._mode]
        dirs = 2 if self._bidirectional else 1
        H = self._num_hidden
        total = arr.size
        # the layer-0 input size, solved from the total
        rest = (self._num_layers - 1) * dirs * gates * H * \
            (dirs * H + H + 2)
        input_size = (total - rest) // (dirs * gates * H) - H - 2
        out = np.zeros((total,), dtype=np.float32)
        p = 0
        for layer in range(self._num_layers):
            in_sz = input_size if layer == 0 else H * dirs
            for _ in range(dirs):
                for ni in (in_sz, H):
                    size = gates * H * ni
                    block = nd.zeros((gates * H, ni), ctx=cpu())
                    self._init(InitDesc(desc + "_weight", {}), block)
                    out[p:p + size] = block.asnumpy().ravel()
                    p += size
        for layer in range(self._num_layers):
            for _ in range(dirs):
                for _ in range(2):  # b_x, b_h
                    if self._mode == "lstm":
                        out[p + H:p + 2 * H] = self._forget_bias / 2.0
                    p += gates * H
        arr[:] = nd.array(out, ctx=cpu())
