"""``mt.predictor`` — the minimal deployment / inference API.

The port of the reference package's ``predictor.py`` (itself the C
predict API, ``include/mxnet/c_predict_api.h:77-178``): load a symbol
JSON and a parameter blob, bind a forward-only executor, then
``set_input -> forward -> get_output``. ``reshape`` rebinds for a new
input geometry as ``MXPredReshape`` does.

:meth:`Predictor.export` writes the forward program as one
self-contained zip: a ``torch.export`` program in place of the
reference's StableHLO, the frozen weights as an npz and a manifest. The
artifact runs without this package: ``mxnet_tpu_torch/tools/
predict_exported.py`` needs only torch and numpy. A graph that reaches
one of the port's hand-written kernels (FlashAttention, a ``Custom``
op, an ``rtc`` kernel) cannot be exported: those are called through
``ctypes`` or Python, which ``torch.export`` does not trace, and
exporting their plain versions would compute something other than
``forward`` does on the card. ``export`` raises for them.

For concurrent traffic, serve a Predictor through
``mt.serve.InferenceServer``.
"""
from __future__ import annotations

import io
import json
import time
from typing import List

import numpy as np
import torch

from . import ndarray as nd
from .base import MXNetError
from .context import DeviceLike, resolve_device
from .symbol import load_json

__all__ = ["Predictor", "EXPORT_FORMAT"]

EXPORT_FORMAT = "mxnet_tpu_torch.exported/1"

# ops that run a kernel outside torch's op set: export cannot trace them
_KERNEL_OPS = {"FlashAttention": "the flash-attention kernels",
               "Custom": "a Python CustomOp"}


class Predictor(object):
    """Forward-only model runner (reference: MXPredCreate semantics).

    Parameters
    ----------
    symbol_json : str
        Symbol JSON string (or a path ending in ``.json``).
    params : dict | str | bytes
        ``{name: array}`` dict, or a path / byte blob in the ``nd.save``
        container format with ``arg:``/``aux:`` prefixed keys (the
        checkpoint format ``model.save_checkpoint`` writes).
    input_shapes : dict | list of (name, shape)
        Shapes of every input that is not a parameter.
    ctx : Context, optional
        The card (``cuda:0``) by default, and raises without a GPU; the
        CPU only when asked for.
    """

    def __init__(self, symbol_json, params, input_shapes,
                 ctx: DeviceLike = None):
        self._ctx = resolve_device(ctx)
        if isinstance(symbol_json, str) and symbol_json.endswith(".json"):
            from . import filesystem as _fs
            with _fs.open_uri(symbol_json, "r") as path:
                with open(path) as f:
                    symbol_json = f.read()
        self._symbol = load_json(symbol_json)
        self._arg_params, self._aux_params = self._load_params(params)
        self._input_shapes = dict(input_shapes)
        self._bind()

    @staticmethod
    def _load_params(params):
        """Split a params source into (arg_params, aux_params), host-side
        (reference: c_predict_api.cc param-blob parsing of arg:/aux:
        prefixed names)."""
        if isinstance(params, (bytes, bytearray)):
            import tempfile
            with tempfile.NamedTemporaryFile(suffix=".params") as f:
                f.write(params)
                f.flush()
                loaded = nd.load(f.name, ctx="cpu")
        elif isinstance(params, str):
            from . import filesystem as _fs
            with _fs.open_uri(params, "rb") as path:
                loaded = nd.load(path, ctx="cpu")
        else:
            loaded = {k: (v if isinstance(v, nd.NDArray)
                          else nd.array(np.asarray(v), ctx="cpu"))
                      for k, v in params.items()}
        arg_params, aux_params = {}, {}
        for k, v in loaded.items():
            if k.startswith("arg:"):
                arg_params[k[4:]] = v
            elif k.startswith("aux:"):
                aux_params[k[4:]] = v
            else:
                arg_params[k] = v
        return arg_params, aux_params

    def _bind(self):
        sym = self._symbol
        # args that are neither params nor declared inputs are zero-filled
        # if their shape infers (checkpoints keep the loss head, so e.g.
        # softmax_label rides along; forward ignores it)
        missing = [n for n in sym.list_arguments()
                   if n not in self._arg_params
                   and n not in self._input_shapes]
        hard = [n for n in missing if not n.endswith("label")]
        if hard:
            raise ValueError(
                "Predictor: arguments %s are neither params nor declared "
                "inputs" % hard)
        shapes = dict(self._input_shapes)
        shapes.update({k: v.shape for k, v in self._arg_params.items()
                       if k in sym.list_arguments()})
        try:
            arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
        except Exception as exc:                            # noqa: BLE001
            raise ValueError(
                "Predictor: cannot infer shapes%s: %s"
                % (" (arguments %s are neither params nor declared inputs)"
                   % missing if missing else "", exc)) from None
        args = {}
        for name, shp in zip(sym.list_arguments(), arg_shapes):
            if name in self._arg_params:
                args[name] = self._arg_params[name].copyto(self._ctx)
            else:
                args[name] = nd.zeros(shp, ctx=self._ctx)
        aux = {}
        for name, shp in zip(sym.list_auxiliary_states(), aux_shapes):
            aux[name] = (self._aux_params[name].copyto(self._ctx)
                         if name in self._aux_params
                         else nd.zeros(shp, ctx=self._ctx))
        self._exec = sym.bind(self._ctx, args=args, aux_states=aux,
                              grad_req="null")

    # ------------------------------------------------------------ predict
    def set_input(self, name: str, value) -> "Predictor":
        """(reference: MXPredSetInput)."""
        if name not in self._input_shapes:
            raise KeyError("unknown input %r (declared: %s)"
                           % (name, sorted(self._input_shapes)))
        arr = value if isinstance(value, (nd.NDArray, torch.Tensor)) \
            else np.asarray(value)
        want = tuple(self._input_shapes[name])
        if tuple(arr.shape) != want:
            raise ValueError("input %r has shape %s, predictor bound for %s"
                             " (use reshape())" % (name, tuple(arr.shape),
                                                  want))
        self._exec.arg_dict[name][:] = arr
        return self

    def forward(self, **inputs) -> List[nd.NDArray]:
        """Run the forward program; keyword inputs are a shorthand for
        set_input (reference: MXPredForward)."""
        for k, v in inputs.items():
            self.set_input(k, v)
        return self._exec.forward(is_train=False)

    def get_output(self, index: int) -> nd.NDArray:
        """(reference: MXPredGetOutput)."""
        return self._exec.outputs[index]

    @property
    def outputs(self) -> List[nd.NDArray]:
        return self._exec.outputs

    def reshape(self, input_shapes) -> "Predictor":
        """Rebind for new input geometry (reference: MXPredReshape)."""
        self._input_shapes = dict(input_shapes)
        self._bind()
        return self

    # ------------------------------------------------------------ export
    def _check_exportable(self) -> None:
        from .symbol.symbol import _topo_order
        for node in _topo_order(self._symbol._entries):
            if node.is_variable:
                continue
            what = _KERNEL_OPS.get(node.op.name) or \
                getattr(node.op, "user_kernel", None)
            if what:
                raise MXNetError(
                    "Predictor.export: node %r runs op %s (%s), which "
                    "torch.export cannot trace; an artifact of its plain "
                    "version would compute something other than forward()"
                    % (node.name, node.op.name, what))

    def export(self, path: str) -> str:
        """Serialize the forward program as one self-contained zip: a
        ``torch.export`` program (``program.pt2``) taking the frozen
        weights and then the inputs as arguments, the weights
        (``weights.npz``: arguments and aux states, in the manifest's
        ``weights`` order) and ``manifest.json``. The write is atomic
        (a temporary file renamed over ``path``). The manifest's
        ``tf32`` records this process's TF32 switches (cuBLAS and cuDNN),
        which the loader applies on the card. The artifact runs
        without this framework through
        ``mxnet_tpu_torch/tools/predict_exported.py`` (torch and numpy
        only), on the manifest's ``device`` or another one.

        Raises :class:`MXNetError` for a graph that reaches a
        hand-written kernel (FlashAttention, ``Custom``, ``rtc``)."""
        import zipfile

        from . import filesystem as _fs
        from .checkpoint.atomic import atomic_open
        from .executor import graph_function

        from .obs import compiles as _obs_compiles
        self._check_exportable()
        sym = self._symbol
        t_trace = time.perf_counter()
        fn = graph_function(sym)
        trace_ms = (time.perf_counter() - t_trace) * 1e3
        ex = self._exec
        arg_names = list(sym.list_arguments())
        input_names = [n for n in arg_names if n in self._input_shapes]
        params = [n for n in arg_names if n not in self._input_shapes]
        aux_names = list(sym.list_auxiliary_states())
        weight_names = params + aux_names
        device = self._ctx
        frozen = [ex.arg_dict[n].data for n in params] + \
            [ex.aux_dict[n].data for n in aux_names]
        examples = tuple(frozen) + tuple(ex.arg_dict[n].data
                                         for n in input_names)
        n_p, n_w = len(params), len(weight_names)

        class _Forward(torch.nn.Module):
            # the forward as a pure function of (weights, inputs): the
            # weights are arguments, not captured constants
            def forward(self, *flat):
                args = dict(zip(params, flat[:n_p]))
                args.update(zip(input_names, flat[n_w:]))
                aux = dict(zip(aux_names, flat[n_p:n_w]))
                outs, _ = fn(args, aux, False, device)
                return tuple(outs)

        # the export is the artifact's compile: graph function as
        # trace_ms, torch.export's wall time as compile_ms, under the
        # scope "export"
        with _obs_compiles.scope("export", path):
            t_export = time.perf_counter()
            with torch.no_grad():
                program = torch.export.export(_Forward(), examples)
            _obs_compiles.record((time.perf_counter() - t_export) * 1e3,
                                 trace_ms, source="export")
        # the example inputs are the weights themselves (weights.npz
        # carries them): saved in the program too, they would double it
        program.example_inputs = None
        pt2 = io.BytesIO()
        torch.export.save(program, pt2)
        weights = io.BytesIO()
        np.savez(weights, **{n: t.detach().cpu().numpy()
                             for n, t in zip(weight_names, frozen)})
        manifest = {
            "format": EXPORT_FORMAT,
            "weights": weight_names,
            "inputs": input_names,
            "input_shapes": {n: list(self._input_shapes[n])
                             for n in input_names},
            "input_dtypes": {n: str(ex.arg_dict[n].data.dtype)
                             .replace("torch.", "") for n in input_names},
            "num_outputs": len(sym.list_outputs()),
            "device": str(device),
            # the precision forward() ran at here: the loader applies it,
            # so the artifact computes what forward computes on the card
            "tf32": {"matmul": bool(torch.backends.cuda.matmul.allow_tf32),
                     "cudnn": bool(torch.backends.cudnn.allow_tf32)},
            "torch": torch.__version__,
        }
        with _fs.open_uri(path, "w") as local:
            # atomic: the zip grows in a fsynced temporary file renamed
            # over the target, so a crash mid-export cannot leave a torn
            # artifact at the final name
            with atomic_open(local, "wb") as fobj:
                with zipfile.ZipFile(fobj, "w") as z:
                    z.writestr("manifest.json",
                               json.dumps(manifest, indent=1))
                    z.writestr("program.pt2", pt2.getvalue())
                    z.writestr("weights.npz", weights.getvalue())
        return path

    # ------------------------------------------------------------ loaders
    @classmethod
    def from_checkpoint(cls, prefix: str, epoch: int, input_shapes,
                        ctx: DeviceLike = None) -> "Predictor":
        """Load ``prefix-symbol.json`` + ``prefix-%04d.params`` (the
        Module/model checkpoint layout, reference model.py:370). The
        prefix may be a remote URI (s3://...): both files stage through
        ``mt.filesystem``."""
        return cls("%s-symbol.json" % prefix,
                   "%s-%04d.params" % (prefix, epoch),
                   input_shapes, ctx=ctx)

