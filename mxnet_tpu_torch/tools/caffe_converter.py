"""Convert a Caffe deploy prototxt (+ optional weights) to a framework
checkpoint (symbol JSON + .params).

Capability twin of the reference's ``tools/caffe_converter`` for the
common deployment subset — without needing caffe or protobuf installed:
the prototxt text format is parsed directly, and weights arrive as an
``.npz`` (``{layer_name}_weight`` / ``{layer_name}_bias`` arrays, the
shape caffe stores: conv OIHW, inner-product (out, in) — both match this
framework's layouts, so no transposes are needed). BatchNorm+Scale pairs
use the symbol's own names instead: ``{bn_name}_gamma``/``{bn_name}_beta``
(from the Scale layer's blobs) and ``{bn_name}_moving_mean``/
``{bn_name}_moving_var`` (the BatchNorm layer's mean/variance blobs,
divided by its scale factor blob).

Supported layer types: Input/Data, Convolution, InnerProduct, Pooling
(MAX/AVE, incl. global), ReLU, Sigmoid, TanH, LRN, Dropout, Softmax,
SoftmaxWithLoss, Concat, Eltwise (SUM/MAX/PROD), Flatten, BatchNorm (+
the following Scale layer folded in).

Binary ``.caffemodel`` weights are read directly with a minimal
protobuf wire-format (varint) reader — no protobuf library: the
NetParameter message is scanned for ``layer`` (field 100,
LayerParameter: name=1, blobs=7) and legacy ``layers`` (field 2,
V1LayerParameter: name=4, blobs=6) entries; each BlobProto carries its
shape either as BlobShape dims (field 7) or legacy
num/channels/height/width (fields 1-4) and float data packed or
unpacked in field 5 (doubles in field 8). This mirrors the reference's
``tools/caffe_converter/convert_model.py``, which used compiled
protobuf classes for the same traversal.

The port's copy of the reference package's ``tools/caffe_converter.py``:
the symbol it builds is the port's, and the arrays it saves are staged on
the host (a converter needs no card).

  python -m mxnet_tpu_torch.tools.caffe_converter deploy.prototxt \
      out_prefix [--weights weights.npz | --caffemodel net.caffemodel]

Writes ``out_prefix-symbol.json`` (+ ``out_prefix-0000.params`` when
weights are given) — loadable by ``mt.mod.Module`` / ``mt.Predictor``
and by the reference package.
"""
import argparse
import re
import sys


# ------------------------------------------------------- prototxt parsing


def _tokenize(text):
    text = re.sub(r"#[^\n]*", "", text)
    return re.findall(r"[{}]|[A-Za-z_][\w.]*\s*:|\"[^\"]*\"|[^\s{}]+", text)


def parse_prototxt(text):
    """Parse protobuf text format into nested dicts; repeated fields
    become lists."""
    toks = _tokenize(text)
    pos = [0]

    def value(tok):
        if tok.startswith('"'):
            return tok[1:-1]
        try:
            return int(tok)
        except ValueError:
            pass
        try:
            return float(tok)
        except ValueError:
            pass
        if tok in ("true", "false"):
            return tok == "true"
        return tok                       # enum keyword (MAX, SUM, ...)

    def block():
        out = {}
        while pos[0] < len(toks):
            tok = toks[pos[0]]
            if tok == "}":
                pos[0] += 1
                return out
            if tok.endswith(":"):
                key = tok[:-1].strip()
                pos[0] += 1
                if toks[pos[0]] == "{":   # 'field: { ... }' message form
                    pos[0] += 1
                    v = block()
                else:
                    v = value(toks[pos[0]])
                    pos[0] += 1
            else:
                key = tok
                pos[0] += 1
                if toks[pos[0]] == "{":
                    pos[0] += 1
                v = block()
            if key in out:
                if not isinstance(out[key], list):
                    out[key] = [out[key]]
                out[key].append(v)
            else:
                out[key] = v
        return out

    return block()


def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _pair(param, base, default):
    """kernel_size/stride/pad with optional _h/_w variants."""
    if param.get(base + "_h") is not None:
        return (int(param[base + "_h"]), int(param[base + "_w"]))
    v = param.get(base)
    if v is None:
        return (default, default)
    if isinstance(v, list):
        v = v[0]
    return (int(v), int(v))


# ------------------------------------------------------- layer conversion


def convert(net_def, input_shape=None):
    """Build a Symbol from a parsed deploy net. Returns (symbol,
    input_shape)."""
    from .. import symbol as sym

    layers = _as_list(net_def.get("layer")) or _as_list(net_def.get("layers"))
    tops = {}
    in_shape = input_shape

    if "input" in net_def:          # classic "input:/input_dim:" header
        name = net_def["input"]
        name = name[0] if isinstance(name, list) else name
        tops[name] = sym.Variable("data")
        dims = [int(d) for d in _as_list(net_def.get("input_dim"))]
        if not dims and "input_shape" in net_def:
            dims = [int(d) for d in
                    _as_list(net_def["input_shape"].get("dim"))]
        if dims:
            in_shape = tuple(dims)

    def bottom(l):
        bots = _as_list(l.get("bottom"))
        return [tops[b] for b in bots]

    for l in layers:
        ltype = str(l.get("type"))
        name = str(l.get("name"))
        top_names = _as_list(l.get("top")) or [name]
        if ltype in ("Input", "Data"):
            tops[top_names[0]] = sym.Variable("data")
            shp = l.get("input_param", {}).get("shape", {})
            dims = [int(d) for d in _as_list(shp.get("dim"))]
            if dims:
                in_shape = tuple(dims)
            continue
        bots = bottom(l)
        x = bots[0] if bots else None
        if ltype == "Convolution":
            p = l.get("convolution_param", {})
            out = sym.Convolution(
                x, num_filter=int(p["num_output"]),
                kernel=_pair(p, "kernel_size", 1),
                stride=_pair(p, "stride", 1), pad=_pair(p, "pad", 0),
                num_group=int(p.get("group", 1)),
                no_bias=not p.get("bias_term", True), name=name)
        elif ltype == "InnerProduct":
            p = l.get("inner_product_param", {})
            out = sym.FullyConnected(
                x, num_hidden=int(p["num_output"]),
                no_bias=not p.get("bias_term", True), name=name)
        elif ltype == "Pooling":
            p = l.get("pooling_param", {})
            ptype = "avg" if str(p.get("pool", "MAX")) == "AVE" else "max"
            if p.get("global_pooling"):
                out = sym.Pooling(x, global_pool=True, pool_type=ptype,
                                     kernel=(1, 1), name=name)
            else:
                out = sym.Pooling(
                    x, kernel=_pair(p, "kernel_size", 1),
                    stride=_pair(p, "stride", 1), pad=_pair(p, "pad", 0),
                    pool_type=ptype,
                    pooling_convention="full",   # caffe ceil-mode windows
                    name=name)
        elif ltype == "ReLU":
            out = sym.Activation(x, act_type="relu", name=name)
        elif ltype == "Sigmoid":
            out = sym.Activation(x, act_type="sigmoid", name=name)
        elif ltype == "TanH":
            out = sym.Activation(x, act_type="tanh", name=name)
        elif ltype == "LRN":
            p = l.get("lrn_param", {})
            out = sym.LRN(x, nsize=int(p.get("local_size", 5)),
                             alpha=float(p.get("alpha", 1.0)),
                             beta=float(p.get("beta", 0.75)),
                             knorm=float(p.get("k", 1.0)), name=name)
        elif ltype == "Dropout":
            p = l.get("dropout_param", {})
            out = sym.Dropout(x, p=float(p.get("dropout_ratio", 0.5)),
                                 name=name)
        elif ltype in ("Softmax", "SoftmaxWithLoss"):
            out = sym.SoftmaxOutput(x, name="softmax")
        elif ltype == "Concat":
            out = sym.Concat(*bots, name=name)
        elif ltype == "Eltwise":
            p = l.get("eltwise_param", {})
            op = str(p.get("operation", "SUM"))
            out = bots[0]
            for b in bots[1:]:
                out = (out + b if op == "SUM" else
                       out * b if op == "PROD" else
                       sym.maximum(out, b))
        elif ltype == "Flatten":
            out = sym.Flatten(x, name=name)
        elif ltype == "BatchNorm":
            p = l.get("batch_norm_param", {})
            out = sym.BatchNorm(x, eps=float(p.get("eps", 1e-5)),
                                   use_global_stats=True, fix_gamma=False,
                                   name=name)
        elif ltype == "Scale":
            # caffe pairs BatchNorm with a Scale layer; the BatchNorm
            # symbol above already carries gamma/beta, so Scale is an
            # alias of its bottom
            out = x
        else:
            raise NotImplementedError(
                "caffe layer type %r (layer %r) is not supported by this "
                "converter" % (ltype, name))
        tops[top_names[0]] = out

    last = tops[_as_list(layers[-1].get("top"))[0]
                if layers[-1].get("top") else str(layers[-1]["name"])]
    return last, in_shape


# ------------------------------------------------- caffemodel wire reader


def _read_varint(buf, i):
    shift, out = 0, 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _iter_fields(buf, start=0, end=None):
    """Yield (field_number, wire_type, payload) over a protobuf message.
    wire types: 0 varint (payload int), 1 64-bit, 2 length-delimited,
    5 32-bit (payload bytes)."""
    i, end = start, len(buf) if end is None else end
    while i < end:
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError("unsupported protobuf wire type %d" % wt)
        yield fno, wt, v


def _parse_blob(buf):
    """BlobProto -> numpy array with its declared shape."""
    import numpy as np
    legacy = {}
    dims = None
    chunks = []
    for fno, wt, v in _iter_fields(buf):
        if fno in (1, 2, 3, 4) and wt == 0:
            legacy[fno] = v
        elif fno == 5:      # repeated float data (packed or not)
            chunks.append(np.frombuffer(v, "<f4"))
        elif fno == 8:      # repeated double data
            chunks.append(np.frombuffer(v, "<f8").astype(np.float32))
        elif fno == 7 and wt == 2:      # BlobShape
            dims = []
            for f2, w2, v2 in _iter_fields(v):
                if f2 != 1:
                    continue
                if w2 == 0:             # unpacked dim
                    dims.append(v2)
                else:                   # packed varints
                    j = 0
                    while j < len(v2):
                        d, j = _read_varint(v2, j)
                        dims.append(d)
    data = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    if dims is None and legacy:
        # keep legacy 4-D dims verbatim: stripping leading ones here
        # would corrupt e.g. a num_output=1 conv weight (1, C, kh, kw);
        # consumers that want flat views (InnerProduct, biases, BN
        # stats) reshape/ravel in caffemodel_weights
        dims = [legacy.get(k, 1) for k in (1, 2, 3, 4)]
    if dims:
        data = data.reshape([int(d) for d in dims])
    return data


def parse_caffemodel(raw):
    """Parse NetParameter bytes -> ordered list of
    ``(layer_name, [blob arrays])`` (new-style ``layer`` field 100 and
    legacy ``layers`` field 2 both supported)."""
    out = []
    for fno, wt, v in _iter_fields(raw):
        if wt != 2 or fno not in (2, 100):
            continue
        name_field, blob_field = (4, 6) if fno == 2 else (1, 7)
        name, blobs = None, []
        for f2, w2, v2 in _iter_fields(v):
            if f2 == name_field and w2 == 2:
                name = v2.decode("utf-8", "replace")
            elif f2 == blob_field and w2 == 2:
                blobs.append(_parse_blob(v2))
        if name is not None and blobs:
            out.append((name, blobs))
    return out


def caffemodel_weights(net_def, raw):
    """Map a parsed ``.caffemodel`` onto this converter's parameter
    names (the ``--weights`` npz convention): conv/IP blobs ->
    ``{name}_weight``/``{name}_bias``; BatchNorm mean/var (divided by
    the scale-factor blob) -> ``{name}_moving_mean``/``_moving_var``;
    a following Scale layer's blobs -> the BatchNorm's
    ``{bn}_gamma``/``{bn}_beta``."""
    import numpy as np
    blobs = dict(parse_caffemodel(raw))
    layers = _as_list(net_def.get("layer")) or _as_list(net_def.get("layers"))
    by_name = {str(l["name"]): l for l in layers}
    # Scale layers fold into the BatchNorm they follow (matched by
    # bottom, like convert() does)
    bn_of_top = {}
    for l in layers:
        if str(l.get("type")) == "BatchNorm":
            for top in _as_list(l.get("top", [])):
                bn_of_top[str(top)] = str(l["name"])
    out = {}
    for name, layer_blobs in blobs.items():
        ldef = by_name.get(name, {})
        ltype = str(ldef.get("type", ""))
        if ltype == "BatchNorm" or (not ldef and len(layer_blobs) == 3
                                    and layer_blobs[2].size == 1):
            mean, var = layer_blobs[0], layer_blobs[1]
            if len(layer_blobs) > 2 and layer_blobs[2].size == 1:
                sf = float(layer_blobs[2].ravel()[0])
                if sf != 0:
                    mean, var = mean / sf, var / sf
            out[name + "_moving_mean"] = mean.ravel()
            out[name + "_moving_var"] = var.ravel()
        elif ltype == "Scale":
            bn = bn_of_top.get(str(_as_list(ldef.get("bottom", []))[0]),
                               name)
            out[bn + "_gamma"] = layer_blobs[0].ravel()
            if len(layer_blobs) > 1:
                out[bn + "_beta"] = layer_blobs[1].ravel()
        else:
            w = layer_blobs[0]
            if ltype == "InnerProduct" and w.ndim > 2:
                w = w.reshape(w.shape[-2], w.shape[-1])
            out[name + "_weight"] = w
            if len(layer_blobs) > 1:
                out[name + "_bias"] = layer_blobs[1].ravel()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="caffe prototxt -> mx symbol")
    ap.add_argument("prototxt")
    ap.add_argument("out_prefix")
    wsrc = ap.add_mutually_exclusive_group()
    wsrc.add_argument("--weights", default=None,
                      help=".npz with {layer}_weight/{layer}_bias arrays")
    wsrc.add_argument("--caffemodel", default=None,
                      help="binary .caffemodel to read weights from "
                           "(varint-level protobuf reader, no caffe/"
                           "protobuf needed)")
    args = ap.parse_args(argv)

    import numpy as np
    from .. import ndarray as nd
    from ..context import cpu

    with open(args.prototxt) as f:
        net_def = parse_prototxt(f.read())
    sym, in_shape = convert(net_def)
    sym.save(args.out_prefix + "-symbol.json")
    print("wrote %s-symbol.json (input shape %s)"
          % (args.out_prefix, in_shape))

    arrays = None
    if args.weights:
        with np.load(args.weights) as z:
            arrays = {k: z[k] for k in z.files}
    elif args.caffemodel:
        with open(args.caffemodel, "rb") as f:
            arrays = caffemodel_weights(net_def, f.read())
        print("parsed %d parameter tensors from %s"
              % (len(arrays), args.caffemodel))

    if arrays is not None:
        blob, skipped = {}, []
        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        for k, v in arrays.items():
            if k in arg_names:
                blob["arg:" + k] = nd.array(v, ctx=cpu())
            elif k in aux_names:
                blob["aux:" + k] = nd.array(v, ctx=cpu())
            else:
                skipped.append(k)
        if skipped:
            print("  skipped %d arrays with no matching symbol arg: %s"
                  % (len(skipped), skipped[:6]))
            print("  (expected names: %s ...)"
                  % sorted(arg_names | aux_names)[:6])
        if not blob:
            ap.error("none of the npz arrays matched the symbol's "
                     "parameters — check the naming convention in the "
                     "module docstring")
        nd.save(args.out_prefix + "-0000.params", blob, format="mxnet")
        print("wrote %s-0000.params (%d tensors)"
              % (args.out_prefix, len(blob)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
