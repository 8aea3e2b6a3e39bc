"""Convert NDArray checkpoints between the reference binary .params
layout and this framework's npz container (both readable by mx.nd.load).

Capability twin of the reference model-store tooling
(python/mxnet/gluon/model_zoo/model_store.py + the checkpoint formats of
model.save_checkpoint): existing MXNet .params files work here directly
(nd.load autodetects), and this tool re-encodes in either direction —
e.g. to ship a TPU-trained checkpoint back to a reference deployment.

The port's copy of the reference package's ``tools/convert_params.py``;
the arrays stay on the host.

  python -m mxnet_tpu_torch.tools.convert_params model.params out.npz
  python -m mxnet_tpu_torch.tools.convert_params ckpt.npz out.params \
      --format mxnet
  python -m mxnet_tpu_torch.tools.convert_params ckpt.params out.params \
      --strip-prefix
"""
import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="input checkpoint (.params binary or npz)")
    p.add_argument("dst", help="output path")
    p.add_argument("--format", choices=("npz", "mxnet"), default=None,
                   help="output container; default: mxnet for .params "
                        "destinations, npz otherwise")
    p.add_argument("--strip-prefix", action="store_true",
                   help="drop arg:/aux: key prefixes (module checkpoint "
                        "-> gluon-style flat names)")
    p.add_argument("--add-prefix", choices=("arg", "aux"), default=None,
                   help="prefix every key (flat names -> module-style)")
    args = p.parse_args(argv)

    from .. import ndarray as nd
    from ..context import cpu

    data = nd.load(args.src, ctx=cpu())
    if isinstance(data, list):
        if args.strip_prefix or args.add_prefix:
            p.error("prefix options need a named checkpoint")
    else:
        if args.strip_prefix:
            from ..ndarray.legacy_format import strip_arg_aux
            data = strip_arg_aux(data)
        if args.add_prefix:
            data = {"%s:%s" % (args.add_prefix, k): v
                    for k, v in data.items()}
    fmt = args.format or ("mxnet" if args.dst.endswith(".params")
                          else "npz")
    nd.save(args.dst, data, format=fmt)
    n = len(data)
    print("wrote %s (%d arrays, %s container)" % (args.dst, n, fmt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
