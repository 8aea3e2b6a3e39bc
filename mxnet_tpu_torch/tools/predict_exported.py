"""Run a ``Predictor.export()`` artifact with nothing but torch and numpy.

The deployment half of the amalgamation story (the reference ships a
single-file predict-only build, amalgamation/Makefile +
c_predict_api.h): the artifact zip holds a ``torch.export`` program,
the frozen weights and a manifest. No framework import happens here:
run this file by path, not as a module of the package.

  python mxnet_tpu_torch/tools/predict_exported.py model.mxprog \\
      --input data=batch.npy
  python mxnet_tpu_torch/tools/predict_exported.py model.mxprog   # random
  python mxnet_tpu_torch/tools/predict_exported.py model.mxprog --device cpu
  python mxnet_tpu_torch/tools/predict_exported.py model.mxprog --save out.npz

The program runs on the manifest's device (where it was exported), or
on ``--device``. On the card it runs with the TF32 switches of the
exporting process, which the manifest records (float32 when it records
none), and restores the caller's after each call.
"""
import argparse
import io
import json
import sys
import time
import zipfile

import numpy as np
import torch

FORMAT = "mxnet_tpu_torch.exported/1"


def precision(manifest):
    """The exporting process's TF32 switches, ``{"matmul": bool,
    "cudnn": bool}``; both off (float32) when the manifest has none."""
    tf32 = manifest.get("tf32") or {}
    return {"matmul": bool(tf32.get("matmul", False)),
            "cudnn": bool(tf32.get("cudnn", False))}


def load_artifact(path, device=None):
    """Returns (call, manifest): ``call(**inputs) -> list of np arrays``,
    on ``device`` (default: the manifest's)."""
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json"))
        if manifest.get("format") != FORMAT:
            raise ValueError("not a mxnet_tpu_torch export artifact: %s"
                             % path)
        program = torch.export.load(io.BytesIO(z.read("program.pt2")))
        with np.load(io.BytesIO(z.read("weights.npz"))) as wz:
            weights = {k: wz[k] for k in wz.files}
    dev = torch.device(device or manifest["device"])
    if dev != torch.device(manifest["device"]):
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
    forward = program.module()
    flat_w = [torch.from_numpy(weights[n]).to(dev)
              for n in manifest["weights"]]

    tf32 = precision(manifest)

    def call(**inputs):
        missing = [n for n in manifest["inputs"] if n not in inputs]
        if missing:
            raise ValueError("missing inputs: %s" % missing)
        flat = flat_w + [torch.as_tensor(np.asarray(inputs[n])).to(dev)
                         for n in manifest["inputs"]]
        switches = (torch.backends.cuda.matmul, torch.backends.cudnn)
        saved = [s.allow_tf32 for s in switches]
        try:
            if dev.type == "cuda":
                for s, key in zip(switches, ("matmul", "cudnn")):
                    s.allow_tf32 = tf32[key]
            with torch.no_grad():
                outs = forward(*flat)
            return [o.cpu().numpy() for o in outs]
        finally:
            for s, on in zip(switches, saved):
                s.allow_tf32 = on

    return call, manifest


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("artifact")
    p.add_argument("--input", action="append", default=[],
                   metavar="name=path.npy",
                   help="input tensor from an .npy file; unspecified "
                        "inputs get seeded random data")
    p.add_argument("--device", default=None,
                   help="run on this torch device (default: the "
                        "manifest's)")
    p.add_argument("--save", default=None, metavar="out.npz",
                   help="also write the outputs, as output_0, output_1, "
                        "..., to this npz")
    args = p.parse_args()

    t0 = time.perf_counter()
    call, manifest = load_artifact(args.artifact, args.device)
    tf32 = precision(manifest)
    print("loaded %s in %.3f s, device %s, tf32 matmul %s cudnn %s" % (
        args.artifact, time.perf_counter() - t0,
        args.device or manifest["device"],
        "on" if tf32["matmul"] else "off", "on" if tf32["cudnn"] else "off"))
    feeds = {}
    for spec in args.input:
        name, path = spec.split("=", 1)
        feeds[name] = np.load(path)
    rng = np.random.RandomState(0)
    for name in manifest["inputs"]:
        if name not in feeds:
            feeds[name] = rng.uniform(
                -1, 1, manifest["input_shapes"][name]).astype(np.float32)
    t0 = time.perf_counter()
    outs = call(**feeds)
    print("ran in %.3f s" % (time.perf_counter() - t0))
    for i, o in enumerate(outs):
        print("output[%d] shape=%s dtype=%s mean=%.6f" %
              (i, o.shape, o.dtype, float(np.mean(o))))
    if args.save:
        np.savez(args.save, **{"output_%d" % i: o
                               for i, o in enumerate(outs)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
