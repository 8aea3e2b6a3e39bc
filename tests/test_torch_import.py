"""The port stands alone: nothing in ``mxnet_tpu_torch`` or
``chip_smoke.py`` imports ``jax``, the reference package or
``ml_dtypes`` (which the machine with the card may not have).

Checked twice: dynamically (a fresh interpreter imports the port's
modules and must not have loaded either) and statically (an AST scan of
every import statement, which also covers imports inside functions that
the dynamic check never runs).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")


def _port_files():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import mxnet_tpu_torch\n"
        "import mxnet_tpu_torch.serve.server, mxnet_tpu_torch.serve.decode\n"
        "import mxnet_tpu_torch.serve.kv_cache\n"
        "import mxnet_tpu_torch.ops.flash_attention\n"
        "import mxnet_tpu_torch.models.transformer, mxnet_tpu_torch._build\n"
        "import mxnet_tpu_torch.amp, mxnet_tpu_torch.ndarray\n"
        "import mxnet_tpu_torch.ops, mxnet_tpu_torch.ops.nn\n"
        "import mxnet_tpu_torch.ops.matrix, mxnet_tpu_torch.ops.elemwise\n"
        "import mxnet_tpu_torch.ops.init_op, mxnet_tpu_torch.ops.indexing\n"
        "import mxnet_tpu_torch.ops.optimizer_op\n"
        "import mxnet_tpu_torch.symbol, mxnet_tpu_torch.executor\n"
        "import mxnet_tpu_torch.initializer, mxnet_tpu_torch.optimizer\n"
        "import mxnet_tpu_torch.random\n"
        "import mxnet_tpu_torch.model, mxnet_tpu_torch.models.resnet\n"
        "import mxnet_tpu_torch.ndarray.legacy_format\n"
        "import mxnet_tpu_torch.io, mxnet_tpu_torch.metric\n"
        "import mxnet_tpu_torch.module, mxnet_tpu_torch.module.base_module\n"
        "from mxnet_tpu_torch.module import Module\n"
        "from mxnet_tpu_torch.serve import GenerativeServer\n"
        "import mxnet_tpu_torch.rtc, mxnet_tpu_torch.rtc_examples\n"
        "import mxnet_tpu_torch.operator, mxnet_tpu_torch.contrib\n"
        "import mxnet_tpu_torch.contrib.ndarray\n"
        "import mxnet_tpu_torch.contrib.symbol\n"
        "import mxnet_tpu_torch.autograd, mxnet_tpu_torch.gluon\n"
        "import mxnet_tpu_torch.gluon.nn, mxnet_tpu_torch.gluon.loss\n"
        "import mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.gluon.utils\n"
        "import mxnet_tpu_torch.gluon.data, mxnet_tpu_torch.ops.reduce\n"
        "from mxnet_tpu_torch.gluon.model_zoo import vision\n"
        "import mxnet_tpu_torch.rnn, mxnet_tpu_torch.rnn.io\n"
        "import mxnet_tpu_torch.rnn.rnn_cell, mxnet_tpu_torch.callback\n"
        "import mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.gluon.rnn.rnn_layer\n"
        "import mxnet_tpu_torch.ops.rnn_op, mxnet_tpu_torch.ops.sequence\n"
        "from mxnet_tpu_torch.module import BucketingModule\n"
        "import mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.lr_scheduler\n"
        "import mxnet_tpu_torch.checkpoint.manager\n"
        "assert mxnet_tpu_torch.rnn.BucketSentenceIter\n"
        "assert mxnet_tpu_torch.gluon.rnn.LSTM and mxnet_tpu_torch.callback\n"
        "import mxnet_tpu_torch._cuda_driver as driver\n"
        "assert driver._lib is None   # libcuda loads at first use only\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'mxnet_tpu',\n"
        "                                    'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print('PORT-IMPORT-OK')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert "PORT-IMPORT-OK" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:          # relative: stays inside the port
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                "%s:%d imports %s" % (path.name, node.lineno, name)
