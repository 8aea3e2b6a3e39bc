"""The reference's single-card examples on the port.

Each module is a copy of ``examples/<name>.py`` on ``mxnet_tpu_torch``:
the same argparse defaults, data generator, net and gates, runnable as
``python -m mxnet_tpu_torch.examples.<name>`` on the card (``cuda:0``).
Each ``main(argv=None)`` returns the gated scores as a dict, after its
gates (:func:`.common.gate`, which raises :class:`.common.GateFailure`)
have passed. ``train_mnist`` and ``train_cifar10`` train through the
fit harness (:mod:`.common.fit`), which hands ``Module.fit`` a
``KVStore`` as the reference's does.

The examples draw their initial weights from numpy's global generator
(``np.random.seed``), as the reference's do, and their data from
``RandomState`` generators of their own; run them on the host only
inside ``with mt.cpu():``.
"""
