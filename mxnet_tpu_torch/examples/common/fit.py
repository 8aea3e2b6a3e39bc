"""The training-CLI harness of the image-classification examples.

A copy of the reference's ``examples/common/fit.py`` on the port: the
same flags and defaults (:func:`add_fit_args`), the same lr steps
(:func:`_lr_scheduler`), and :func:`fit`, which makes a ``KVStore`` from
``--kv-store`` before anything else and hands it to ``Module.fit``.

Unlike the reference, :func:`_contexts` never falls back to the CPU:
``--gpus`` names cards, and without it the module runs on the current
context, the card unless the caller entered ``with mt.cpu():``; with no
card and no such request it raises.
"""
from __future__ import annotations

import logging

import mxnet_tpu_torch as mt


def add_fit_args(parser):
    """The reference's training flags, under its names."""
    train = parser.add_argument_group("Training")
    train.add_argument("--network", type=str, default="mlp")
    train.add_argument("--num-epochs", type=int, default=10)
    train.add_argument("--lr", type=float, default=0.05)
    train.add_argument("--lr-factor", type=float, default=0.1)
    train.add_argument("--lr-step-epochs", type=str, default="")
    train.add_argument("--optimizer", type=str, default="sgd")
    train.add_argument("--mom", type=float, default=0.9)
    train.add_argument("--wd", type=float, default=1e-4)
    train.add_argument("--batch-size", type=int, default=64)
    train.add_argument("--disp-batches", type=int, default=20,
                       help="Speedometer frequency")
    train.add_argument("--model-prefix", type=str, default=None,
                       help="checkpoint path prefix")
    train.add_argument("--load-epoch", type=int, default=None,
                       help="resume from this checkpoint epoch")
    train.add_argument("--kv-store", type=str, default="local")
    train.add_argument("--gpus", type=str, default=None,
                       help="card ids, e.g. '0,1'")
    train.add_argument("--monitor", type=int, default=0,
                       help="monitor stats every N batches")
    train.add_argument("--top-k", type=int, default=0)
    return train


def _contexts(args):
    if args.gpus:
        return [mt.gpu(int(i)) for i in args.gpus.split(",")]
    return [mt.current_context()]


def _lr_scheduler(args, steps_per_epoch, kv):
    if not args.lr_step_epochs:
        return args.lr, None
    epochs = [int(e) for e in args.lr_step_epochs.split(",") if e]
    begin = args.load_epoch or 0
    lr = args.lr
    for e in epochs:
        if begin >= e:
            lr *= args.lr_factor
    steps = [steps_per_epoch * max(e - begin, 1) for e in epochs
             if e > begin]
    if not steps:
        return lr, None
    return lr, mt.lr_scheduler.MultiFactorScheduler(
        step=steps, factor=args.lr_factor)


def fit(args, network, data_loader, **kwargs):
    """Train ``network`` on the iterators ``data_loader(args, kv)``
    returns; the trained module."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")
    kv = mt.kv.create(args.kv_store)
    train, val = data_loader(args, kv)

    devs = _contexts(args)
    # the lr steps count batches of the iterator's own size
    # (--num-examples when it cannot tell)
    n_examples = getattr(train, "num_data", 0) or \
        getattr(args, "num_examples", 0)
    epoch_size = max(n_examples // args.batch_size, 1)
    lr, lr_sched = _lr_scheduler(args, epoch_size, kv)

    checkpoint = None
    arg_params = aux_params = None
    begin_epoch = 0
    if args.model_prefix:
        checkpoint = mt.callback.do_checkpoint(args.model_prefix)
        if args.load_epoch is not None:
            network, arg_params, aux_params = mt.model.load_checkpoint(
                args.model_prefix, args.load_epoch)
            begin_epoch = args.load_epoch

    optimizer_params = {"learning_rate": lr, "wd": args.wd}
    if args.optimizer in ("sgd", "nag"):
        optimizer_params["momentum"] = args.mom
    if lr_sched is not None:
        optimizer_params["lr_scheduler"] = lr_sched

    eval_metric = ["accuracy"]
    if args.top_k > 0:
        eval_metric.append(mt.metric.create("top_k_accuracy",
                                            top_k=args.top_k))

    monitor = mt.mon.Monitor(args.monitor, pattern=".*") \
        if args.monitor > 0 else None

    mod = mt.mod.Module(symbol=network, context=devs)
    mod.fit(train, eval_data=val,
            eval_metric=eval_metric,
            optimizer=args.optimizer,
            optimizer_params=optimizer_params,
            initializer=mt.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            arg_params=arg_params, aux_params=aux_params,
            begin_epoch=begin_epoch, num_epoch=args.num_epochs,
            kvstore=kv,
            batch_end_callback=mt.callback.Speedometer(args.batch_size,
                                                       args.disp_batches),
            epoch_end_callback=checkpoint,
            monitor=monitor,
            **kwargs)
    return mod
