"""Pretrained-checkpoint loading for the vision zoo factories.

``pretrained``: ``True`` (the reference's download from its model store)
raises; a path loads local weights — either package's ``save_params``
output or a binary ``.params`` file (``arg:``/``aux:`` module prefixes
stripped; name-scope instance counters matched by the suffix after the
names' common prefix).
"""
from __future__ import annotations

import os.path

__all__ = ["finish_pretrained"]


def _suffix_map(names):
    """Map name-scope-stripped suffixes to full names: cut the shared
    prefix at its last underscore, so 'squeezenet0_conv2d0_weight' and
    'squeezenet1_conv2d0_weight' meet at 'conv2d0_weight' (Gluon saves
    full prefixed names; instance counters differ between runs). Every
    name shares its first ``cut`` characters, so distinct names keep
    distinct suffixes."""
    names = list(names)
    cut = os.path.commonprefix(names).rfind("_") + 1
    return {n[cut:]: n for n in names}


def finish_pretrained(net, pretrained):
    """Apply the ``pretrained`` argument to a freshly built net."""
    if not pretrained:
        return net
    if pretrained is True:
        raise ValueError(
            "pretrained=True needs the reference's download store, which "
            "is not available; pass a checkpoint path "
            "(pretrained='/path/model.params')")
    from ....context import cpu
    from .... import ndarray as nd
    from ....ndarray.legacy_format import strip_arg_aux
    data = nd.load(pretrained, ctx=cpu())
    if isinstance(data, list):
        raise ValueError(
            "pretrained file %r holds an unnamed array list; a named "
            "parameter dict is required" % pretrained)
    data = strip_arg_aux(data)
    params = net.collect_params()
    by_suffix = net_suffix = None
    for name in params.keys():
        src = name
        if src not in data:
            if by_suffix is None:
                by_suffix = _suffix_map(data.keys())
                net_suffix = {n: s for s, n in
                              _suffix_map(params.keys()).items()}
            src = by_suffix.get(net_suffix.get(name))
            if src is None:
                raise ValueError(
                    "Parameter %s missing in pretrained file %r "
                    "(has e.g. %s)" % (name, pretrained,
                                       sorted(data)[:3]))
        params[name]._load_init(data[src], None)
    return net
