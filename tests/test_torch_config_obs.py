"""The port's knob layer against the reference's ``tests/test_config.py``:
``describe``, ``snapshot_overrides`` / ``restore_overrides``, the
observability knobs (``MXNET_TPU_OBS*``, ``MXNET_PROFILER_AUTOSTART``)
with the reference's parsers, defaults and ``on_change`` hooks, and
the list of the reference's knobs the port does not have yet, each
named with the queue item that brings it.

Every test restores each override it sets, so none depends on the order
the tests run in.
"""
import os
import subprocess
import sys

import pytest
import torch

from mxnet_tpu import config as jcfg
from mxnet_tpu_torch import config as cfg
from mxnet_tpu_torch import profiler

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's knobs that arrive with later items of the port
# (ROADMAP.md queue A), each with the item
NOT_YET = {
    # A9: parallelism, distribution, the pod runtime
    "MXNET_KVSTORE_HEARTBEAT_STALE_SECS": "A9",
    "MXNET_KVSTORE_BIGARRAY_BOUND": "A9",
    "MXNET_TPU_DIST_TIMEOUT": "A9",
    "MXNET_TPU_DIST_RETRIES": "A9",
    "MXNET_TPU_HEARTBEAT_PERIOD": "A9",
    "MXNET_TPU_CKPT_POD_TIMEOUT": "A9",
    "MXNET_TPU_KV_RETRIES": "A9",
    "MXNET_TPU_PROBE_TIMEOUT": "A9",
    "MXNET_TPU_PROBE_ATTEMPTS": "A9",
    "MXNET_TPU_FAILOVER_PORT": "A9",
    "MXNET_TPU_ANALYZE_ICI_GBPS": "A9",
    "MXNET_TPU_OBS_STRAGGLER_RATIO": "A9",
    # A9: the pod coordinator's stall watchdog and drain
    "MXNET_TPU_ELASTIC_STALL_SECS": "A9",
    "MXNET_TPU_ELASTIC_DRAIN_GRACE": "A9",
    # A4d-c: the AOT executable cache
    "MXNET_TPU_COMPILE_CACHE": "A4d-c",
    "MXNET_COMPILATION_CACHE_DIR": "A4d-c",
}

OBS_KNOBS = ("MXNET_TPU_OBS", "MXNET_TPU_OBS_METRICS_PORT",
             "MXNET_TPU_OBS_PEAK_FLOPS", "MXNET_TPU_OBS_BLACKBOX",
             "MXNET_TPU_OBS_BLACKBOX_RING",
             "MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS", "MXNET_PROFILER_AUTOSTART")


def test_describe_lists_the_reference_knobs_but_the_later_items():
    txt = cfg.describe()
    for name in cfg.KNOBS:
        assert name in txt
    missing = sorted(set(jcfg.KNOBS) - set(cfg.KNOBS))
    assert missing == sorted(NOT_YET), (
        "knobs of the reference the port lacks, beyond the named later "
        "items: %s; named but present: %s"
        % (sorted(set(missing) - set(NOT_YET)),
           sorted(set(NOT_YET) - set(missing))))
    # the port's own knobs: the data loader's deadline for a worker
    # that is alive but delivers nothing (the reference waits forever)
    assert sorted(set(cfg.KNOBS) - set(jcfg.KNOBS)) == \
        ["MXNET_TPU_DATA_TIMEOUT"]


@pytest.mark.parametrize("name", OBS_KNOBS)
def test_obs_knob_defaults_and_parsers_match_the_reference(name,
                                                           monkeypatch):
    assert cfg.get(name) == jcfg.get(name)
    samples = {"MXNET_TPU_OBS": ("1", "0", "yes", "off"),
               "MXNET_PROFILER_AUTOSTART": ("true", "0"),
               "MXNET_TPU_OBS_METRICS_PORT": ("0", "9100", "-1"),
               "MXNET_TPU_OBS_PEAK_FLOPS": ("1e9", "0"),
               "MXNET_TPU_OBS_BLACKBOX": ("/tmp/bb", ""),
               "MXNET_TPU_OBS_BLACKBOX_RING": ("64",),
               "MXNET_TPU_OBS_BLACKBOX_FLUSH_SECS": ("0.5", "0")}[name]
    for raw in samples:
        monkeypatch.setenv(name, raw)
        assert cfg.get(name) == jcfg.get(name), raw


def test_describe_names_the_source_of_each_value(monkeypatch):
    snap = cfg.snapshot_overrides(["MXNET_TPU_OBS_BLACKBOX_RING",
                                   "MXNET_PREFETCH_BUFFER"])
    try:
        monkeypatch.setenv("MXNET_PREFETCH_BUFFER", "9")
        cfg.set("MXNET_TPU_OBS_BLACKBOX_RING", 64)
        lines = {ln.split()[0]: ln for ln in cfg.describe().splitlines()}
        assert "(override)" in lines["MXNET_TPU_OBS_BLACKBOX_RING"]
        assert "(env)" in lines["MXNET_PREFETCH_BUFFER"]
        assert "(default)" in lines["MXNET_TPU_OBS_PEAK_FLOPS"]
    finally:
        cfg.restore_overrides(snap)


def test_snapshot_restore_overrides_scopes_sets(monkeypatch):
    """An override set inside the scope is undone, an override that was
    there before comes back, and a knob that had none reads the
    environment again — the environment change made inside the scope
    shows through."""
    names = ["MXNET_TPU_OBS_PEAK_FLOPS", "MXNET_TPU_OBS_BLACKBOX_RING"]
    outer = cfg.snapshot_overrides(names)
    try:
        cfg.set("MXNET_TPU_OBS_BLACKBOX_RING", 32)      # pre-existing
        snap = cfg.snapshot_overrides(names)
        cfg.set("MXNET_TPU_OBS_PEAK_FLOPS", 5.0)
        cfg.set("MXNET_TPU_OBS_BLACKBOX_RING", 128)
        monkeypatch.setenv("MXNET_TPU_OBS_PEAK_FLOPS", "7")
        assert cfg.get("MXNET_TPU_OBS_PEAK_FLOPS") == 5.0
        cfg.restore_overrides(snap)
        assert cfg.get("MXNET_TPU_OBS_BLACKBOX_RING") == 32
        assert cfg.get("MXNET_TPU_OBS_PEAK_FLOPS") == 7.0
        assert "MXNET_TPU_OBS_PEAK_FLOPS" not in cfg._overrides
    finally:
        cfg.restore_overrides(outer)
    assert "MXNET_TPU_OBS_BLACKBOX_RING" not in cfg._overrides


def test_snapshot_restore_runs_the_on_change_hooks():
    """``MXNET_TPU_OBS`` keeps the profiler's cached span flag honest
    through set, reset and a restore."""
    snap = cfg.snapshot_overrides(["MXNET_TPU_OBS"])
    try:
        assert not profiler.spans_enabled()
        cfg.set("MXNET_TPU_OBS", 1)
        assert profiler.spans_enabled()
        cfg.restore_overrides(snap)
        assert not profiler.spans_enabled()
        assert profiler.span("x") is profiler.span("y")
    finally:
        cfg.restore_overrides(snap)


def test_config_env_override_precedence(monkeypatch):
    assert cfg.get("MXNET_PREFETCH_BUFFER") == 4
    monkeypatch.setenv("MXNET_PREFETCH_BUFFER", "9")
    assert cfg.get("MXNET_PREFETCH_BUFFER") == 9
    cfg.set("MXNET_PREFETCH_BUFFER", 3)
    try:
        assert cfg.get("MXNET_PREFETCH_BUFFER") == 3
    finally:
        cfg.reset("MXNET_PREFETCH_BUFFER")
    assert cfg.get("MXNET_PREFETCH_BUFFER") == 9


def test_config_unknown_knob_raises():
    with pytest.raises(KeyError):
        cfg.get("MXNET_NO_SUCH_KNOB")
    with pytest.raises(KeyError):
        cfg.set("MXNET_NO_SUCH_KNOB", 1)


@pytest.mark.parametrize("value,state", [("1", "run"), ("0", "stop")])
def test_profiler_autostart_at_import(value, state):
    code = ("import mxnet_tpu_torch as mt\n"
            "print('STATE', mt.profiler.state(), "
            "mt.profiler.spans_enabled())\n")
    env = dict(os.environ, PYTHONPATH="", MXNET_PROFILER_AUTOSTART=value)
    env.pop("MXNET_TPU_OBS", None)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "STATE %s %s" % (state, state == "run") in res.stdout
