"""The port's serving fleet (``mxnet_tpu_torch.fleet``) against the
reference's (``mxnet_tpu.fleet``), on the CPU.

The twenty contracts of ``tests/test_fleet.py``, ported one for one onto
the port's :class:`ScriptedDecodeServer` replicas behind real
``ServeWire`` sockets, with the gateway in ``addresses=`` mode: the wire
round-trips the serve API (streaming tokens and the exception classes);
the gateway routes least-loaded and keeps sequences sticky; a replica
death mid-stream fails over with an exact at-most-once continuation
(the scripted decoder's token function is a pure function of the
sequence, so bit-equality is checkable without a model); shed, deadline
and closed propagate as the classes a local ``GenerativeServer`` raises;
the ``gateway.route`` fault site kills one request; ``/metrics``
federates replica-labeled text; and ``import mxnet_tpu_torch`` (or
``.serve``) never loads the package.

Against the reference, exactly: the scripted token function,
``merge_prometheus``, ``elastic.backoff_delay``, the eight fleet and
backoff knobs (defaults and parsers), the fault grammar's new sites
and the ``hostkill`` kind's guard, and ``build_from_spec`` at a tiny
geometry: every parameter bit for bit (both draw ``init.Uniform(0.05)``
from ``np.random.seed(seed)``) and the same greedy stream. Last, one
supervised drill: a gateway spawns three tiny replica processes on the
CPU, rank 1 SIGKILLs itself after its 6th token frame, and every stream
equals the single server's token for token while rank 1 respawns and
serves a second wave.
"""
import json
import os
import random
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import config as jcfg
from mxnet_tpu_torch import config as _config
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve import DeadlineExceeded, QueueFull, ServerClosed
from mxnet_tpu_torch.serve.server import ServeError

# test files run side by side in parallel workers: each keeps torch's
# intra-op pool small
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# build_from_spec's tiny geometry (tools/fleet_smoke.py's)
GEO = dict(vocab_size=128, num_layers=2, d_model=32, n_heads=2, seq_len=32)
SPEC = {"kind": "transformer", "geo": GEO, "seed": 11, "slots": 2,
        "page": 8, "device": "cpu"}
PROMPTS = [[3, 1, 4], [1, 5, 9], [2, 6], [5, 3, 5], [8, 9, 7, 9], [3, 2]]
NEW_TOKENS = 12


@pytest.fixture(autouse=True)
def _fleet_knob():
    snap = _config.snapshot_overrides(["MXNET_TPU_FLEET"])
    _config.set("MXNET_TPU_FLEET", True)
    yield
    _config.restore_overrides(snap)


def _scripted_pair(n=2, step_s=0.005, **kw):
    from mxnet_tpu_torch.fleet import ScriptedDecodeServer, ServeWire
    srvs, wires = [], []
    for r in range(n):
        s = ScriptedDecodeServer(step_s=step_s,
                                 name="pt%d_%s" % (r, _uniq()), **kw)
        wires.append(ServeWire(s, rank=r))
        srvs.append(s)
    return srvs, wires


_SEQ = [0]


def _uniq():
    _SEQ[0] += 1
    return "u%d" % _SEQ[0]


def _ref_stream(prompt, n):
    from mxnet_tpu_torch.fleet import scripted_token
    seq, out = list(prompt), []
    for _ in range(n):
        t = scripted_token(seq)
        out.append(t)
        seq.append(t)
    return out


def _teardown(gw, srvs, wires):
    gw.close(drain=False, timeout=10.0)
    for w in wires:
        w.stop()
    for s in srvs:
        s.close(drain=False, timeout=2.0)


# ---------------------------------------------------------------- wire

def test_wire_streams_and_roundtrips_stats():
    from mxnet_tpu_torch.fleet import FleetClient
    srvs, wires = _scripted_pair(n=1)
    try:
        cli = FleetClient(wires[0].address)
        assert cli.ping()
        toks = cli.generate([1, 2, 3], max_new_tokens=8,
                            result_timeout=30.0)
        assert toks == _ref_stream([1, 2, 3], 8)
        snap = cli.stats()
        assert snap["tokens"] >= 8
        assert snap["kv"]["max_slots"] == 4
        text = cli.metrics_text()
        assert 'replica="0"' in text
    finally:
        for w in wires:
            w.stop()
        for s in srvs:
            s.close(drain=False, timeout=2.0)


def test_wire_rehydrates_serve_exceptions():
    from mxnet_tpu_torch.fleet import (FleetClient, ScriptedDecodeServer,
                                       ServeWire)
    s = ScriptedDecodeServer(slots=1, step_s=0.05, queue_bound=1,
                             name="pshed_" + _uniq())
    w = ServeWire(s, rank=0)
    try:
        cli = FleetClient(w.address)

        def _wait(pred, what):
            deadline = time.time() + 5.0
            while time.time() < deadline:
                if pred(s.stats()):
                    return
                time.sleep(0.01)
            pytest.fail("server never reached " + what)

        # [1] resident first, then [2] into the one queue slot: the
        # third submit must shed, through the wire, as QueueFull
        h1 = cli.submit_generate([1], max_new_tokens=50)
        _wait(lambda st: st["active_sequences"] >= 1, "slot-full")
        h2 = cli.submit_generate([2], max_new_tokens=50)
        _wait(lambda st: st["waiting"] >= 1, "queue-full")
        with pytest.raises(QueueFull):
            cli.generate([3], max_new_tokens=4, result_timeout=10.0)
        h1.cancel()
        h2.cancel()
    finally:
        w.stop()
        s.close(drain=False, timeout=2.0)


def test_wire_end_reason_distinguishes_done_from_released():
    from mxnet_tpu_torch.fleet import wire as fwire
    srvs, wires = _scripted_pair(n=1, step_s=0.005)
    s, w = srvs[0], wires[0]
    try:
        got = []
        end = fwire.stream_generate(
            w.address,
            {"prompt": [1], "prefix": [], "start": 0,
             "max_new_tokens": 4, "eos_id": None, "temperature": 0.0,
             "seed": None, "timeout": None},
            lambda i, t: got.append(t))
        assert end["n"] == 4 and end["reason"] == "done"
        assert got == _ref_stream([1], 4)
        box = {}

        def run():
            try:
                box["end"] = fwire.stream_generate(
                    w.address,
                    {"prompt": [2], "prefix": [], "start": 0,
                     "max_new_tokens": 10000, "eos_id": None,
                     "temperature": 0.0, "seed": None, "timeout": None},
                    lambda i, t: None)
            except BaseException as exc:                    # noqa: BLE001
                box["exc"] = exc

        t = threading.Thread(target=run, daemon=True)
        t.start()
        time.sleep(0.1)             # a few tokens in
        s.close(drain=False, timeout=5.0)
        t.join(10.0)
        assert not t.is_alive()
        assert box.get("end", {}).get("reason") == "released"
    finally:
        w.stop()
        s.close(drain=False, timeout=2.0)


def test_probe_adjudicates_alive_dead_ambiguous():
    from mxnet_tpu_torch.fleet import probe
    from mxnet_tpu_torch.fleet.wire import _free_port
    srvs, wires = _scripted_pair(n=1)
    try:
        assert probe(wires[0].address, timeout=2.0) == "alive"
    finally:
        wires[0].stop()
        srvs[0].close(drain=False, timeout=2.0)
    # connection refused = the probe-confirmed death signal
    assert probe(("127.0.0.1", _free_port()), timeout=1.0) == "dead"
    # a peer answering garbage is never grounds for a kill verdict
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def answer():
        conn, _ = srv.accept()
        conn.recv(64)
        conn.sendall(b"WAT\n")
        conn.close()

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    try:
        assert probe(srv.getsockname(), timeout=2.0) == "ambiguous"
    finally:
        srv.close()
        t.join(5.0)


# ------------------------------------------------------------- gateway

def test_gateway_requires_opt_in_knob():
    from mxnet_tpu_torch.fleet import Gateway
    _config.set("MXNET_TPU_FLEET", False)
    with pytest.raises(MXNetError):
        Gateway(addresses=[("127.0.0.1", 1)], port=None)


def test_gateway_streams_through_client_wire():
    from mxnet_tpu_torch.fleet import FleetClient, Gateway
    srvs, wires = _scripted_pair(n=2)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="pgwt_" + _uniq(), stats_period=0.1)
    try:
        assert gw.wait_ready(timeout=10.0) == 2
        cli = FleetClient(("127.0.0.1", gw.port))
        toks = cli.generate([4, 5], max_new_tokens=10,
                            result_timeout=30.0)
        assert toks == _ref_stream([4, 5], 10)
        snap = cli.stats()          # gateway stats through the same wire
        assert snap["live"] == 2 and snap["tokens"] >= 10
    finally:
        _teardown(gw, srvs, wires)


def test_routing_spreads_load_least_loaded():
    from mxnet_tpu_torch.fleet import Gateway
    srvs, wires = _scripted_pair(n=2, slots=2, step_s=0.01)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="plb_" + _uniq(), stats_period=0.05)
    try:
        assert gw.wait_ready(timeout=10.0) == 2
        handles = [gw.submit_generate([i + 1], max_new_tokens=20)
                   for i in range(4)]
        for h in handles:
            assert len(h.result(timeout=60.0)) == 20
        per = [s.stats()["tokens"] for s in srvs]
        assert all(t > 0 for t in per), per
    finally:
        _teardown(gw, srvs, wires)


def test_sticky_one_replica_per_stream():
    from mxnet_tpu_torch.fleet import Gateway
    srvs, wires = _scripted_pair(n=2)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="pstick_" + _uniq(), stats_period=0.05)
    try:
        assert gw.wait_ready(timeout=10.0) == 2
        h = gw.submit_generate([7], max_new_tokens=30)
        assert len(h.result(timeout=60.0)) == 30
        per = [s.stats()["tokens"] for s in srvs]
        assert sorted(per) == [0, 30], per
    finally:
        _teardown(gw, srvs, wires)


def test_gateway_sheds_at_admission_bound():
    from mxnet_tpu_torch.fleet import Gateway
    srvs, wires = _scripted_pair(n=1, step_s=0.05)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="pbound_" + _uniq(), queue_bound=1,
                 stats_period=0.1)
    try:
        assert gw.wait_ready(timeout=10.0) == 1
        h = gw.submit_generate([1], max_new_tokens=40)
        with pytest.raises(QueueFull):
            gw.submit_generate([2], max_new_tokens=4)
        h.cancel()
    finally:
        _teardown(gw, srvs, wires)


def test_ttft_deadline_propagates():
    from mxnet_tpu_torch.fleet import Gateway
    srvs, wires = _scripted_pair(n=1, slots=1, step_s=0.05)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="pdl_" + _uniq(), stats_period=0.1)
    try:
        assert gw.wait_ready(timeout=10.0) == 1
        h1 = gw.submit_generate([1], max_new_tokens=60)
        time.sleep(0.1)
        h2 = gw.submit_generate([2], max_new_tokens=4, timeout=0.2)
        with pytest.raises(DeadlineExceeded):
            h2.result(timeout=30.0)
        h1.cancel()
    finally:
        _teardown(gw, srvs, wires)


def test_close_rejects_new_submits():
    from mxnet_tpu_torch.fleet import Gateway
    srvs, wires = _scripted_pair(n=1)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="pcl_" + _uniq(), stats_period=0.1)
    try:
        gw.wait_ready(timeout=10.0)
        gw.close(drain=True, timeout=10.0)
        with pytest.raises(ServerClosed):
            gw.submit_generate([1], max_new_tokens=4)
    finally:
        _teardown(gw, srvs, wires)


# ------------------------------------------------------------ fail-over

def test_failover_midstream_exact_continuation():
    from mxnet_tpu_torch.fleet import Gateway
    srvs, wires = _scripted_pair(n=2, step_s=0.01)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="pfo_" + _uniq(), stats_period=0.05)
    try:
        assert gw.wait_ready(timeout=10.0) == 2
        witness = gw.submit_generate([9], max_new_tokens=40)
        time.sleep(0.08)            # a few tokens in
        st = gw.stats()
        victim = next(r["rank"] for r in st["replicas"]
                      if r["assigned"] > 0)
        survivor = 1 - victim
        # a co-resident sequence on the survivor rides through the
        # victim's death untouched
        bystander = gw.submit_generate([3, 3], max_new_tokens=40)
        time.sleep(0.05)
        wires[victim].stop()
        srvs[victim].close(drain=False, timeout=2.0)
        assert witness.result(timeout=60.0) == _ref_stream([9], 40)
        assert bystander.result(timeout=60.0) == _ref_stream([3, 3], 40)
        st = gw.stats()
        assert st["failover"] >= 1
        assert st["dup_dropped"] == 0
        assert st["replicas"][survivor]["state"] == "live"
    finally:
        _teardown(gw, srvs, wires)


def test_failover_redispatch_drops_ttft_and_derives_seed(monkeypatch):
    from mxnet_tpu_torch.fleet import Gateway
    from mxnet_tpu_torch.fleet import wire as fwire
    srvs, wires = _scripted_pair(n=1, step_s=0.005)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="prdp_" + _uniq(), stats_period=0.1)
    payloads = []
    real = fwire.stream_generate

    def fake(addr, payload, on_frame, **kw):
        payloads.append(dict(payload))
        if len(payloads) == 1:
            for i, t in enumerate(_ref_stream([7], 2)):
                on_frame(i, t)      # two tokens out, then die
            raise ConnectionResetError("mid-stream death")
        return real(addr, payload, on_frame, **kw)

    monkeypatch.setattr(fwire, "stream_generate", fake)
    try:
        assert gw.wait_ready(timeout=10.0) == 1
        h = gw.submit_generate([7], max_new_tokens=8, timeout=5.0,
                               seed=123)
        assert h.result(timeout=30.0) == _ref_stream([7], 8)
        assert len(payloads) == 2
        assert payloads[0]["timeout"] is not None
        assert payloads[0]["seed"] == 123
        assert payloads[1]["start"] == 2
        assert payloads[1]["prefix"] == _ref_stream([7], 2)
        assert payloads[1]["timeout"] is None
        # the continuation seed is the reference's, derived from the
        # fail-over point
        assert payloads[1]["seed"] == \
            (123 ^ (0x9E3779B97F4A7C15 * 2)) & ((1 << 63) - 1)
    finally:
        _teardown(gw, srvs, wires)


def test_short_done_end_is_a_complete_result(monkeypatch):
    from mxnet_tpu_torch.fleet import Gateway
    from mxnet_tpu_torch.fleet import wire as fwire

    def fake(addr, payload, on_frame, **kw):
        for i, t in enumerate(_ref_stream([5], 3)):
            on_frame(i, t)
        return {"n": 3, "reason": "done"}

    monkeypatch.setattr(fwire, "stream_generate", fake)
    srvs, wires = _scripted_pair(n=1)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="ptrunc_" + _uniq(), stats_period=0.1)
    try:
        assert gw.wait_ready(timeout=10.0) == 1
        h = gw.submit_generate([5], max_new_tokens=64)
        assert h.result(timeout=30.0) == _ref_stream([5], 3)
        assert gw.stats()["failover"] == 0
    finally:
        _teardown(gw, srvs, wires)


def test_all_replicas_dead_fails_legibly():
    from mxnet_tpu_torch.fleet import Gateway
    srvs, wires = _scripted_pair(n=1, step_s=0.01)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="pdead_" + _uniq(), stats_period=0.05)
    try:
        assert gw.wait_ready(timeout=10.0) == 1
        h = gw.submit_generate([5], max_new_tokens=60)
        time.sleep(0.05)
        wires[0].stop()
        srvs[0].close(drain=False, timeout=2.0)
        with pytest.raises(ServeError):
            h.result(timeout=120.0)
    finally:
        _teardown(gw, srvs, wires)


def test_gateway_route_fault_kills_one_request():
    from mxnet_tpu_torch.fleet import Gateway
    srvs, wires = _scripted_pair(n=1)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="pfr_" + _uniq(), stats_period=0.1)
    try:
        assert gw.wait_ready(timeout=10.0) == 1
        faults.install("gateway.route@1:raise")
        try:
            h1 = gw.submit_generate([1], max_new_tokens=4)
            with pytest.raises(ServeError):
                h1.result(timeout=30.0)
            # the site fired once; the next request routes normally
            h2 = gw.submit_generate([2], max_new_tokens=4)
            assert len(h2.result(timeout=30.0)) == 4
        finally:
            faults.clear()
    finally:
        _teardown(gw, srvs, wires)


# ------------------------------------------------------------- metrics

def test_metrics_federation_parses_with_replica_labels():
    from mxnet_tpu_torch.fleet import Gateway
    from mxnet_tpu_torch.obs.prometheus import parse_prometheus
    srvs, wires = _scripted_pair(n=2)
    gw = Gateway(addresses=[w.address for w in wires],
                 name="pmet_" + _uniq(), stats_period=0.05)
    try:
        assert gw.wait_ready(timeout=10.0) == 2
        gw.submit_generate([1], max_new_tokens=4).result(timeout=30.0)
        samples = parse_prometheus(gw.metrics_text())  # strict
        assert samples, "federated exposition empty"
        replicas = {dict(lbls).get("replica") for (_name, lbls) in samples}
        assert "0" in replicas and "1" in replicas
    finally:
        _teardown(gw, srvs, wires)


def test_merge_prometheus_dedupes_metadata():
    from mxnet_tpu.fleet import merge_prometheus as jmerge
    from mxnet_tpu_torch.fleet import merge_prometheus
    a = ("# HELP m a counter\n# TYPE m counter\n"
         'm{replica="0"} 1\n')
    b = ("# HELP m a counter\n# TYPE m counter\n"
         'm{replica="1"} 2\n\n')
    merged = merge_prometheus([a, b])
    assert merged.count("# HELP m") == 1
    assert merged.count("# TYPE m") == 1
    assert 'm{replica="0"} 1' in merged and 'm{replica="1"} 2' in merged
    assert merged == jmerge([a, b])
    assert merge_prometheus([]) == jmerge([]) == ""


# ------------------------------------------------------------ zero cost

def test_zero_cost_import_gate():
    """Neither ``import mxnet_tpu_torch`` nor ``.serve`` loads the fleet."""
    code = ("import sys; import mxnet_tpu_torch; "
            "assert 'mxnet_tpu_torch.fleet' not in sys.modules, 'fleet'; "
            "import mxnet_tpu_torch.serve; "
            "assert 'mxnet_tpu_torch.fleet' not in sys.modules, 'serve'; "
            "assert 'mxnet_tpu_torch.elastic' not in sys.modules; "
            "print('OK')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


def test_client_accepts_host_port_string():
    from mxnet_tpu_torch.fleet import FleetClient
    assert FleetClient("127.0.0.1:4242").address == ("127.0.0.1", 4242)
    assert FleetClient(("10.0.0.1", 7)).address == ("10.0.0.1", 7)
    with pytest.raises(ValueError):
        FleetClient("localhost")            # no port
    with pytest.raises(ValueError):
        FleetClient("host:notaport")


# ----------------------------------------------- against the reference

def test_scripted_token_is_the_references():
    from mxnet_tpu.fleet import scripted_token as jtok
    from mxnet_tpu_torch.fleet import scripted_token
    rng = np.random.RandomState(3)
    for n in (1, 2, 7, 40):
        seq = [int(t) for t in rng.randint(0, 251, n)]
        assert scripted_token(seq) == jtok(seq)


def test_backoff_delay_is_the_references():
    from mxnet_tpu.elastic import backoff_delay as jdelay
    from mxnet_tpu_torch.elastic import backoff_delay
    for restarts in (0, 1, 2, 5, 9, 40):
        for base, cap in ((1.0, 60.0), (0.2, 60.0), (0.5, 3.0)):
            assert backoff_delay(restarts, base, cap) == \
                jdelay(restarts, base, cap)
            assert backoff_delay(restarts, base, cap,
                                 rng=random.Random(restarts)) == \
                jdelay(restarts, base, cap, rng=random.Random(restarts))
    assert backoff_delay(3, 0.2, 60.0) == pytest.approx(0.8)


FLEET_KNOBS = {
    "MXNET_TPU_FLEET": ("1", "0", "yes", "off"),
    "MXNET_TPU_FLEET_REPLICAS": ("3", "1"),
    "MXNET_TPU_FLEET_STATS_PERIOD": ("0.2", "2"),
    "MXNET_TPU_FLEET_QUEUE_BOUND": ("8",),
    "MXNET_TPU_FLEET_MAX_RESPAWNS": ("0", "4"),
    "MXNET_TPU_FLEET_SPAWN_TIMEOUT": ("30", "600.5"),
    "MXNET_TPU_ELASTIC_BACKOFF": ("0.2", "3"),
    "MXNET_TPU_ELASTIC_BACKOFF_MAX": ("1.5",),
}


@pytest.mark.parametrize("name", sorted(FLEET_KNOBS))
def test_fleet_knob_defaults_and_parsers_match_the_reference(name,
                                                             monkeypatch):
    # the autouse fixture overrides MXNET_TPU_FLEET: read the defaults
    # and the environment without it
    _config.reset("MXNET_TPU_FLEET")
    monkeypatch.delenv(name, raising=False)
    assert _config.get(name) == jcfg.get(name)
    for raw in FLEET_KNOBS[name]:
        monkeypatch.setenv(name, raw)
        assert _config.get(name) == jcfg.get(name), raw


def test_fault_grammar_knows_the_fleet_sites_and_hostkill(caplog):
    from mxnet_tpu import faults as jfaults
    assert {"replica.die", "gateway.route"} <= faults.SITES
    assert "hostkill" in faults.KINDS and "hostkill" in jfaults.KINDS
    try:
        with caplog.at_level("WARNING"):
            faults.install("replica.die@6:hostkill,gateway.route@1")
        assert faults.active_specs() == ["replica.die@6:hostkill",
                                         "gateway.route@1"]
        assert "names no shipped injection site" not in caplog.text
    finally:
        faults.clear()


_HOSTKILL_CHILD = textwrap.dedent("""
    import sys
    sys.path.insert(0, %r)
    from mxnet_tpu_torch import faults
    faults.install("replica.die@1:hostkill")
    print("armed", flush=True)
    faults.fire("replica.die", default_kind="sigkill")
    print("survived", flush=True)
""")


@pytest.mark.parametrize("coordinated", [False, True],
                         ids=["unmarked", "coordinated"])
def test_hostkill_reaches_the_parent_only_when_coordinated(coordinated):
    """``hostkill`` SIGKILLs the parent only under the coordinator's
    marker, as the reference's does: here the parent is a shell the
    test owns, never pytest."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MXNET_TPU_ELASTIC_COORDINATED", None)
    env.pop("MXNET_TPU_FAULTS", None)
    if coordinated:
        env["MXNET_TPU_ELASTIC_COORDINATED"] = "1"
    child = _HOSTKILL_CHILD % ROOT
    # the shell runs the child, then prints its exit status: a killed
    # shell prints nothing
    shell = subprocess.run(
        ["sh", "-c", '%s -c "$CHILD"; echo "child=$?"' % sys.executable],
        env=dict(env, CHILD=child), capture_output=True, text=True,
        timeout=120)
    assert "armed" in shell.stdout and "survived" not in shell.stdout, \
        shell.stdout + shell.stderr
    if coordinated:
        assert shell.returncode == -signal.SIGKILL, shell.returncode
        assert "child=" not in shell.stdout
    else:
        assert shell.returncode == 0, shell.stderr
        assert "child=%d" % (128 + signal.SIGKILL) in shell.stdout


@pytest.fixture(scope="module")
def tiny_ref():
    """The reference's replica at the tiny spec: its parameters and its
    greedy streams."""
    from mxnet_tpu.fleet.replica import build_from_spec as jbuild
    jspec = {k: v for k, v in SPEC.items() if k != "device"}
    srv = jbuild(dict(jspec, name="ptiny_ref"))
    try:
        params = {k: np.asarray(v) for k, v in srv.engine.params.items()}
        outs = {tuple(p): srv.submit_generate(
            p, max_new_tokens=NEW_TOKENS).result(timeout=300)
            for p in PROMPTS}
    finally:
        srv.close()
    return params, outs


def test_build_from_spec_matches_the_reference(tiny_ref):
    from mxnet_tpu_torch.fleet import build_from_spec
    want_params, want_outs = tiny_ref
    srv = build_from_spec(dict(SPEC, name="ptiny_port"))
    try:
        assert srv.device == torch.device("cpu")
        got = {k: v.numpy() for k, v in srv.engine.params.items()}
        assert sorted(got) == sorted(want_params)
        for k in got:               # the same numpy draws, bit for bit
            np.testing.assert_array_equal(got[k], want_params[k], err_msg=k)
        handles = [(p, srv.submit_generate(p, max_new_tokens=NEW_TOKENS))
                   for p in PROMPTS]
        for p, h in handles:
            assert h.result(timeout=120) == want_outs[tuple(p)], p
    finally:
        srv.close()


def test_replica_builds_on_the_card_unless_the_spec_names_the_cpu(
        monkeypatch):
    """The departure: the reference builds every replica on ``cpu()``;
    the port's builds on the current device, which is the card — so
    without a card and without ``"device": "cpu"`` it raises, and never
    falls back to the host."""
    from mxnet_tpu_torch.fleet import build_from_spec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = {k: v for k, v in SPEC.items() if k != "device"}
    with pytest.raises(MXNetError, match="no CUDA device"):
        build_from_spec(dict(spec, name="pnodev"))
    with mt.cpu():                  # a CPU scope is the current device
        srv = build_from_spec(dict(spec, name="pscope"))
    try:
        assert srv.device == torch.device("cpu")
    finally:
        srv.close()


def test_replica_front_reports_compiles_and_launches():
    from mxnet_tpu_torch.fleet import ReplicaFront, ScriptedDecodeServer
    s = ScriptedDecodeServer(step_s=0.001, name="pfront_" + _uniq())
    try:
        snap = ReplicaFront(s, rank=2).stats()
        assert snap["rank"] == 2 and snap["pid"] == os.getpid()
        assert snap["backend_compiles"] == 0
        assert isinstance(snap["native_builds"], int)
        assert set(snap["kernel_launches"]) == {
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv"}
    finally:
        s.close(drain=False, timeout=2.0)


def test_replica_exits_when_its_launcher_dies():
    """A replica whose launcher is SIGKILLed (no QUIT, no SIGTERM) sees
    its parent change and exits: nothing is left holding the card."""
    spec = json.dumps({"kind": "scripted", "slots": 2, "step_ms": 5})
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MXNET_TPU_FAULTS", None)
    launcher = subprocess.Popen(
        ["sh", "-c", '%s -m mxnet_tpu_torch.fleet replica --model-json '
         '"$SPEC" & echo "pid=$!"; wait' % sys.executable],
        env=dict(env, SPEC=spec), stdout=subprocess.PIPE, text=True)
    pid = None
    try:
        line = launcher.stdout.readline()
        assert line.startswith("pid="), line
        pid = int(line[4:])
        ready = json.loads(launcher.stdout.readline())
        assert ready["event"] == "ready" and ready["pid"] == pid
        from mxnet_tpu_torch.fleet import ping
        assert ping(("127.0.0.1", ready["port"]), timeout=5.0)
        launcher.kill()
        launcher.wait(timeout=30)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            pytest.fail("the replica outlived its launcher")
        pid = None
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait(timeout=30)
        launcher.stdout.close()
        if pid is not None:
            os.kill(pid, signal.SIGKILL)


# ------------------------------------------------ the supervised drill

def test_supervised_fleet_fails_over_a_killed_replica(tiny_ref,
                                                      monkeypatch):
    """Three replica processes of the tiny spec on the CPU; rank 1 (its
    first spawn only) SIGKILLs itself after its 6th token frame. Every
    stream equals the single server's, no frame is duplicated, rank 1
    respawns without a native build and serves a second wave, and the
    federated ``/metrics`` carries all three replica labels."""
    from mxnet_tpu_torch.fleet import Gateway
    from mxnet_tpu_torch.obs.prometheus import parse_prometheus
    _, want = tiny_ref
    monkeypatch.setenv("MXNET_TPU_FLEET_FAULT_REPLICA",
                       "1:replica.die@6:hostkill")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("MXNET_TPU_FAULTS", raising=False)
    _config.set("MXNET_TPU_ELASTIC_BACKOFF", 0.2)
    try:
        gw = Gateway(spec=dict(SPEC, name="pdrill"), replicas=3, port=None,
                     stats_period=0.2, name="pdrill_" + _uniq())
    finally:
        _config.reset("MXNET_TPU_ELASTIC_BACKOFF")
    try:
        assert gw.wait_ready(3, timeout=120.0) == 3

        def wave():
            handles = [(p, gw.submit_generate(p, max_new_tokens=NEW_TOKENS))
                       for p in PROMPTS]
            for p, h in handles:
                assert h.result(timeout=120) == want[tuple(p)], p

        wave()
        st = gw.stats()
        assert st["failover"] >= 1 and st["dup_dropped"] == 0, st
        # the supervisor sees the death on its own clock (it polls the
        # process): wait for it and for the respawn
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            st = gw.stats()
            r1 = st["replicas"][1]
            if r1["state"] == "live" and r1["stats"].get("pid") and \
                    r1["generation"] == 2:
                break
            time.sleep(0.1)
        assert st["replica_dead"] == 1, st
        assert r1["state"] == "live" and r1["restarts"] == 1, r1
        assert r1["stats"]["native_builds"] == 0
        wave()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if gw.stats()["replicas"][1]["stats"].get("tokens", 0) > 0:
                break
            time.sleep(0.1)
        assert gw.stats()["replicas"][1]["stats"]["tokens"] > 0
        samples = parse_prometheus(gw.metrics_text())
        assert {"0", "1", "2"} <= {dict(lbls).get("replica")
                                   for _n, lbls in samples}
        procs = [r.proc for r in gw._replicas]
    finally:
        gw.close(drain=False, timeout=30.0)
    # every replica process is reaped
    assert all(p is not None and p.poll() is not None for p in procs)


# ------------------------------------------- phase 21, rehearsed on the CPU

sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


class _Event:
    """A CUDA event stand-in on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def _counting(plain):
    def wrapper(*args):
        key = "bf16" if args[0].dtype == torch.bfloat16 else "f32"
        wrapper.launches[key] += 1
        return plain(*args)
    wrapper.launches = {"f32": 0, "bf16": 0}
    return wrapper


@pytest.fixture
def small_phase21(monkeypatch, tmp_path):
    """Phase 21 on the CPU at a small width; returns the logged lines.
    The replica processes run the real wrappers, which launch nothing on
    the host, so their K1 count and the card's memory reading stand
    aside."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    for name, value in (("DEVICE", "cpu"), ("VOCAB", 64), ("D_MODEL", 32),
                        ("HEADS", 2), ("D_FF", 64), ("MAX_SEQ", 64),
                        ("PROMPT_LENS", (3, 5, 9, 12, 17, 20, 30, 40)),
                        ("NEW_TOKENS", 8), ("FLEET_LAYERS", 2),
                        ("UNIT_SHAPE", (2, 64, 8, 8)), ("ROOT", tmp_path)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(mt, "gpu", lambda i=0: mt.cpu())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    for fn in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    monkeypatch.setattr(fa, "_dispatch", lambda q, what: True)
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        _counting(fa.flash_attention_reference))
    monkeypatch.setattr(chip_smoke, "gpu_memory_used_mib", lambda: 0)
    monkeypatch.setattr(chip_smoke, "check_replica_k1", lambda *a: None)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("MXNET_TPU_FAULTS", raising=False)
    lines = []
    monkeypatch.setattr(chip_smoke, "log", lambda *a: lines.append(a[0]))
    yield lines


def test_phase21_rehearsal_on_cpu(small_phase21):
    """The whole of phase 21 at a small width: every check passes, the
    drill fails over and respawns, and each part logs its readings."""
    out = chip_smoke.legacy_tools_fleet_phase(torch, np)
    lines = small_phase21
    for what in ("numpy-op head", "ndarray-op scale"):
        r = out["21a"][what]
        assert r["gap"] <= chip_smoke.LEGACY_CE_ATOL
        assert r["card"][-1] < r["ce0"]
    assert out["21b"]["LM attention block"]["k1"]["f32"] >= 1
    assert out["21c"]["epochs"] == [chip_smoke.LEGACY_EPOCHS] * 2
    d = out["21d"]
    assert d["failover"] >= 1 and d["respawn_s"] is not None
    assert d["respawn_compiles"]["native_builds"] == 0
    assert sorted(d["replicas"]) == [0, 1, 2]
    assert d["replicas"][1]["generation"] == 2
    assert d["tf32"] == {"matmul": False, "cudnn": False}
    for prefix in ("21a numpy-op head", "21a ndarray-op scale",
                   "21b check_consistency ResNet-50 unit",
                   "21b check_consistency LM attention block",
                   "21b check_numeric_gradient", "21c caffe_converter",
                   "21c convert_params", "21c parse_log", "21d fleet",
                   "21 legacy, tools and fleet"):
        assert any(ln.startswith(prefix) for ln in lines), prefix
    # nothing of the drill outlives it
    alive = subprocess.run(["pgrep", "-f", "mxnet_tpu_torch.fleet replica"],
                           capture_output=True, text=True).stdout.split()
    assert not alive


def test_phase21_catches_a_stream_that_is_not_a_near_tie(small_phase21):
    """21d's stream check: a differing token whose top-2 gap exceeds
    LOGITS_ATOL is a fault of the fail-over, not a near-tie."""
    import mxnet_tpu_torch as mtt
    spec = chip_smoke.fleet_spec()
    from mxnet_tpu_torch.fleet import build_from_spec
    srv = build_from_spec(dict(spec, name="tie_probe"))
    try:
        params = srv.engine.params
        prompt = [1, 2, 3]
        want = srv.submit_generate(prompt, max_new_tokens=8).result(60)
    finally:
        srv.close()
    assert chip_smoke.fleet_streams(torch, "probe", params, [prompt],
                                    [want], [want]) == []
    row = chip_smoke.plain_logits(torch, params, prompt + want[:2],
                                  chip_smoke.FLEET_LAYERS)
    worst = int(row.argmin())
    bad = want[:2] + [worst] + want[3:]
    with pytest.raises(chip_smoke.SmokeFailure, match="top-2 gap"):
        chip_smoke.fleet_streams(torch, "probe", params, [prompt], [bad],
                                 [want])
    assert mtt is not None
