"""mxnet_tpu_torch.fleet — multi-replica serving: gateway routing,
replica supervision, and fail-over for generative decode (the port of
the reference package's ``fleet/``).

One :class:`Gateway` process fronts N ``GenerativeServer`` replica
processes over a stdlib line-protocol wire (``fleet.wire``, the
``dist.PodKVServer`` framing extended with streaming token frames):

* supervision — per-replica bounded-backoff respawn (the elastic
  discipline), PING liveness with the refused-vs-timeout rule;
  a respawn loads its kernels from the checkout's build directory (no
  ``nvcc`` build on respawn);
* routing + admission — sequences are sticky to the replica holding
  their KV pages; new requests go least-loaded (occupancy + queue
  depth from the heartbeat snapshots); the gateway sheds beyond its
  admission bound and propagates TTFT deadlines to the replica;
* fail-over — a replica death mid-stream re-prefills the victim's
  sequences on a survivor from the retained prompt + delivered prefix,
  with at-most-once delivery (frames dedup by emitted-token index);
  co-resident survivor sequences are untouched;
* federated obs — the gateway ``/metrics`` merges per-replica
  ``replica=<r>``-labeled expositions; replica blackboxes merge in
  ``python -m mxnet_tpu_torch.obs blackbox``.

The package is lazy and opt-in: ``import mxnet_tpu_torch`` (or
``mxnet_tpu_torch.serve``) never loads it, and a :class:`Gateway`
refuses to construct unless the ``MXNET_TPU_FLEET`` knob is set
(spawning a subprocess fleet is a deployment decision). ``python -m
mxnet_tpu_torch.fleet serve --spec ...`` is the process entry point.
"""
from .client import FleetClient
from .gateway import Gateway, merge_prometheus
from .replica import (ReplicaFront, ScriptedDecodeServer, build_from_spec,
                      run_replica, scripted_token)
from .wire import ServeWire, ping, probe, request_value, stream_generate

__all__ = [
    "Gateway", "FleetClient", "ServeWire", "ScriptedDecodeServer",
    "ReplicaFront", "build_from_spec", "run_replica", "scripted_token",
    "merge_prometheus", "ping", "probe", "request_value",
    "stream_generate",
]
