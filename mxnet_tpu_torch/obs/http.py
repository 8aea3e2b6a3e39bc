"""Opt-in HTTP ``/metrics`` endpoint (Prometheus scrape target).

A stdlib ``ThreadingHTTPServer`` on a daemon thread serving
:func:`~.prometheus.render_prometheus` — no dependencies, off by
default. ``serve.InferenceServer`` and ``serve.GenerativeServer`` start
one when their ``metrics_port=`` argument or the
``MXNET_TPU_OBS_METRICS_PORT`` knob says so; anything else can call
:func:`start_metrics_server` directly. Binds 127.0.0.1 by default:
exposing process metrics beyond the host is a deployment decision, not
a framework default.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .prometheus import render_prometheus

__all__ = ["MetricsServer", "start_metrics_server", "maybe_start_from_knob"]


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):                                      # noqa: N802
        if self.path.split("?", 1)[0] != "/metrics":
            self.send_error(404, "try /metrics")
            return
        try:
            # a scrape is a log boundary: refresh the obs_mfu /
            # obs_flops_per_sec gauges (one wait on the last step's
            # event per registered module — see mfu.collect)
            from . import mfu as _mfu
            _mfu.collect()
        except Exception:                                  # noqa: BLE001
            pass    # exposition must render even if a collector dies
        render = getattr(self.server, "render_fn", None) \
            or render_prometheus
        try:
            text = render()
        except Exception:                                  # noqa: BLE001
            # a custom renderer may fail: fall back to this process's
            # own registry rather than failing the scrape
            text = render_prometheus()
        body = text.encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *_args):    # scrapes must not spam stderr
        pass


class MetricsServer(object):
    """Daemon-thread /metrics endpoint; ``port=0`` binds an ephemeral
    port (read it back from ``.port``)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 render=None):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        # optional exposition override; None keeps render_prometheus
        self._httpd.render_fn = render
        self.host = self._httpd.server_address[0]
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mxnet_tpu_torch.obs[/metrics:%d]" % self.port, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return "http://%s:%d/metrics" % (self.host, self.port)

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         render=None) -> MetricsServer:
    """Start (and return) a /metrics endpoint; the caller owns
    ``close()``. ``render`` (optional) overrides the exposition text."""
    return MetricsServer(port=port, host=host, render=render)


def maybe_start_from_knob(explicit: Optional[int] = None) \
        -> Optional[MetricsServer]:
    """Endpoint policy shared by subsystems: an explicit ``metrics_port``
    argument wins; None falls back to the ``MXNET_TPU_OBS_METRICS_PORT``
    knob; a resolved value < 0 means off. Raises ``OSError`` when the
    port cannot be bound."""
    port = explicit
    if port is None:
        from .. import config as _config
        port = int(_config.get("MXNET_TPU_OBS_METRICS_PORT"))
    if port is None or port < 0:
        return None
    return MetricsServer(port=port)
