"""Fleet client: the ``submit_generate`` contract over the wire.

The port's copy of the reference package's ``fleet/client.py``.
``FleetClient`` points at a gateway (or, identically, a bare replica —
both fronts speak the same protocol) and hands out the same
:class:`~mxnet_tpu_torch.serve.server.GenerateHandle` a local
``GenerativeServer`` would: iterate it for streaming, ``result()`` for
the whole sequence, and the serve exception taxonomy (``QueueFull``,
``DeadlineExceeded``, ``ServerClosed``) re-raises rehydrated from ERR
frames. Code written against a local server moves behind a fleet by
changing one constructor.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union
import threading

from ..serve.server import GenerateHandle
from . import wire as _wire

__all__ = ["FleetClient"]


class FleetClient(object):
    def __init__(self, address: Union[str, Tuple[str, int]],
                 connect_timeout: float = _wire._CONNECT_TIMEOUT,
                 stream_timeout: float = _wire._STREAM_TIMEOUT):
        # accept "host:port" too — indexing a string would otherwise
        # build the silently-wrong address ("1", 2) out of "127.0.0.1:p"
        if isinstance(address, (str, bytes)):
            host, _, port = str(address).rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    "FleetClient address string must be 'host:port', got %r"
                    % (address,))
            address = (host, int(port))
        self.address = (str(address[0]), int(address[1]))
        self.connect_timeout = float(connect_timeout)
        self.stream_timeout = float(stream_timeout)

    def ping(self, timeout: float = 1.0) -> bool:
        return _wire.ping(self.address, timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        return _wire.request_value(self.address, "STATS")

    def metrics_text(self) -> str:
        return _wire.request_value(self.address, "METRICS")

    def submit_generate(self, prompt, max_new_tokens: int = 32,
                        eos_id: Optional[int] = None,
                        timeout: Optional[float] = None,
                        temperature: float = 0.0,
                        seed: Optional[int] = None,
                        on_token=None) -> GenerateHandle:
        """Non-blocking submit; a daemon thread drives the wire stream
        into the returned handle. Transport death surfaces as the
        handle's error (the gateway behind the wire already did its own
        fail-over — an error here means the GATEWAY died)."""
        if hasattr(prompt, "asnumpy"):
            prompt = prompt.asnumpy()
        if hasattr(prompt, "tolist"):
            prompt = prompt.tolist()
        payload = {
            "prompt": [int(t) for t in prompt],
            "prefix": [],
            "start": 0,
            "max_new_tokens": int(max_new_tokens),
            "eos_id": eos_id,
            "temperature": float(temperature),
            "seed": seed,
            "timeout": timeout,
        }
        handle = GenerateHandle(on_token=on_token)

        def drive() -> None:
            def on_frame(idx: int, tok: int) -> None:
                handle._put(tok)

            try:
                _wire.stream_generate(
                    self.address, payload, on_frame,
                    connect_timeout=self.connect_timeout,
                    stream_timeout=self.stream_timeout)
            except BaseException as exc:                    # noqa: BLE001
                handle._finish(exc)
            else:
                handle._finish(None)

        t = threading.Thread(target=drive, daemon=True,
                             name="mxnet_tpu_torch.fleet.client")
        t.start()
        return handle

    def generate(self, prompt, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = None,
                 temperature: float = 0.0,
                 seed: Optional[int] = None,
                 result_timeout: Optional[float] = None) -> List[int]:
        """Blocking convenience: the full token list (or the serve
        exception)."""
        handle = self.submit_generate(
            prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
            timeout=timeout, temperature=temperature, seed=seed)
        return handle.result(timeout=result_timeout)
