"""The fleet line protocol: one request per connection, extended with
streaming token frames.

The port's copy of the reference package's ``fleet/wire.py``, whose
framing is its ``dist.PodKVServer``'s (``parallel/`` comes with queue
A9; this module needs none of it).

One UTF-8 line per message, space-separated fields, structured payloads
as base64(JSON) so a payload can never smuggle a newline into the
framing (the PodKV rule). Stdlib-only on both sides.

Request lines (client -> server, one request per connection — the
PodKVClient discipline: no connection state to resynchronize after a
peer death)::

    PING                        -> PONG
    STATS                       -> VAL <b64 json>
    METRICS                     -> VAL <b64 text>     (Prometheus text)
    QUIT                        -> OK                 (then drain+exit)
    GEN <b64 json>              -> streaming frames, see below

``GEN`` replies are a frame stream on the same connection::

    TOK <idx> <token>           one frame per generated token; ``idx``
                                is the sequence-global emitted-token
                                index (prefix tokens already delivered
                                in an earlier life of the request are
                                NOT re-sent — ``idx`` starts at the
                                request's ``start``), the at-most-once
                                dedup key
    END <b64 json>              the stream finished ({"n": count,
                                "reason": "done"|"released"}).
                                ``done``: the server finished the
                                sequence on its own terms (contract
                                met, EOS, or KV-capacity truncation —
                                a complete result); ``released``: the
                                server let go of an UNfinished
                                sequence (a draining shutdown cancels
                                at a step boundary — the gateway
                                re-dispatches the remainder)
    ERR <b64 json>              {"kind": shed|deadline|closed|error,
                                 "msg": ...} — ``kind`` tells the
                                gateway whether to retry elsewhere
                                (shed/closed) or fail the request

The ``GEN`` payload: ``{"prompt": [...], "prefix": [...], "start": n,
"max_new_tokens": m, "eos_id": e|null, "temperature": t, "seed":
s|null, "timeout": ttft_seconds|null}``. ``prefix``/``start`` carry the
fail-over contract: a re-dispatched request prefills ``prompt+prefix``
on the survivor and streams from global index ``start``.
"""
from __future__ import annotations

import base64
import json
import socket
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from .. import lockcheck as _lockcheck
from ..serve.server import (DeadlineExceeded, QueueFull, ServeError,
                            ServerClosed)

__all__ = ["ServeWire", "stream_generate", "request_value", "ping",
           "probe", "dumps_b64", "loads_b64"]

_CONNECT_TIMEOUT = 5.0
# a healthy stream's inter-frame gap is bounded by one decode step; a
# dead peer's socket RSTs/EOFs almost immediately — this long timeout
# only catches a wedged-but-alive peer
_STREAM_TIMEOUT = 300.0


def dumps_b64(obj: Any) -> str:
    return base64.b64encode(
        json.dumps(obj, separators=(",", ":")).encode("utf-8")
    ).decode("ascii")


def loads_b64(s: str) -> Any:
    return json.loads(base64.b64decode(s.encode("ascii")).decode("utf-8"))


def _exc_kind(exc: BaseException) -> str:
    if isinstance(exc, QueueFull):
        return "shed"
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    if isinstance(exc, ServerClosed):
        return "closed"
    return "error"


def kind_to_exc(payload: Dict[str, Any]) -> ServeError:
    """Rehydrate an ERR frame into the serve exception taxonomy so
    fleet callers catch the same classes as local serve callers."""
    kind = payload.get("kind", "error")
    msg = str(payload.get("msg", "replica error"))
    if kind == "shed":
        return QueueFull(msg)
    if kind == "deadline":
        return DeadlineExceeded(msg)
    if kind == "closed":
        return ServerClosed(msg)
    return ServeError(msg)


class ServeWire(object):
    """TCP front for anything with the ``submit_generate()/stats()``
    shape — a ``GenerativeServer`` in a replica process, the scripted
    decode simulator, or the ``Gateway`` itself (the client-facing
    port speaks the same protocol, so ``FleetClient`` cannot tell a
    gateway from a bare replica).

    ``fault_site`` (replicas pass ``"replica.die"``) arms a fault check
    after every emitted token frame — the deterministic
    kill-mid-stream drill hook. The gateway front passes ``None``.
    """

    def __init__(self, target, port: int = 0, host: str = "127.0.0.1",
                 rank: Optional[int] = None,
                 fault_site: Optional[str] = None,
                 name: str = "fleet.wire"):
        self.target = target
        self.rank = rank
        self.fault_site = fault_site
        self.name = name
        self._lock = _lockcheck.Lock(name="fleet.wire_lock")
        self._stopped = False
        self._on_quit: Optional[Callable[[], None]] = None
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.host = host
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="%s[:%d]" % (name, self.port))
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def on_quit(self, fn: Callable[[], None]) -> None:
        """Callback for a received QUIT (the replica main loop hooks
        its shutdown flag here)."""
        self._on_quit = fn

    def stop(self) -> None:
        """Close the listener. Idempotent; in-flight streams finish on
        their own connections."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        try:
            # shutdown BEFORE close — the PodKVServer rule: close()
            # alone leaves a concurrently accept()-blocked listener
            # alive in the kernel
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass

    # ------------------------------------------------------------ server
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return              # stop() closed the listener
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn) -> None:
        try:
            conn.settimeout(_STREAM_TIMEOUT)
            rfile = conn.makefile("r", encoding="utf-8", newline="\n")
            line = rfile.readline()
            parts = line.strip().split(" ", 1)
            op = parts[0] if parts and parts[0] else ""
            if op == "PING":
                conn.sendall(b"PONG\n")
            elif op == "STATS":
                snap = self.target.stats()
                conn.sendall(("VAL %s\n" % dumps_b64(snap))
                             .encode("ascii"))
            elif op == "METRICS":
                text = self._metrics_text()
                conn.sendall(("VAL %s\n" % dumps_b64(text))
                             .encode("ascii"))
            elif op == "QUIT":
                conn.sendall(b"OK\n")
                cb = self._on_quit
                if cb is not None:
                    cb()
            elif op == "GEN" and len(parts) == 2:
                self._serve_gen(conn, loads_b64(parts[1]))
            else:
                conn.sendall(b"ERR\n")
        except (OSError, ValueError):
            pass                    # peer died mid-request: its problem
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _metrics_text(self) -> str:
        fn = getattr(self.target, "metrics_text", None)
        if fn is not None:
            return fn()
        from ..obs.prometheus import render_prometheus
        labels = {"replica": str(self.rank)} if self.rank is not None \
            else None
        return render_prometheus(labels=labels)

    def _serve_gen(self, conn, payload: Dict[str, Any]) -> None:
        from .. import faults as _faults
        start = int(payload.get("start", 0))
        try:
            prompt = [int(t) for t in payload["prompt"]]
            prefix = [int(t) for t in payload.get("prefix") or ()]
            handle = self.target.submit_generate(
                prompt + prefix,
                max_new_tokens=int(payload["max_new_tokens"]),
                eos_id=payload.get("eos_id"),
                timeout=payload.get("timeout"),
                temperature=float(payload.get("temperature", 0.0)),
                seed=payload.get("seed"))
        except Exception as exc:                            # noqa: BLE001
            conn.sendall(("ERR %s\n" % dumps_b64(
                {"kind": _exc_kind(exc), "msg": str(exc)}))
                .encode("ascii"))
            return
        n = 0
        try:
            # iterating the handle streams tokens as they decode and
            # re-raises the sequence's error after the last good token
            for tok in handle:
                conn.sendall(("TOK %d %d\n" % (start + n, tok))
                             .encode("ascii"))
                n += 1
                if _faults.ARMED and self.fault_site is not None:
                    # the kill-mid-stream drill hook: fires AFTER the
                    # frame is on the wire, so the drill's token count
                    # is exact
                    _faults.fire(self.fault_site, default_kind="sigkill")
            # a cancelled handle ended because the server RELEASED the
            # sequence (draining shutdown), not because it finished —
            # the distinction tells the gateway whether a short stream
            # is a complete result (KV-capacity truncation, EOS) or a
            # remainder to re-dispatch
            reason = ("released" if getattr(handle, "_cancelled", False)
                      else "done")
            conn.sendall(("END %s\n" % dumps_b64(
                {"n": n, "reason": reason})).encode("ascii"))
        except OSError:
            # the caller vanished (gateway fail-over already re-routed,
            # or a client gave up): stop streaming, free the sequence
            handle.cancel()
        except Exception as exc:                            # noqa: BLE001
            try:
                conn.sendall(("ERR %s\n" % dumps_b64(
                    {"kind": _exc_kind(exc), "msg": str(exc)}))
                    .encode("ascii"))
            except OSError:
                pass


# --------------------------------------------------------------- client

def _connect(address: Tuple[str, int],
             timeout: float = _CONNECT_TIMEOUT):
    return socket.create_connection(address, timeout=timeout)


def ping(address: Tuple[str, int], timeout: float = 1.0) -> bool:
    """One PING round-trip. False on ANY failure — callers that need
    the dead/unreachable distinction (the probe rule) use
    :func:`probe` instead."""
    try:
        with _connect(address, timeout=timeout) as conn:
            conn.settimeout(timeout)
            conn.sendall(b"PING\n")
            return conn.makefile("r").readline().strip() == "PONG"
    except OSError:
        return False


def probe(address: Tuple[str, int], timeout: float = 1.0) -> str:
    """Liveness adjudication: one PING round-trip, returning
    ``"alive"`` (a PONG came back), ``"dead"`` (connection refused —
    the probe-confirmed death signal), or ``"ambiguous"`` (timeout,
    EOF, malformed reply — never grounds for a kill verdict). The
    ProbeRing refused-vs-timeout rule on the fleet wire."""
    try:
        with _connect(address, timeout=timeout) as conn:
            conn.settimeout(timeout)
            conn.sendall(b"PING\n")
            line = conn.makefile("r", encoding="utf-8").readline()
    except ConnectionRefusedError:
        return "dead"
    except OSError:
        return "ambiguous"
    return "alive" if line.strip() == "PONG" else "ambiguous"


def request_value(address: Tuple[str, int], op: str,
                  timeout: float = 5.0) -> Any:
    """One ``STATS``/``METRICS``/``QUIT`` round-trip; the decoded VAL
    payload (or True for OK). Raises OSError on transport failure —
    ``ConnectionRefusedError`` is the probe-confirmed-dead signal."""
    with _connect(address, timeout=timeout) as conn:
        conn.settimeout(timeout)
        conn.sendall((op + "\n").encode("ascii"))
        line = conn.makefile("r", encoding="utf-8").readline().strip()
    if line == "OK":
        return True
    parts = line.split(" ", 1)
    if parts[0] != "VAL" or len(parts) != 2:
        raise OSError("bad %s reply %r from %s:%d"
                      % (op, line, address[0], address[1]))
    return loads_b64(parts[1])


def stream_generate(address: Tuple[str, int], payload: Dict[str, Any],
                    on_token: Callable[[int, int], None],
                    connect_timeout: float = _CONNECT_TIMEOUT,
                    stream_timeout: float = _STREAM_TIMEOUT
                    ) -> Dict[str, Any]:
    """Drive one GEN request: ``on_token(idx, tok)`` per TOK frame;
    returns the END payload. Raises the rehydrated serve exception on
    an ERR frame and OSError on transport death (connection reset /
    EOF mid-stream — the fail-over trigger)."""
    with _connect(address, timeout=connect_timeout) as conn:
        conn.settimeout(stream_timeout)
        conn.sendall(("GEN %s\n" % dumps_b64(payload)).encode("ascii"))
        rfile = conn.makefile("r", encoding="utf-8", newline="\n")
        while True:
            line = rfile.readline()
            if not line:
                raise ConnectionResetError(
                    "stream from %s:%d ended without END"
                    % (address[0], address[1]))
            parts = line.strip().split(" ")
            if parts[0] == "TOK" and len(parts) == 3:
                on_token(int(parts[1]), int(parts[2]))
            elif parts[0] == "END" and len(parts) == 2:
                return loads_b64(parts[1])
            elif parts[0] == "ERR" and len(parts) == 2:
                raise kind_to_exc(loads_b64(parts[1]))
            else:
                raise OSError("bad stream frame %r" % line.strip())


def _free_port() -> int:
    """A free TCP port on this host (bind 0, read it back, release).
    Another process may take it before the caller binds it; a replica
    that fails to bind exits and its supervisor respawns it on a new
    port. (The reference's ``parallel.dist.free_port``; ``parallel/``
    comes with queue A9.)"""
    s = socket.socket()
    try:
        s.bind(("", 0))
        return s.getsockname()[1]
    finally:
        s.close()
