"""JSON-lines wire protocol for the serving TCP endpoint (a copy of the
JAX package's ``serving/protocol.py``: the same wire bytes, so a client
of either server talks to the other).

One JSON object per ``\\n``-terminated line in both directions - the
same framing idiom as the launcher/param-server control plane, chosen
over a binary header because serving payloads are token id lists, not
flat gradient vectors.  Requests carry an ``op``; responses echo the
request ``id`` and carry an ``event``:

Client -> server::

    {"op": "generate", "id": "r1", "prompt": [7, 12, 3],
     "max_new_tokens": 16, "temperature": 0.8, "seed": 7,
     "stream": true}
    {"op": "generate", "text": "To be, or", ...}   # byte-vocab models
    {"op": "generate", "priority": "low", "deadline_ms": 2000, ...}
    {"op": "ping"}
    {"op": "stats"}

``priority`` (``high`` | ``normal`` | ``low``) and ``deadline_ms`` are
the fleet-router QoS fields (``serving/fleet/router.py``): the router
sheds low priority first past its admission budget and bounds each
request's dispatch + retries by its deadline.  A bare ``pdrnn-serve``
ignores both - single-replica requests keep their exact old behavior.

``trace`` is the OPTIONAL distributed-tracing context
(``obs/tracectx.py``)::

    {"op": "generate", "trace": {"id": "9f2c...", "span": "51ab...",
     "parent": "03de...", "qos": "high"}, ...}

``id`` names the whole request's trace, ``span`` the sender's span,
``parent`` its cause; remaining keys are QoS baggage.  Every hop that
forwards a traced request re-mints ``span`` (router dispatch attempts
each get their own), and receivers that don't trace simply ignore the
field.  Untraced requests carry NO ``trace`` key at all - the wire
bytes of an untraced request are pinned byte-identical to the
pre-tracing protocol.

Server -> client::

    {"id": "r1", "event": "token", "index": 0, "token": 42}   # stream
    {"id": "r1", "event": "done", "status": "done",
     "tokens": [...], "token_count": 16, "latency_ms": ...,
     "ttft_ms": ..., "queue_ms": ..., "seed": 7}
    {"id": "r1", "event": "error", "error": "...", "shed": true}
    {"event": "pong", "model": "char", "vocab_size": 256, ...}
    {"event": "stats", ...engine stats...}

:class:`ServingClient` is the blocking one-request-at-a-time client the
load generator and the tests build on (concurrency = many clients, the
server multiplexes slots across connections).
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import time

def encode_line(obj: dict) -> bytes:
    return (json.dumps(obj) + "\n").encode()


def decode_line(line: str) -> dict:
    obj = json.loads(line)
    if not isinstance(obj, dict):
        raise ValueError(f"protocol messages are JSON objects, got {obj!r}")
    return obj


def text_to_tokens(text: str) -> list[int]:
    """UTF-8 bytes as token ids - the byte-vocab (>= 256) convention the
    char family trains with (``data/text.py``)."""
    return list(text.encode("utf-8"))


def tokens_to_text(tokens: list[int]) -> str:
    """Best-effort text rendering of byte tokens (lossless for ids
    < 256 via latin-1; serving never round-trips through this)."""
    return bytes(t & 0xFF for t in tokens).decode("latin-1")


def build_generate_request(prompt=None, *, text: str | None = None,
                           request_id: str = "0",
                           max_new_tokens: int = 16,
                           temperature: float = 0.0,
                           seed: int | None = None, stream: bool = False,
                           priority: str | None = None,
                           deadline_ms: float | None = None,
                           trace=None) -> dict:
    """The exact ``generate`` request object a client puts on the wire.

    Factored out of :meth:`ServingClient.generate` so tests can pin the
    untraced wire bytes: with ``trace=None`` the returned dict carries
    no ``trace`` key and is byte-identical to the pre-tracing protocol.
    ``trace`` is a :class:`~..obs.tracectx.TraceContext` (duck-typed:
    anything with ``to_wire()``)."""
    req: dict = {
        "op": "generate", "id": request_id,
        "max_new_tokens": int(max_new_tokens),
        "temperature": float(temperature), "stream": bool(stream),
    }
    if text is not None:
        req["text"] = text
    else:
        req["prompt"] = [int(t) for t in (prompt or [])]
    if seed is not None:
        req["seed"] = int(seed)
    if priority is not None:
        req["priority"] = str(priority)
    if deadline_ms is not None:
        req["deadline_ms"] = float(deadline_ms)
    if trace is not None:
        req["trace"] = trace.to_wire()
    return req


class ProtocolError(RuntimeError):
    """The peer sent something outside the protocol."""


class ServingClient:
    """Blocking JSONL client: one in-flight request per connection.

    ``timeout_s`` bounds each individual socket read; ``connect_timeout_s``
    (default: ``timeout_s``) bounds the dial separately, so a vanished
    or wedged target fails the CONNECT in seconds instead of holding a
    whole request timeout.  Per-request wall deadlines are the
    ``deadline_s`` argument of :meth:`generate` - a per-read timeout
    alone never bounds a stream that keeps dribbling tokens."""

    def __init__(self, host: str, port: int, timeout_s: float = 60.0,
                 connect_timeout_s: float | None = None):
        self.sock = socket.create_connection(
            (host, port),
            timeout=timeout_s if connect_timeout_s is None
            else connect_timeout_s,
        )
        try:
            self.sock.settimeout(timeout_s)
            self.timeout_s = float(timeout_s)
            self._rfile = self.sock.makefile("r", encoding="utf-8")
        except Exception:
            self.sock.close()
            raise
        # per-client unique request-id minting: a random prefix keeps
        # ids from CONCURRENT clients of one server distinct, the
        # counter keeps a single client's requests distinct
        self._id_prefix = os.urandom(3).hex()
        self._id_seq = itertools.count()

    def close(self):
        try:
            self._rfile.close()
        finally:
            self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- plumbing ------------------------------------------------------------

    def _send(self, obj: dict):
        self.sock.sendall(encode_line(obj))

    def _recv(self) -> dict:
        line = self._rfile.readline()
        if not line:
            raise ProtocolError("server closed the connection")
        return decode_line(line)

    def request(self, obj: dict) -> dict:
        self._send(obj)
        return self._recv()

    # -- ops -----------------------------------------------------------------

    def ping(self) -> dict:
        reply = self.request({"op": "ping"})
        if reply.get("event") != "pong":
            raise ProtocolError(f"expected pong, got {reply}")
        return reply

    def stats(self) -> dict:
        reply = self.request({"op": "stats"})
        if reply.get("event") != "stats":
            raise ProtocolError(f"expected stats, got {reply}")
        return reply

    def generate(self, prompt=None, *, text: str | None = None,
                 max_new_tokens: int = 16, temperature: float = 0.0,
                 seed: int | None = None, stream: bool = False,
                 request_id: str | None = None, on_token=None,
                 priority: str | None = None,
                 deadline_ms: float | None = None,
                 deadline_s: float | None = None,
                 trace=None) -> dict:
        """Run one generation; returns the final ``done``/``error``
        payload.  With ``stream=True``, ``on_token(index, token)`` fires
        per streamed token before the final payload arrives.

        ``request_id`` defaults to a freshly minted per-client unique id
        (prefix + counter) - the old ``"0"`` default made every request
        from a default-argument caller the SAME request in stats and
        sidecars.  Pass an explicit id to correlate with external
        bookkeeping.

        ``priority``/``deadline_ms`` ride in the request (router QoS
        fields; plain servers ignore them).  ``trace`` attaches a
        :class:`~..obs.tracectx.TraceContext` as the ``trace`` wire
        field; ``None`` (the default) leaves the request byte-identical
        to the untraced protocol.  ``deadline_s`` is CLIENT-side: a
        wall bound across every read of this request - without it a
        stream emitting a token every few hundred ms resets the
        per-read timeout forever and a wedged server pins the caller."""
        if request_id is None:
            request_id = f"{self._id_prefix}-{next(self._id_seq)}"
        req = build_generate_request(
            prompt, text=text, request_id=request_id,
            max_new_tokens=max_new_tokens, temperature=temperature,
            seed=seed, stream=stream, priority=priority,
            deadline_ms=deadline_ms, trace=trace,
        )
        self._send(req)
        expiry = (
            None if deadline_s is None
            else time.monotonic() + float(deadline_s)
        )
        while True:
            if expiry is not None:
                remaining = expiry - time.monotonic()
                if remaining <= 0:
                    raise ProtocolError(
                        f"no final reply within the {deadline_s:g}s "
                        f"request deadline"
                    )
                self.sock.settimeout(min(self.timeout_s, remaining))
            try:
                reply = self._recv()
            except OSError as exc:
                # a read armed with the residual deadline timing out IS
                # the deadline expiring - name it that, not "timed out"
                if expiry is not None and time.monotonic() >= expiry:
                    raise ProtocolError(
                        f"no final reply within the {deadline_s:g}s "
                        f"request deadline"
                    ) from exc
                raise
            event = reply.get("event")
            if event == "token":
                if on_token is not None:
                    on_token(reply.get("index"), reply.get("token"))
                continue
            if event in ("done", "error"):
                return reply
            raise ProtocolError(f"unexpected event {reply}")
