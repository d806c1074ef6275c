"""Cross-process trace context: the causal spine of request tracing.

A copy of the JAX package's ``obs/tracectx.py`` (stdlib only), so that
the port's serving protocol, server and load generator thread the same
wire field.

A :class:`TraceContext` names one node in a request's causal tree -
``trace_id`` identifies the whole request, ``span_id`` this node,
``parent_id`` the node that caused it - plus QoS baggage (priority
class and friends) that rides the whole tree.  It is minted ONCE at
the edge (the fleet router, or the load generator via
``--trace-sample RATE``), carried as the optional ``trace`` field on
the ``serve`` JSONL protocol, and forked with :meth:`child` at every
causal boundary: each router dispatch attempt is a distinct child span
(so sibling retry/hedge re-dispatches are distinguishable in replica
logs), and the replica engine forks again for its queue_wait / prefill
/ decode / stream_emit phases.

Spans themselves ride the existing :class:`~.recorder.MetricsRecorder`
sidecars as ordinary ``span`` events carrying the ``trace`` / ``span``
/ ``parent`` attributes (:meth:`span_fields`); ``obs/trace.py``
re-joins the per-process sidecars into one tree per trace_id.

Zero-overhead-off contract (the obs doctrine): with tracing off no
:class:`TraceContext` is ever constructed - the class-level
:attr:`TraceContext.minted` counter exists so tests can PIN that - the
wire messages carry no ``trace`` key (byte-identical requests), and
nothing here is ever reachable from a captured device program.
"""

from __future__ import annotations

import math
import os

# wire-key vocabulary of the ``trace`` field (kept one-token short:
# the field rides every traced generate line)
_WIRE_TRACE = "id"
_WIRE_SPAN = "span"
_WIRE_PARENT = "parent"
_WIRE_KEYS = (_WIRE_TRACE, _WIRE_SPAN, _WIRE_PARENT)

# baggage values must survive a JSON round trip unchanged
_BAGGAGE_TYPES = (str, int, float, bool)


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class TraceContext:
    """One node of a request's causal tree (immutable by convention)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "baggage")

    #: total contexts ever constructed in this process - the
    #: tracing-off zero-overhead pin reads this (no allocation = the
    #: counter does not move)
    minted = 0

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: str | None = None,
                 baggage: dict | None = None):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.parent_id = None if parent_id is None else str(parent_id)
        self.baggage = dict(baggage or {})
        TraceContext.minted += 1

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"TraceContext(trace={self.trace_id} span={self.span_id}"
            f" parent={self.parent_id} baggage={self.baggage})"
        )

    # -- construction --------------------------------------------------------

    @classmethod
    def mint(cls, **baggage) -> "TraceContext":
        """A fresh ROOT context (no parent) - the edge of the tree.
        Keyword arguments become QoS baggage carried by every child."""
        return cls(
            _hex_id(8), _hex_id(4),
            baggage={k: v for k, v in baggage.items() if v is not None},
        )

    def child(self) -> "TraceContext":
        """Fork a child span: same trace, new span id, this node as
        parent; baggage is inherited (it describes the REQUEST)."""
        return TraceContext(
            self.trace_id, _hex_id(4), parent_id=self.span_id,
            baggage=self.baggage,
        )

    # -- wire ----------------------------------------------------------------

    def to_wire(self) -> dict:
        """The JSON-safe ``trace`` field of a protocol message."""
        wire = {_WIRE_TRACE: self.trace_id, _WIRE_SPAN: self.span_id}
        if self.parent_id is not None:
            wire[_WIRE_PARENT] = self.parent_id
        wire.update(self.baggage)
        return wire

    @classmethod
    def from_wire(cls, obj) -> "TraceContext | None":
        """Parse a peer's ``trace`` field; ``None`` on anything that is
        not a well-formed context (an observability field must never
        fail a request)."""
        if not isinstance(obj, dict):
            return None
        trace_id = obj.get(_WIRE_TRACE)
        span_id = obj.get(_WIRE_SPAN)
        if not isinstance(trace_id, str) or not trace_id \
                or not isinstance(span_id, str) or not span_id:
            return None
        parent = obj.get(_WIRE_PARENT)
        if parent is not None and not isinstance(parent, str):
            return None
        baggage = {
            k: v for k, v in obj.items()
            if k not in _WIRE_KEYS and isinstance(v, _BAGGAGE_TYPES)
        }
        return cls(trace_id, span_id, parent_id=parent, baggage=baggage)

    # -- recorder glue -------------------------------------------------------

    def span_fields(self) -> dict:
        """The attributes a ``span`` event carries so ``obs/trace.py``
        can re-join sidecars: ``trace``/``span``(/``parent``)."""
        fields = {"trace": self.trace_id, "span": self.span_id}
        if self.parent_id is not None:
            fields["parent"] = self.parent_id
        return fields


def should_sample(seq: int, rate: float) -> bool:
    """Deterministic evenly-spaced head sampling: of the first ``n``
    sequence numbers, ``ceil(n * rate)`` are sampled, spread evenly -
    no RNG, so turning sampling on cannot shift any seeded request
    plan (the load generator's determinism pin)."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    return math.floor(seq * rate) > math.floor((seq - 1) * rate)
