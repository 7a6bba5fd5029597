"""Causal tracing: one span tree per incident, across every host.

Port of ``fps_tpu/obs/trace.py``, with **the same env-var names**
(:data:`TRACE_ID_ENV`, :data:`PARENT_SPAN_ENV`) and the same span record,
so a supervisor of either package links to the other's runs. This
module mints **trace/span ids** and propagates them through the
supervised-child env contract, so every layer's journal events carry
causal links:

* a supervisor mints one ``trace_id`` per run and a ``span_id`` per
  decision, and sets :data:`TRACE_ID_ENV` / :data:`PARENT_SPAN_ENV` in the
  child's environment;
* the training child's run journal (``obs.open_run``) reads them, and its
  ``run_start`` links the whole run — chunk phases (the
  :class:`~fps_tpu_torch.obs.timing.PhaseTimer` boundaries riding
  ``chunk`` events) and checkpoint publishes — under that attempt.

``tools/trace_export.py`` renders one or many obs directories into a
single Chrome-trace-event / Perfetto JSON.

Tracing is **host-side only**: ids live in env vars and journal lines,
never on the device — trace on/off gives bit-identical tables
(``tests/test_torch_obs.py``). Stdlib-only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import uuid

# Env contract — the same names as fps_tpu/obs/trace.py (and its
# supervisor's mirrors); tests/test_torch_obs.py asserts they match.
TRACE_ID_ENV = "FPS_TPU_TRACE_ID"
PARENT_SPAN_ENV = "FPS_TPU_PARENT_SPAN"

__all__ = [
    "TRACE_ID_ENV", "PARENT_SPAN_ENV",
    "new_trace_id", "new_span_id",
    "TraceContext", "Tracer",
]


def new_trace_id() -> str:
    """A fresh 128-bit trace id (hex) — one per run attempt / pod run."""
    return uuid.uuid4().hex


def new_span_id() -> str:
    """A fresh 64-bit span id (hex)."""
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The causal coordinates a process inherits from its parent.

    ``trace_id`` names the whole incident/run tree; ``parent_id`` is the
    span (an attempt, a decision) this process's own spans hang under.
    """

    trace_id: str | None = None
    parent_id: str | None = None

    @classmethod
    def from_env(cls, environ=None) -> "TraceContext":
        env = os.environ if environ is None else environ
        return cls(trace_id=env.get(TRACE_ID_ENV) or None,
                   parent_id=env.get(PARENT_SPAN_ENV) or None)

    @property
    def active(self) -> bool:
        return self.trace_id is not None

    def child_env(self, parent_id: str | None = None) -> dict:
        """Env-var updates handing this context (re-parented under
        ``parent_id`` when given) to a child process."""
        out = {}
        if self.trace_id:
            out[TRACE_ID_ENV] = self.trace_id
        pid = parent_id or self.parent_id
        if pid:
            out[PARENT_SPAN_ENV] = pid
        return out


class Tracer:
    """Emits ``span`` events through a Recorder (or the process-default
    recorder): the run-side half of the tracing story — the supervisor
    and pod layers write the same record shape into their own journals
    without importing this module.

    The canonical span record (one journal line)::

        {"kind": "event", "event": "span", "span": <name>,
         "trace_id": ..., "span_id": ..., "parent_id": ...,
         "t0": ..., "t1": ..., ...attrs}

    Host-side only: nothing here touches the compiled program.
    """

    def __init__(self, recorder=None, *, trace_id: str | None = None,
                 parent_id: str | None = None, clock=time.time):
        self.recorder = recorder
        self.trace_id = trace_id or new_trace_id()
        self.parent_id = parent_id
        self.clock = clock

    def emit(self, name: str, t0: float, t1: float, *,
             parent_id: str | None = None, span_id: str | None = None,
             **attrs) -> str:
        """Record one finished span; returns its span id (so callers can
        parent further spans under it)."""
        sid = span_id or new_span_id()
        fields = {
            "span": name,
            "trace_id": self.trace_id,
            "span_id": sid,
            "parent_id": parent_id or self.parent_id,
            "t0": float(t0),
            "t1": float(t1),
            **attrs,
        }
        if self.recorder is not None:
            self.recorder.event("span", **fields)
        else:
            from fps_tpu_torch.obs import events

            events.emit("span", **fields)
        return sid

    def instant(self, name: str, **attrs) -> str:
        t = self.clock()
        return self.emit(name, t, t, **attrs)

    @contextlib.contextmanager
    def span(self, name: str, *, parent_id: str | None = None, **attrs):
        """Context manager timing one span; yields the span id so nested
        work can parent under it."""
        sid = new_span_id()
        t0 = self.clock()
        try:
            yield sid
        finally:
            self.emit(name, t0, self.clock(), parent_id=parent_id,
                      span_id=sid, **attrs)
