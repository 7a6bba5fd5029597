"""Process-default recorder: the low-plumbing event path.

Port of ``fps_tpu/obs/events.py``.

The driver takes an explicit recorder, but deep layers (checkpoint
integrity, rollback policies) fire events from places a recorder was
never threaded to — a ``Checkpointer`` is constructed by user code long
before any trainer exists. Rather than plumbing a recorder through every
constructor, those layers emit through the process-default set here:
no-ops when none is installed (the exact zero-cost-off contract the
guard has), so the core stays importable and silent without obs.

Stdlib-only, no other fps_tpu_torch imports: ``core/resilience.py`` (which must stay
dependency-light) can call :func:`emit` without a cycle.
"""

from __future__ import annotations

import contextlib
import threading

_lock = threading.Lock()
_default = None


def set_default_recorder(recorder) -> None:
    """Install (or clear, with ``None``) the process-default recorder."""
    global _default
    with _lock:
        _default = recorder


def get_default_recorder():
    return _default


# One warning per dropped metric/event name — background telemetry must
# not spam the log on every chunk.
_warned_metrics: set = set()


def emit(etype: str, **fields) -> None:
    """Fire an event on the process-default recorder, if any.

    Guarded like :func:`record_metric`: background telemetry fired from
    deep layers (checkpoint save, rollback record) must degrade to a
    logged drop when a user-installed recorder misbehaves, never abort
    the training operation that fired it.
    """
    rec = _default
    if rec is None:
        return
    try:
        rec.event(etype, **fields)
    except Exception as e:  # noqa: BLE001 - see docstring
        if etype not in _warned_metrics:
            _warned_metrics.add(etype)
            import logging

            logging.getLogger("fps_tpu_torch.obs").warning(
                "dropping background event %s (%s); the installed "
                "recorder rejected it", etype, e,
            )


def record_metric(kind: str, name: str, value: float, **labels) -> None:
    """Metric sample on the process-default recorder, if any.
    ``kind`` is "inc" / "set" / "observe" (the Recorder method names).

    Unlike a directly-held Recorder (where a schema violation should fail
    at the emission site), the process default may carry a USER registry
    that never declared the framework's leaves — background telemetry
    from deep layers must degrade to a logged drop, not kill training.
    """
    rec = _default
    if rec is None:
        return
    try:
        getattr(rec, kind)(name, value, **labels)
    except (KeyError, TypeError, ValueError) as e:
        if name not in _warned_metrics:
            _warned_metrics.add(name)
            import logging

            logging.getLogger("fps_tpu_torch.obs").warning(
                "dropping background metric %s (%s); the installed "
                "recorder's registry does not accept it", name, e,
            )


@contextlib.contextmanager
def default_recorder(recorder):
    """Scoped install — tests use this to avoid cross-test leakage."""
    prev = _default
    set_default_recorder(recorder)
    try:
        yield recorder
    finally:
        set_default_recorder(prev)
