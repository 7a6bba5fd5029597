"""Pluggable telemetry sinks.

Every sink consumes the one record shape the :class:`~fps_tpu_torch.obs.registry.
Recorder` produces (``kind: "metric" | "event"`` dicts) and renders it for
one consumer class:

* :class:`JsonlSink`      — append-only JSONL event log (the machine-
  readable stream ``tools/obs_report.py`` digests);
* :class:`PrometheusSink` — Prometheus text exposition written at flush
  (scrape the file, or serve it from a sidecar; no HTTP server here);
* :class:`MemorySink`     — bounded in-memory ring, for tests and for
  embedding a live tail in a REPL.

Sinks must never throw into the training loop: file-system failures on
``write`` are latched and logged once, then the sink goes quiet (telemetry
must degrade, not take the job down with it).
"""

from __future__ import annotations

import collections
import json
import logging
import math
import os
import re

_log = logging.getLogger("fps_tpu_torch.obs")


class Sink:
    """Interface: ``write(record)`` per sample/event, ``flush``, ``close``."""

    def write(self, record: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class MemorySink(Sink):
    """Bounded ring of the most recent records (oldest evicted first)."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.records = collections.deque(maxlen=capacity)

    def write(self, record: dict) -> None:
        self.records.append(record)

    def events(self, etype: str | None = None) -> list[dict]:
        return [r for r in self.records if r.get("kind") == "event"
                and (etype is None or r.get("event") == etype)]

    def metrics(self, name: str | None = None) -> list[dict]:
        return [r for r in self.records if r.get("kind") == "metric"
                and (name is None or r.get("name") == name)]


class JsonlSink(Sink):
    """Append-only JSONL file, one record per line.

    ``flush_every`` bounds how many records may sit in the userspace
    buffer — a crash loses at most that many, a `flush()` (the driver
    flushes at chunk boundaries) loses none. Write failures latch the
    sink into a dropping state after one log line.
    """

    def __init__(self, path: str, *, flush_every: int = 64):
        self.path = path
        self.flush_every = max(1, flush_every)
        self._n = 0
        self._dead = False
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def write(self, record: dict) -> None:
        if self._dead:
            return
        try:
            self._f.write(_strict_json_line(record) + "\n")
            self._n += 1
            if self._n % self.flush_every == 0:
                self._f.flush()
        except (OSError, ValueError) as e:
            self._dead = True
            _log.warning("obs sink %s failed (%s); dropping telemetry",
                         self.path, e)

    def flush(self) -> None:
        if not self._dead and not self._f.closed:
            try:
                self._f.flush()
            except OSError:
                self._dead = True

    def close(self) -> None:
        self.flush()
        try:
            self._f.close()
        except OSError:
            pass


def scrub_nonfinite(x):
    """Recursively replace non-finite floats with None (dict/list/tuple
    containers, numpy scalars and arrays degraded first) — the one
    shared spelling of the strict-JSON invariant; ``serve/net.py``
    imports it for the wire, and ``tools/obs_report.py`` (deliberately
    import-free) mirrors it for the digest."""
    if isinstance(x, dict):
        return {k: scrub_nonfinite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [scrub_nonfinite(v) for v in x]
    if not isinstance(x, (str, bytes)) and callable(
            getattr(x, "tolist", None)):
        return scrub_nonfinite(x.tolist())  # numpy scalar/array first
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _strict_json_line(record: dict) -> str:
    """One record as STRICT JSON: non-finite floats become null rather
    than the Python-only NaN/Infinity tokens that every other JSON
    parser rejects (the serving watcher legitimately sets a NaN gauge
    when no snapshot survives — the artifact must stay machine-readable
    to jq and non-Python consumers)."""
    try:
        return json.dumps(record, default=_json_default, allow_nan=False)
    except ValueError:
        return json.dumps(scrub_nonfinite(record), default=_json_default,
                          allow_nan=False)


def _json_default(v):
    """Telemetry values arrive as numpy scalars/arrays too — degrade to
    plain Python instead of throwing mid-training."""
    if hasattr(v, "item") and callable(v.item):
        try:
            return v.item()
        except (TypeError, ValueError):
            pass
    if hasattr(v, "tolist"):
        return v.tolist()
    return repr(v)


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


class PrometheusSink(Sink):
    """Prometheus text exposition (format 0.0.4) regenerated at flush.

    Keeps its own aggregates (counter sums, last gauge, histogram
    count/sum — no buckets: the exposition carries ``_count``/``_sum``
    summary series, which is what rate/latency dashboards consume) and
    rewrites ``path`` atomically on ``flush()``/``close()``. Events are
    ignored — Prometheus is a metrics surface.
    """

    def __init__(self, path: str, *, namespace: str = "fps_tpu"):
        self.path = path
        self.namespace = namespace
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, list] = {}  # key -> [count, sum]
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    def write(self, record: dict) -> None:
        if record.get("kind") != "metric":
            return
        key = (record["name"],
               tuple(sorted((record.get("labels") or {}).items())))
        v = float(record["value"])
        mtype = record.get("mtype")
        if mtype == "counter":
            self._counters[key] = self._counters.get(key, 0.0) + v
        elif mtype == "gauge":
            self._gauges[key] = v
        elif mtype == "histogram":
            h = self._hists.setdefault(key, [0, 0.0])
            h[0] += 1
            h[1] += v

    @staticmethod
    def _escape(value) -> str:
        """Label-value escaping per the exposition format (backslash,
        double quote, newline) — a user-chosen table name must not be
        able to invalidate the whole scrape file."""
        return (str(value).replace("\\", r"\\").replace('"', r"\"")
                .replace("\n", r"\n"))

    def _series(self, name: str, labels: tuple, suffix: str = "") -> str:
        base = self.namespace + "_" + _NAME_RE.sub("_", name.replace(".", "_"))
        lbl = ""
        if labels:
            lbl = "{" + ",".join(
                f'{_NAME_RE.sub("_", k)}="{self._escape(v)}"'
                for k, v in labels) + "}"
        return base + suffix + lbl

    def render(self) -> str:
        lines = []
        seen_help: set[str] = set()

        def header(name: str, ptype: str):
            base = self.namespace + "_" + _NAME_RE.sub(
                "_", name.replace(".", "_"))
            if base not in seen_help:
                seen_help.add(base)
                lines.append(f"# TYPE {base} {ptype}")

        for (name, labels), v in sorted(self._counters.items()):
            header(name, "counter")
            lines.append(f"{self._series(name, labels)} {v:g}")
        for (name, labels), v in sorted(self._gauges.items()):
            header(name, "gauge")
            lines.append(f"{self._series(name, labels)} {v:g}")
        for (name, labels), (count, total) in sorted(self._hists.items()):
            header(name, "summary")
            lines.append(f"{self._series(name, labels, '_count')} {count:g}")
            lines.append(f"{self._series(name, labels, '_sum')} {total:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def flush(self) -> None:
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(self.render())
            os.replace(tmp, self.path)
        except OSError as e:
            _log.warning("prometheus sink %s failed: %s", self.path, e)
            try:
                if os.path.exists(tmp):
                    os.remove(tmp)
            except OSError:
                pass
