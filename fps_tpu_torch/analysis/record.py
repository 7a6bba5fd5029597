"""The program record: what one eager call of the step loop does.

The JAX package audits the program it compiles: ``jit(...).lower(...)
.as_text()`` gives the StableHLO of one call of the step loop, and the
passes read its collectives, host callbacks, donated buffers and float
widths. The port compiles no program. Its counterpart of lowering is a
record of one eager call of ``Trainer._run_steps`` (the chunk and indexed
programs) or of one megastep dispatch, taken on the training thread while
the call runs, and a :class:`ProgramRecord` offers the passes the same
program model :class:`~fps_tpu_torch.analysis.hlo.HloProgram` does: ``ops``
(each with ``kind``, ``line``, ``text``, ``payload_bytes``,
``replica_groups``, ``group_size`` and ``custom_target``), ``args`` and
``results`` with their donation evidence, ``collectives(min_bytes)``,
``by_kind`` and ``profile``.

What is recorded, and where:

* **Collectives**, at the public functions of
  :mod:`fps_tpu_torch.parallel.collectives` (so one process and several
  give the same record): ``all_gather`` as ``all_gather``, ``psum_scatter``
  as ``reduce_scatter``, ``all_to_all`` as ``all_to_all``, ``psum``,
  ``pmax``, ``pmin`` and ``sum_home_each`` (the metrics' ``psum`` over the
  shard axis, then the data axis) as ``all_reduce``. Their groups are the
  axis's (:func:`~fps_tpu_torch.parallel.collectives.groups`; the whole
  mesh for ``sum_home_each``); the payload is the largest tensor one
  position sends or receives, numel times itemsize. ``replicate``,
  ``broadcast`` and ``gather_home`` are placement, the JAX program's
  in- and out-shardings, and are recorded under their own names, which no
  census counts. Nothing inside a recorded collective is recorded again.
* **Kernels**: each K1-K5 call at the :mod:`fps_tpu_torch.ops` route, by
  kernel name (``kind`` ``"kernel"``, the name as ``custom_target``), where
  the kernel would launch; the CPU's plain version and the card's kernel
  give the same entry. Device work, not a host transfer.
* **Host transfers**: ``tolist``, ``numpy``, ``item``, ``__bool__``,
  ``__int__``, ``__float__``, ``__index__`` and ``cpu`` on a tensor, and a
  ``to`` onto the CPU from a program whose mesh is on the card, seen by a
  ``torch.overrides.TorchFunctionMode``, named by call site.
* **Dtype drift**: every op whose result holds float64, and every op whose
  float result is wider than its widest float input (``kind``
  ``"convert"``), with a StableHLO-like signature as its ``text`` so the
  dtype pass reads widths as it reads them in StableHLO.
* **Donation**: each canonical table is an argument and a result
  (``[0]['name']``) of its block's type; the argument is donated when every
  block of the table kept its storage across the call.

Lowered text shows a loop body once. So the record keeps one entry per
call site, kind, replica groups and occurrence within a step (the k-th
such call since the step began; the driver marks the steps), with its
largest payload and its dynamic count beside it. A window's reconcile and
an SSP round's snapshot appear once, as in a lowered ``cond``, and a
megastep's census does not depend on how many segments it fuses.

The text form (:meth:`ProgramRecord.to_text`, :meth:`ProgramRecord.
from_text`) is a header line and one JSON object a line; it parses with
neither torch nor jax. The recording itself (:func:`record_call`) imports
torch when it runs; this module does not at import.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import threading

from fps_tpu_torch.analysis.hlo import (
    COLLECTIVE_KINDS,
    Collective,
    HloArg,
    HloResult,
)

__all__ = [
    "RECORD_HEADER", "ProgramRecord", "RecordOp", "is_record_text",
    "record_call", "active", "mark_step", "recorded_collective",
]

RECORD_HEADER = "fps-program-record v1"

#: The ``kind`` of a host transfer and of a kernel entry.
HOST_TRANSFER = "host_transfer"
KERNEL = "kernel"

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_HERE = os.path.abspath(__file__)
_PKG = os.path.join(_REPO, "fps_tpu_torch")
# Frames skipped when naming a call site: this module, the collectives and
# the kernels' route (a site is where the step loop calls them).
_SKIP = {_HERE, os.path.join(_PKG, "parallel", "collectives.py"),
         os.path.join(_PKG, "ops", "__init__.py")}

_LOCAL = threading.local()
_DTYPE_NAMES = {
    "float64": "f64", "float32": "f32", "float16": "f16", "bfloat16": "bf16",
    "int64": "i64", "int32": "i32", "int16": "i16", "int8": "i8",
    "uint8": "ui8", "bool": "i1", "complex64": "c64", "complex128": "c128",
}


def is_record_text(text: str) -> bool:
    """Whether ``text`` is a program record's text form."""
    return text.lstrip().startswith(RECORD_HEADER)


# ---------------------------------------------------------------------------
# The program model.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecordOp:
    """One entry of the record: an :class:`~fps_tpu_torch.analysis.hlo.
    HloOp`'s fields, plus its call ``site`` (``path:line``), the
    ``function`` it is in, its occurrence within a step and its dynamic
    ``count`` over the call."""

    kind: str
    line: int
    text: str
    payload_bytes: int
    replica_groups: tuple[tuple[int, ...], ...] | None = None
    group_size: int | None = None
    custom_target: str | None = None
    site: str = ""
    function: str = ""
    occurrence: int = 0
    count: int = 1

    @property
    def is_collective(self) -> bool:
        return self.kind in COLLECTIVE_KINDS

    @property
    def site_function(self) -> str:
        """``path:function``: how a contract names a sanctioned site."""
        return f"{self.site.rsplit(':', 1)[0]}:{self.function}"

    def to_json(self) -> dict:
        d = {"op": self.kind, "site": self.site, "function": self.function,
             "occurrence": self.occurrence, "count": self.count,
             "payload_bytes": self.payload_bytes, "text": self.text}
        if self.replica_groups is not None:
            d["replica_groups"] = [list(g) for g in self.replica_groups]
        if self.group_size is not None:
            d["group_size"] = self.group_size
        if self.custom_target is not None:
            d["target"] = self.custom_target
        return d


class ProgramRecord:
    """The parsed model of one record (the shape of
    :class:`~fps_tpu_torch.analysis.hlo.HloProgram`)."""

    def __init__(self, program: str, ops, args, results, text: str = ""):
        self.program = program
        self.ops: list[RecordOp] = list(ops)
        self.args: list[HloArg] = list(args)
        self.results: list[HloResult] = list(results)
        self.text = text

    # -- text -------------------------------------------------------------

    def to_text(self) -> str:
        if self.text:
            return self.text
        lines = [RECORD_HEADER, json.dumps({"program": self.program})]
        for a in self.args:
            lines.append(json.dumps({"arg": a.index, "type": a.type,
                                     "donated": a.donated,
                                     "table": _table_of(a.attrs)}))
        for r in self.results:
            lines.append(json.dumps({"result": r.index, "type": r.type,
                                     "info": r.info}))
        for op in self.ops:
            lines.append(json.dumps(op.to_json()))
        return "\n".join(lines) + "\n"

    @classmethod
    def from_text(cls, text: str) -> "ProgramRecord":
        lines = text.splitlines()
        if not lines or lines[0].strip() != RECORD_HEADER:
            raise ValueError("not a program record: the first line must be "
                             f"{RECORD_HEADER!r}")
        program, ops, args, results = "", [], [], []
        for i, raw in enumerate(lines[1:], start=2):
            if not raw.strip():
                continue
            d = json.loads(raw)
            if "program" in d:
                program = d["program"]
            elif "arg" in d:
                args.append(HloArg(
                    index=int(d["arg"]), type=d["type"],
                    donated=bool(d["donated"]),
                    attrs=f'{{table = "{d.get("table", "")}"}}'))
            elif "result" in d:
                results.append(HloResult(index=int(d["result"]),
                                         type=d["type"], info=d["info"]))
            else:
                groups = d.get("replica_groups")
                ops.append(RecordOp(
                    kind=d["op"], line=i, text=d.get("text", ""),
                    payload_bytes=int(d.get("payload_bytes", 0)),
                    replica_groups=(tuple(tuple(int(x) for x in g)
                                          for g in groups)
                                    if groups is not None else None),
                    group_size=d.get("group_size"),
                    custom_target=d.get("target"),
                    site=d.get("site", ""), function=d.get("function", ""),
                    occurrence=int(d.get("occurrence", 0)),
                    count=int(d.get("count", 1))))
        return cls(program, ops, args, results, text=text)

    # -- queries (HloProgram's) -------------------------------------------

    def by_kind(self, kind: str) -> list[RecordOp]:
        return [op for op in self.ops if op.kind == kind]

    def collectives(self, min_bytes: int = 1024) -> list[RecordOp]:
        """Cross-shard collectives whose payload is at least ``min_bytes``,
        singleton groups excluded, as :meth:`HloProgram.collectives
        <fps_tpu_torch.analysis.hlo.HloProgram.collectives>`: an entry
        counts once, however often the call ran it."""
        return [op for op in self.ops if op.is_collective
                and not (op.group_size is not None and op.group_size <= 1)
                and op.payload_bytes >= min_bytes]

    def profile(self, min_bytes: int = 1024) -> list[Collective]:
        return [Collective(op.kind, op.payload_bytes, op.replica_groups,
                           op.group_size)
                for op in self.collectives(min_bytes)]

    # -- queries of the record's own ---------------------------------------

    def kernel_counts(self) -> dict[str, int]:
        """Launches of each kernel over the call (the dynamic counts)."""
        out: dict[str, int] = {}
        for op in self.by_kind(KERNEL):
            out[op.custom_target] = out.get(op.custom_target, 0) + op.count
        return dict(sorted(out.items()))

    def host_transfers(self) -> list[RecordOp]:
        return self.by_kind(HOST_TRANSFER)

    def host_reads(self) -> int:
        """Host transfers over the call (the dynamic counts)."""
        return sum(op.count for op in self.host_transfers())


def _table_of(attrs: str) -> str:
    start = attrs.find('table = "')
    if start < 0:
        return ""
    start += len('table = "')
    return attrs[start:attrs.index('"', start)]


# ---------------------------------------------------------------------------
# Recording.
# ---------------------------------------------------------------------------

def active():
    """The recording on this thread, or ``None``."""
    return getattr(_LOCAL, "rec", None)


def mark_step() -> None:
    """A step of the loop begins: occurrences count from 0 again. The
    driver calls it at every step; nothing happens unless a recording is
    on this thread."""
    rec = getattr(_LOCAL, "rec", None)
    if rec is not None:
        rec.seen.clear()


def _tensor_type(t) -> str:
    dims = "x".join(str(int(d)) for d in t.shape)
    dt = _DTYPE_NAMES.get(str(t.dtype).replace("torch.", ""), "unknown")
    return f"tensor<{dims}x{dt}>" if dims else f"tensor<{dt}>"


def _tensors(x, out):
    """Every tensor in ``x`` (a tensor, or nested lists and tuples)."""
    import torch

    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _site():
    """``(path:line, function)`` of the innermost frame outside this module,
    the collectives, the kernels' route and torch."""
    torch_dir = os.path.dirname(sys.modules["torch"].__file__)
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if fn not in _SKIP and not fn.startswith(torch_dir):
            break
        f = f.f_back
    if f is None:
        return "?:0", "?"
    fn = os.path.abspath(f.f_code.co_filename)
    rel = (os.path.relpath(fn, _REPO).replace(os.sep, "/")
           if fn.startswith(_REPO + os.sep) else os.path.basename(fn))
    return f"{rel}:{f.f_lineno}", f.f_code.co_name


def _axis_groups(mesh, axis):
    D, S = mesh.shape["data"], mesh.shape["shard"]
    if axis == "shard":
        return tuple(tuple(d * S + s for s in range(S)) for d in range(D))
    if axis == "data":
        return tuple(tuple(d * S + s for d in range(D)) for s in range(S))
    raise ValueError(f"unknown mesh axis {axis!r}")


class _Recording:
    """One call's entries (see the module docstring), keyed by call site,
    kind, groups, target and occurrence within the step."""

    def __init__(self, program: str, off_cpu: bool):
        self.program = program
        self.off_cpu = off_cpu
        self.entries: dict[tuple, dict] = {}
        self.seen: dict[tuple, int] = {}
        self.depth = 0

    def note(self, kind, payload, text, *, groups=None, target=None):
        site, function = _site()
        base = (site, function, kind, groups, target)
        k = self.seen.get(base, 0)
        self.seen[base] = k + 1
        e = self.entries.get(base + (k,))
        if e is None:
            self.entries[base + (k,)] = {
                "kind": kind, "site": site, "function": function,
                "occurrence": k, "count": 1, "payload": payload,
                "text": text, "groups": groups, "target": target}
        else:
            e["count"] += 1
            if payload > e["payload"]:
                e["payload"], e["text"] = payload, text

    def collective(self, kind, fn, mesh, xs, args, kwargs):
        self.depth += 1
        try:
            out = fn(mesh, xs, *args, **kwargs)
        finally:
            self.depth -= 1
        ins, outs = _tensors(xs, []), _tensors(out, [])
        payload = max((_nbytes(t) for t in ins + outs), default=0)
        groups = None
        if kind == "all_reduce" and fn.__name__ == "sum_home_each":
            groups = (tuple(range(mesh.shape["data"]
                                  * mesh.shape["shard"])),)
        elif kind in COLLECTIVE_KINDS:
            axis = args[0] if args else kwargs["axis"]
            groups = _axis_groups(mesh, axis)
        sig = (f"{kind} ({_tensor_type(ins[0]) if ins else ''}) -> "
               f"{_tensor_type(outs[0]) if outs else ''}")
        self.note(kind, payload, sig, groups=groups)
        return out

    def kernel(self, name, call, tensors, launches: bool):
        if launches:
            sig = f"{name} ({', '.join(_tensor_type(t) for t in tensors)})"
            self.note(KERNEL, max(_nbytes(t) for t in tensors), sig,
                      target=name)
        self.depth += 1
        try:
            return call()
        finally:
            self.depth -= 1

    def records(self, args, results) -> ProgramRecord:
        ops = []
        for e in self.entries.values():
            groups = e["groups"]
            ops.append(RecordOp(
                kind=e["kind"], line=0, text=e["text"],
                payload_bytes=e["payload"], replica_groups=groups,
                group_size=len(groups[0]) if groups else None,
                custom_target=e["target"], site=e["site"],
                function=e["function"], occurrence=e["occurrence"],
                count=e["count"]))
        text = ProgramRecord(self.program, ops, args, results).to_text()
        return ProgramRecord.from_text(text)


def recorded_collective(kind: str):
    """Decorate a public collective ``fn(mesh, xs, ...)``: while a recording
    is on the calling thread (and not already inside a recorded call), the
    call is recorded as ``kind``; otherwise it runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(mesh, xs, *args, **kwargs):
            rec = getattr(_LOCAL, "rec", None)
            if rec is None or rec.depth:
                return fn(mesh, xs, *args, **kwargs)
            return rec.collective(kind, fn, mesh, xs, args, kwargs)
        return call
    return wrap


_MODE = None


def _mode_class():
    """The ``TorchFunctionMode`` that sees host transfers and float widths
    (made once, at the first recording: this module imports no torch)."""
    global _MODE
    if _MODE is not None:
        return _MODE
    import torch
    from torch.overrides import TorchFunctionMode

    T = torch.Tensor
    host = {T.tolist: "tolist", T.numpy: "numpy", T.item: "item",
            T.__bool__: "__bool__", T.__int__: "__int__",
            T.__float__: "__float__", T.__index__: "__index__",
            T.cpu: "cpu"}
    widths = {torch.float16: 16, torch.bfloat16: 16, torch.float32: 32,
              torch.float64: 64}

    def onto_cpu(args, kwargs) -> bool:
        for a in list(args[1:]) + list(kwargs.values()):
            if isinstance(a, (str, torch.device)):
                return torch.device(a).type == "cpu"
            if isinstance(a, T):
                return a.device.type == "cpu"
        return False

    class _Mode(TorchFunctionMode):
        def __init__(self, rec):
            super().__init__()
            self.rec = rec

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            rec = self.rec
            if rec.depth:
                return func(*args, **kwargs)
            name = host.get(func)
            if name is None and func is T.to and rec.off_cpu and \
                    onto_cpu(args, kwargs):
                name = "to"
            if name is not None and args and isinstance(args[0], T):
                rec.note(HOST_TRANSFER, _nbytes(args[0]),
                         f"{name} ({_tensor_type(args[0])})", target=name)
            out = func(*args, **kwargs)
            self._dtype(func, args, kwargs, out)
            return out

        def _dtype(self, func, args, kwargs, out):
            outs = [t for t in _tensors(out, []) if t.dtype in widths]
            if not outs:
                return
            w_out = max(widths[t.dtype] for t in outs)
            ins = [t for t in _tensors(list(args) + list(kwargs.values()),
                                       []) if t.dtype in widths]
            w_in = max((widths[t.dtype] for t in ins), default=0)
            if w_out <= 32 and not (ins and w_out > w_in):
                return
            kind = "convert" if ins and w_out > w_in else getattr(
                func, "__name__", "op")
            sig = (f"({', '.join(_tensor_type(t) for t in ins)}) -> "
                   f"{_tensor_type(outs[0])}")
            self.rec.note(kind, max(_nbytes(t) for t in outs),
                          f"{getattr(func, '__name__', 'op')} {sig}")

    _MODE = _Mode
    return _MODE


def _storage(blocks) -> list[int]:
    return [b.untyped_storage().data_ptr() for b in blocks]


def record_call(program: str, tables: dict, call, *, off_cpu: bool):
    """Run ``call()`` (returning ``(tables, ...)``) with a recording on this
    thread and return ``(its result, the ProgramRecord)``. ``tables``: the
    call's canonical tables, ``{name: blocks}``; the returned tables must
    hold the same names. ``off_cpu``: the program's mesh is on the card (a
    ``to`` onto the CPU is then a host transfer). An exception of the call
    propagates as it would unrecorded, with the recording taken off the
    thread."""
    if getattr(_LOCAL, "rec", None) is not None:
        raise RuntimeError("a recording is already on this thread")
    rec = _Recording(program, off_cpu)
    names = sorted(tables)
    before = {n: _storage(tables[n]) for n in names}
    types = {n: _tensor_type(tables[n][0]) for n in names}
    _LOCAL.rec = rec
    try:
        with _mode_class()(rec):
            out = call()
    finally:
        _LOCAL.rec = None
    args, results = [], []
    for i, n in enumerate(names):
        after = out[0][n]
        args.append(HloArg(index=i, type=types[n],
                           donated=_storage(after) == before[n],
                           attrs=f'{{table = "{n}"}}'))
        results.append(HloResult(index=i, type=_tensor_type(after[0]),
                                 info=f"[0]['{n}']"))
    return out, rec.records(args, results)
