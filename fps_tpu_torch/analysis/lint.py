"""Source-hazard linter: the AST layer of the contract auditor.

Port of ``fps_tpu/analysis/lint.py``, its rules retargeted to
``fps_tpu_torch/``: each catches the hazard of the reference's rule under
the port's own spelling of it.

* **FPS001 closure-loop-var** — a closure defined inside a loop that reads
  the loop variable late-binds it: every call sees the LAST iteration's
  value. Bind it as a default argument (``lambda x, _v=v: ...``).
* **FPS002 tensor-bool-context** — ``if torch.any(t)``, ``while
  (a == b).all()``, ``assert torch.isfinite(x)``, ``bool(torch.any(t))``:
  a Python bool of a tensor predicate reads the tensor back, a hidden
  device synchronisation per call on the card. Keep the predicate on the
  device (``torch.where``) or test host values with ``np.*``.
* **FPS003 unsorted-traced-items** — dict iteration inside a compiled-fn
  builder. The port is eager; its compiled-fn builders are
  ``torch.compile``, ``torch.jit.script`` and CUDA-graph capture
  (``torch.cuda.graph``, ``make_graphed_callables``, ``CUDAGraph``): a
  function whose subtree calls one of them (or the reference's
  ``scan`` / ``fori_loop`` / ``while_loop`` / ``shard_map``) is a builder,
  and a graph captured over a dict's insertion history differs between two
  processes that built the dict differently. Iterate ``sorted(d.items())``.
* **FPS004 thread-shared-state** — a class that starts a
  ``threading.Thread``/``Timer`` without a synchronisation primitive or a
  ``thread-safety:`` note in its docstring.
* **FPS005 internal-shim-import** — importing the
  ``fps_tpu_torch.utils.profiling`` compat shim from inside the package.
* **FPS006 raw-snapshot-read** — ``open()`` / ``np.load`` / ``torch.load``
  of a checkpoint- or snapshot-flavoured path outside the CRC-verified
  readers (``core/checkpoint.py``, ``core/snapshot_format.py``,
  ``serve/``).
* **FPS007 host-clock-in-builder** — a host clock read inside a
  compiled-fn builder (FPS003's scope): read while capturing, it is a
  constant replayed by every launch.
* **FPS008 raw-socket-use** — ``socket.socket()`` /
  ``socket.create_connection()`` outside ``fps_tpu_torch/serve/``; speak
  ``fps_tpu_torch.serve.wire.WireClient``.
* **FPS009 raw-tenant-path** — a path call whose string arguments spell a
  tenant-namespace literal outside ``fps_tpu_torch/tenancy/paths.py``.
* **FPS010 table-materialisation** — ``np.asarray``/``np.array``/
  ``.copy()`` of a snapshot table view in the serve hot path.
* **FPS011 blocking-host-work-on-training-thread** — ``time.sleep`` /
  ``os.fsync`` / ``torch.cuda.synchronize`` / ``.synchronize()`` /
  ``.item()`` / ``.tolist()`` / ``.cpu()`` in the training-thread scope
  (``core/driver.py`` / ``core/megastep.py``): each is host-serial time on
  the training thread, and the device reads force a synchronisation with
  the card. The sanctioned seams, by function, are in
  ``_FPS011_ALLOW_FUNCS`` with their reasons.

Suppression: append ``# noqa: FPSNNN`` to the flagged line — but the
tier-1 test runs this linter over ``fps_tpu_torch/`` expecting zero
findings, so in-tree fixes are the norm, suppressions the exception.

Stdlib-only (ast): safe anywhere, imports neither torch nor jax.
"""

from __future__ import annotations

import ast
import dataclasses
import os

__all__ = ["LintFinding", "RULES", "lint_source", "lint_paths",
           "iter_py_files"]


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


# Rule id -> one-line rationale (the CLI's --explain output).
RULES = {
    "FPS001": "closure in a loop late-binds the loop variable — bind it "
              "as a default argument",
    "FPS002": "boolean branch on a tensor predicate (torch.any/all/..., "
              ".any()/.all(), bool(...)) — a hidden device sync per call",
    "FPS003": "unsorted dict iteration inside a compiled-fn builder "
              "(torch.compile / CUDA-graph capture) — iterate "
              "sorted(d.items())",
    "FPS004": "class starts a thread but declares no synchronization "
              "primitive or thread-safety note",
    "FPS005": "internal import of the fps_tpu_torch.utils.profiling "
              "shim — import from fps_tpu_torch.obs",
    "FPS006": "raw open()/np.load/torch.load of a checkpoint/snapshot "
              "path outside the CRC-verified readers (core/checkpoint.py, "
              "core/snapshot_format.py, serve/)",
    "FPS007": "host clock call (time.time/perf_counter/...) inside a "
              "compiled-fn builder — it bakes a capture-time constant "
              "into the graph; host timing stays in PhaseTimer",
    "FPS008": "raw socket use outside fps_tpu_torch/serve/ — every caller "
              "goes through the framed WireClient (deadlines, bounded "
              "retry, idempotent reconnect)",
    "FPS009": "hand-spelled tenant-namespace literal in a path call "
              "outside fps_tpu_torch/tenancy/paths.py — derive tenant paths "
              "from TenantPaths (or a mirrored *_DIRNAME constant)",
    "FPS010": "whole-table materialization (np.asarray/np.array/"
              ".copy()) of a snapshot table view in the serve hot path "
              "— answer off the mapped pages / DeltaView, or go "
              "through the sanctioned materialize() seam",
    "FPS011": "blocking host work (time.sleep/os.fsync/"
              "torch.cuda.synchronize/.synchronize()/.item()/.tolist()/"
              ".cpu()) in the training-thread scope of core/driver.py or "
              "core/megastep.py — capture, fsync, retry backoff and "
              "device reads belong on the writer / retrier threads or a "
              "sanctioned seam",
}

# Calls whose presence makes a function (and everything lexically inside
# it) a compiled-fn builder for FPS003/FPS007: the reference's jax
# builders, and the port's (torch.compile, torch.jit.script, CUDA-graph
# capture). The port's code has none today, so neither rule can fire on
# it; they stand for the day it captures graphs.
_TRACE_TRIGGERS = {"scan", "fori_loop", "while_loop", "shard_map",
                   "compile", "script", "graph", "make_graphed_callables",
                   "CUDAGraph"}

# FPS007: host wall-clock reads that are trace-time constants inside a
# compiled-fn builder. Bare names cover `from time import perf_counter`
# — including bare `time` itself (`from time import time; time()`),
# which can false-positive on a user callable named `time` inside a
# builder; rename it or `# noqa: FPS007`.
_HOST_CLOCKS = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.process_time", "time.thread_time",
    "time", "perf_counter", "monotonic", "process_time", "thread_time",
}

# torch predicates that return tensors — a device read in a bool context
# (torch.equal and torch.allclose return Python bools, read back all the
# same).
_TRACER_PREDICATES = {
    "any", "all", "isnan", "isinf", "isfinite", "allclose", "equal",
    "logical_and", "logical_or", "logical_not", "eq", "ne", "lt", "le",
    "gt", "ge", "not_equal", "less", "less_equal", "greater",
    "greater_equal", "isclose", "is_nonzero",
}
# Tensor methods that reduce to a predicate: ``(a == b).all()``.
_TENSOR_PREDICATE_METHODS = {"any", "all"}

# FPS006: name/attribute/string tokens marking an expression as
# checkpoint-flavored, and the files sanctioned to read snapshots raw
# (they ARE the verified readers / the on-disk-contract owner).
_CKPT_TOKENS = ("ckpt", "snapshot")
_CKPT_READER_PATHS = ("fps_tpu_torch/core/checkpoint.py",
                      "fps_tpu_torch/core/snapshot_format.py")
_CKPT_READER_DIRS = ("fps_tpu_torch/serve/",)
_CKPT_READ_CALLS = ("open", "np.load", "numpy.load", "torch.load")

# FPS008: raw socket constructors; only the wire/net modules under
# fps_tpu_torch/serve/ may call them — everything else speaks the framed
# protocol through WireClient (docs/serving.md). Both the dotted and
# the `from socket import ...` bare forms are flagged.
_RAW_SOCKET_CALLS = {
    "socket.socket", "socket.create_connection", "create_connection",
}
_SOCKET_OK_DIRS = ("fps_tpu_torch/serve/",)

# FPS009: path-constructing calls whose STRING arguments may not spell
# the tenant namespace by hand; only the helper module owns the layout.
# Mirrored Name constants (TENANTS_DIRNAME) pass — the rule keys on
# string literals, the typo-prone form.
_TENANT_PATH_CALLS = {
    "open", "os.path.join", "path.join", "os.makedirs", "os.listdir",
    "os.path.isdir", "os.path.isfile", "os.path.exists", "os.remove",
    "os.rmdir", "glob.glob", "glob.iglob", "Path", "pathlib.Path",
    "shutil.rmtree", "shutil.copytree",
}
_TENANT_TOKENS = ("tenants", "tenant.json")
_TENANT_HELPER_PATHS = ("fps_tpu_torch/tenancy/paths.py",)

# FPS010: the read plane's zero-copy contract (docs/serving.md
# "Read-plane throughput"): a snapshot table is a read-only-mmapped view
# (or a DeltaView overlay on one), and the serve hot path must answer
# off those pages — an np.asarray/np.array/.copy() of a TABLE there is
# an O(table) allocation per request, the exact regression the batched
# wire exists to kill. The ONE sanctioned densification seam is
# fps_tpu_torch.serve.snapshot.materialize() (and the DeltaView.__array__ it
# rides), so functions by those names are exempt.
_FPS010_MATERIALIZERS = {
    "np.asarray", "numpy.asarray", "np.array", "numpy.array",
    "np.ascontiguousarray", "numpy.ascontiguousarray",
}
_FPS010_ALLOW_FUNCS = {"__array__", "materialize"}
_FPS010_DIRS = ("fps_tpu_torch/serve/",)

# FPS011: the raw-speed contract: nothing on the training thread may
# sleep, fsync, or force a device->host synchronisation — the
# deferred-capture and background-retrier seams exist to absorb exactly
# that host-serial share. Scope is the two training-loop files. Both dotted
# and `from x import y` bare forms are flagged, and the device reads as
# methods (`.item()`, `.tolist()`, `.cpu()`, `.synchronize()`).
_FPS011_BLOCKING_CALLS = {
    "time.sleep", "sleep", "os.fsync", "fsync",
    "torch.cuda.synchronize", "cuda.synchronize",
}
_FPS011_BLOCKING_METHODS = {"synchronize", "item", "tolist", "cpu"}
_FPS011_PATHS = ("fps_tpu_torch/core/driver.py",
                 "fps_tpu_torch/core/megastep.py")
# Functions that ARE a sanctioned seam, each with its reason:
# * _writer_loop, _run_capture, _sidecar_retry_loop: the reference's
#   off-thread seams (writer loops and background retriers run on their
#   own threads — blocking there is the point);
# * group_votes (core/megastep.py): the megastep's overflow vote, one
#   host read of one small tensor a group of segments — the port's
#   departure from the reference's in-graph lax.cond, which has no eager
#   counterpart;
# * _to_host, to_host (core/driver.py): the as_numpy conversions, the
#   metrics and local state read at the caller's request (as_numpy=True,
#   on_chunk, a checkpoint's host copy);
# * collect (core/driver.py): the deferred capture's closure, which runs
#   on the checkpoint writer's thread and first waits for the boundary
#   copies' CUDA event (ready.synchronize()).
_FPS011_ALLOW_FUNCS = {"_writer_loop", "_run_capture",
                       "_sidecar_retry_loop", "group_votes", "_to_host",
                       "to_host", "collect"}

_SYNC_PRIMITIVES = {
    "Lock", "RLock", "Condition", "Event", "Semaphore",
    "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue", "LifoQueue",
}
_THREAD_STARTERS = {"Thread", "Timer"}


def _attr_chain(node) -> str:
    """Dotted name of an attribute/name chain ('' when not a chain)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(node) -> str:
    return _attr_chain(node.func) if isinstance(node, ast.Call) else ""


def _numpy_rooted(node) -> bool:
    """Whether an expression holds an ``np.`` / ``numpy.`` call (a host
    array's method, not a tensor's)."""
    return any(_call_name(n).startswith(("np.", "numpy."))
               for n in ast.walk(node))


def _items_call(node) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("items", "keys", "values")
            and not node.args)


def _bound_names(fn) -> set[str]:
    """Names a closure binds itself: parameters (defaults included by
    construction — a default REBINDS the name at def time, which is the
    sanctioned fix) plus names assigned in its body."""
    out = set()
    args = fn.args
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)):
        out.add(a.arg)
    if args.vararg:
        out.add(args.vararg.arg)
    if args.kwarg:
        out.add(args.kwarg.arg)
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Name) and isinstance(
                    n.ctx, (ast.Store, ast.Del)):
                out.add(n.id)
    return out


def _loop_target_names(node) -> set[str]:
    out = set()
    if isinstance(node, (ast.For, ast.AsyncFor)):
        for n in ast.walk(node.target):
            if isinstance(n, ast.Name):
                out.add(n.id)
    return out


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source_lines: list[str]):
        self.path = path
        self.lines = source_lines
        self.findings: list[LintFinding] = []
        norm = path.replace(os.sep, "/")
        self.is_shim = norm.endswith("fps_tpu_torch/utils/profiling.py")
        # FPS006 exemption: the sanctioned snapshot readers themselves.
        self.is_ckpt_reader = (
            any(norm.endswith(p) for p in _CKPT_READER_PATHS)
            or any(d in norm for d in _CKPT_READER_DIRS))
        # FPS008 exemption: the wire/net modules ARE the framed layer.
        self.is_wire_module = any(d in norm for d in _SOCKET_OK_DIRS)
        # FPS009 exemption: the tenant path helper owns the layout.
        self.is_tenant_helper = any(
            norm.endswith(p) for p in _TENANT_HELPER_PATHS)
        # FPS010 scope: only the serve hot path carries the zero-copy
        # contract; training/tools code materializes freely.
        self.is_serve_hot = any(d in norm for d in _FPS010_DIRS)
        # FPS011 scope: the training-thread files; depth of enclosing
        # sanctioned off-thread seams (writer loop / background
        # retrier defs).
        self.is_training_hot = any(
            norm.endswith(p) for p in _FPS011_PATHS)
        self._fps011_allow = 0
        self.imports_torch = False
        # Names assigned from table-view expressions (filled by
        # visit_Module's dataflow pre-pass).
        self._table_names: set[str] = set()
        # Depth of enclosing materialize()/__array__ defs — the
        # sanctioned densification seam.
        self._fps010_allow = 0
        # FPS001: stack of (loop_node, target_names) we are inside of.
        self._loops: list[tuple[ast.AST, set[str]]] = []
        # FPS003: depth of enclosing compiled-fn-builder functions.
        self._trace_depth = 0

    # -- plumbing ---------------------------------------------------------

    def _add(self, rule: str, node, message: str) -> None:
        line = getattr(node, "lineno", 1)
        src = self.lines[line - 1] if line - 1 < len(self.lines) else ""
        if f"noqa: {rule}" in src:
            return
        self.findings.append(LintFinding(rule, self.path, line, message))

    # -- FPS005 -----------------------------------------------------------

    def visit_Import(self, node):
        if not self.is_shim:
            for alias in node.names:
                if alias.name == "fps_tpu_torch.utils.profiling":
                    self._add("FPS005", node,
                              "import of the utils.profiling shim — use "
                              "fps_tpu_torch.obs (trace/Throughput live there)")
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        if not self.is_shim:
            mod = node.module or ""
            if mod == "fps_tpu_torch.utils.profiling" or (
                    mod == "fps_tpu_torch.utils"
                    and any(a.name == "profiling" for a in node.names)):
                self._add("FPS005", node,
                          "import of the utils.profiling shim — use "
                          "fps_tpu_torch.obs (trace/Throughput live there)")
        self.generic_visit(node)

    # -- FPS006 -----------------------------------------------------------

    def _ckpt_flavored(self, node) -> bool:
        """Any name/attribute/string in the call's arguments carrying a
        checkpoint token — the heuristic that 'this path is a snapshot'."""
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for n in ast.walk(arg):
                text = ""
                if isinstance(n, ast.Name):
                    text = n.id
                elif isinstance(n, ast.Attribute):
                    text = n.attr
                elif isinstance(n, ast.Constant) and isinstance(n.value, str):
                    text = n.value
                low = text.lower()
                if any(tok in low for tok in _CKPT_TOKENS):
                    return True
        return False

    def _tenant_flavored(self, node) -> bool:
        """A string literal in the call's arguments spelling the tenant
        namespace (``"tenants"`` path segment or the manifest name)."""
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for n in ast.walk(arg):
                if not (isinstance(n, ast.Constant)
                        and isinstance(n.value, str)):
                    continue
                low = n.value.lower()
                if ("tenant.json" in low or low == "tenants"
                        or "tenants/" in low
                        or low.endswith("/tenants")):
                    return True
        return False

    # -- FPS010 -----------------------------------------------------------

    def visit_Module(self, node):
        # FPS002's method form (``.any()`` / ``.all()``) applies in modules
        # that hold tensors: those that import torch (the serving plane,
        # numpy only, does not).
        self.imports_torch = any(
            (isinstance(n, ast.Import)
             and any(a.name.split(".")[0] == "torch" for a in n.names))
            or (isinstance(n, ast.ImportFrom)
                and (n.module or "").split(".")[0] == "torch")
            for n in ast.walk(node))
        # Dataflow pre-pass: names assigned from table-view expressions
        # anywhere in the file (iterated to a fixpoint so one level of
        # aliasing — q = snap.table(n); r = q — still carries flavor).
        if self.is_serve_hot:
            for _ in range(4):  # bounded: alias chains are short
                grew = False
                for n in ast.walk(node):
                    if (isinstance(n, ast.Assign)
                            and len(n.targets) == 1
                            and isinstance(n.targets[0], ast.Name)
                            and self._table_flavored(n.value)
                            and n.targets[0].id not in self._table_names):
                        self._table_names.add(n.targets[0].id)
                        grew = True
                if not grew:
                    break
        self.generic_visit(node)

    def _table_flavored(self, node) -> bool:
        """True for expressions that ARE a snapshot table view: a
        ``.table(...)`` accessor call, a ``.tables[...]`` subscript, a
        ``.base`` attribute (DeltaView's mapped base), or a name
        assigned from one. A SUBSCRIPT of a flavored expression is NOT
        flavored — ``table[ids]`` is the gather result (bounded by the
        request), and materializing it is the point."""
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            return bool(chain) and chain.split(".")[-1] == "table"
        if isinstance(node, ast.Subscript):
            chain = _attr_chain(node.value)
            return bool(chain) and chain.split(".")[-1] == "tables"
        if isinstance(node, ast.Attribute):
            return node.attr in ("base", "tables")
        if isinstance(node, ast.Name):
            return node.id in self._table_names
        return False

    def _check_fps010(self, node):
        if not self.is_serve_hot or self._fps010_allow:
            return
        name = _call_name(node)
        if (name in _FPS010_MATERIALIZERS and node.args
                and self._table_flavored(node.args[0])):
            self._add(
                "FPS010", node,
                f"{name}() of a snapshot table view in the serve hot "
                "path — an O(table) copy per request; answer off the "
                "mapped pages (fancy-index the view) or, when a dense "
                "whole table is genuinely needed, go through "
                "fps_tpu_torch.serve.snapshot.materialize()")
        elif (isinstance(node.func, ast.Attribute)
                and node.func.attr == "copy" and not node.args
                and self._table_flavored(node.func.value)):
            self._add(
                "FPS010", node,
                ".copy() of a snapshot table view in the serve hot "
                "path — an O(table) copy per request; answer off the "
                "mapped pages or go through "
                "fps_tpu_torch.serve.snapshot.materialize()")

    def _check_fps011(self, node):
        if not self.is_training_hot or self._fps011_allow:
            return
        name = _call_name(node)
        if name in _FPS011_BLOCKING_CALLS:
            self._add(
                "FPS011", node,
                f"{name}() on the training thread — sleeps, fsyncs, and "
                "forced device->host syncs are host-serial share; move "
                "them onto the checkpoint writer / background retrier "
                "(or core/autok.py's calibration window)")
        elif (isinstance(node.func, ast.Attribute)
                and node.func.attr in _FPS011_BLOCKING_METHODS):
            self._add(
                "FPS011", node,
                f".{node.func.attr}() on the training thread — a forced "
                "device->host sync serialises dispatch; adjudicate off "
                "host copies or move the read to a sanctioned seam")

    def visit_Call(self, node):
        self._check_fps010(node)
        self._check_fps011(node)
        self._check_bool_call(node)
        # FPS007: a host clock read under tracing is a constant, not a
        # measurement (the _trace_depth scope is FPS003's).
        if self._trace_depth and _call_name(node) in _HOST_CLOCKS:
            self._add(
                "FPS007", node,
                f"{_call_name(node)}() inside a compiled-fn builder — "
                "a host clock read at trace time bakes a constant into "
                "the program; host timing stays in PhaseTimer "
                "(fps_tpu_torch.obs.timing), outside the builders")
        if not self.is_ckpt_reader:
            name = _call_name(node)
            if (name in _CKPT_READ_CALLS
                    and self._ckpt_flavored(node)):
                self._add(
                    "FPS006", node,
                    f"{name}() of a checkpoint/snapshot path — go through "
                    "the CRC-verified readers (Checkpointer.read_snapshot, "
                    "snapshot_format.verify_snapshot_file + "
                    "map_snapshot_arrays, or fps_tpu_torch.serve)")
        # FPS009: a hand-spelled tenant-namespace literal in a path call
        # is one typo from writing into a neighbor's blast radius.
        if (not self.is_tenant_helper
                and _call_name(node) in _TENANT_PATH_CALLS
                and self._tenant_flavored(node)):
            self._add(
                "FPS009", node,
                f"{_call_name(node)}() spells the tenant namespace by "
                "hand — derive checkpoint/obs/sidecar paths from "
                "fps_tpu_torch.tenancy.TenantPaths (stdlib-only tools: a "
                "mirrored TENANTS_DIRNAME constant)")
        # FPS008: raw sockets outside the wire layer dodge deadlines,
        # bounded retry, and the idempotent reconnect contract.
        if (not self.is_wire_module
                and _call_name(node) in _RAW_SOCKET_CALLS):
            self._add(
                "FPS008", node,
                f"{_call_name(node)}() outside fps_tpu_torch/serve/ — speak "
                "the framed wire through "
                "fps_tpu_torch.serve.wire.WireClient "
                "(per-request deadlines, classified bounded retry, "
                "request-id dedupe on reconnect)")
        self.generic_visit(node)

    # -- FPS002 -----------------------------------------------------------

    def _tracer_predicate(self, test):
        """The tensor predicate inside a bool-context test, if any: a
        ``torch.<predicate>(...)`` call or an ``.any()`` / ``.all()``
        method call."""
        stack = [test]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.BoolOp):
                stack.extend(n.values)
            elif isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
                stack.append(n.operand)
            elif isinstance(n, ast.Call):
                name = _call_name(n)
                if name.startswith("torch.") and (
                        name.split(".", 1)[1] in _TRACER_PREDICATES):
                    return name
                if (self.imports_torch
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr in _TENSOR_PREDICATE_METHODS
                        and not n.args
                        and not _numpy_rooted(n.func.value)):
                    return f".{n.func.attr}"
        return None

    def _check_bool_context(self, node):
        name = self._tracer_predicate(node.test)
        if name:
            self._add("FPS002", node,
                      f"branch on {name}(...) — a device read per call on "
                      "the card; keep it on the device (torch.where) or "
                      "test host values with np.*")

    def _check_bool_call(self, node):
        """``bool(<tensor predicate>)`` outside a branch."""
        if _call_name(node) == "bool" and len(node.args) == 1:
            name = self._tracer_predicate(node.args[0])
            if name:
                self._add("FPS002", node,
                          f"bool({name}(...)) — a device read per call on "
                          "the card; keep it on the device (torch.where) "
                          "or test host values with np.*")

    def visit_If(self, node):
        self._check_bool_context(node)
        self.generic_visit(node)

    def visit_Assert(self, node):
        self._check_bool_context(node)
        self.generic_visit(node)

    # -- FPS001 + loops ---------------------------------------------------

    def visit_While(self, node):
        self._check_bool_context(node)
        self._visit_loop(node)

    def visit_For(self, node):
        self._visit_loop(node)

    visit_AsyncFor = visit_For

    def _visit_loop(self, node):
        self._loops.append((node, _loop_target_names(node)))
        self.generic_visit(node)
        self._loops.pop()

    def _check_closure(self, node):
        """FPS001 on a def/lambda lexically inside >=1 loop."""
        if not self._loops:
            return
        bound = _bound_names(node)
        free: set[str] = set()
        body = node.body if isinstance(node.body, list) else [node.body]
        for stmt in body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                    free.add(n.id)
        free -= bound
        for _loop, targets in self._loops:
            captured = sorted(free & targets)
            if captured:
                self._add("FPS001", node,
                          f"closure captures loop variable(s) "
                          f"{', '.join(captured)} by reference — bind as "
                          "a default argument (late-binding traces every "
                          "program against the last iteration's value)")
                return

    # -- FPS003 + function scopes ----------------------------------------

    def _subtree_is_builder(self, node) -> bool:
        for n in ast.walk(node):
            name = _call_name(n)
            if name and name.split(".")[-1] in _TRACE_TRIGGERS:
                return True
        return False

    def visit_FunctionDef(self, node):
        self._check_closure(node)
        entered = False
        if self._trace_depth == 0 and self._subtree_is_builder(node):
            self._trace_depth += 1
            entered = True
        elif self._trace_depth:
            self._trace_depth += 1
            entered = True
        # FPS010 seam: materialize()/__array__ ARE the sanctioned
        # densification path — their bodies may copy.
        allow = node.name in _FPS010_ALLOW_FUNCS
        if allow:
            self._fps010_allow += 1
        # FPS011 seam: writer-loop / background-retrier defs run on
        # their own threads — blocking there is the point.
        allow11 = node.name in _FPS011_ALLOW_FUNCS
        if allow11:
            self._fps011_allow += 1
        self.generic_visit(node)
        if allow11:
            self._fps011_allow -= 1
        if allow:
            self._fps010_allow -= 1
        if entered:
            self._trace_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._check_closure(node)
        self.generic_visit(node)

    def _check_items_iter(self, iter_node, where):
        if self._trace_depth == 0:
            return
        # A sorted()/reversed() wrapper never reaches here: the iter
        # node is then a Name call, not the .items() Attribute call
        # _items_call matches.
        if _items_call(iter_node):
            attr = iter_node.func.attr
            self._add("FPS003", where,
                      f"unsorted .{attr}() iteration inside a compiled-fn "
                      "builder — tree construction must not depend on "
                      "dict insertion history; iterate "
                      f"sorted(....{attr}())")

    def visit_comprehension(self, node):
        self._check_items_iter(node.iter, node.iter)
        self.generic_visit(node)

    def _check_for_iter(self, node):
        self._check_items_iter(node.iter, node)

    # -- FPS004 -----------------------------------------------------------

    def visit_ClassDef(self, node):
        starts_thread = None
        has_sync = False
        for n in ast.walk(node):
            name = _call_name(n)
            if not name:
                continue
            leaf = name.split(".")[-1]
            root = name.split(".")[0]
            if leaf in _THREAD_STARTERS and root in ("threading", leaf):
                starts_thread = starts_thread or n
            if leaf in _SYNC_PRIMITIVES and root in ("threading", "queue",
                                                     leaf):
                has_sync = True
        if starts_thread is not None and not has_sync:
            doc = (ast.get_docstring(node) or "").lower()
            if "thread-safety" not in doc and "thread safety" not in doc:
                self._add(
                    "FPS004", starts_thread,
                    f"class {node.name} starts a thread but declares no "
                    "synchronization primitive (Lock/Condition/Event/"
                    "Queue) and no 'thread-safety:' docstring note")
        self.generic_visit(node)


def lint_source(source: str, path: str = "<string>") -> list[LintFinding]:
    """Lint one Python source string; returns findings (empty = clean)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [LintFinding("FPS000", path, e.lineno or 1,
                            f"syntax error: {e.msg}")]
    linter = _Linter(path, source.splitlines())
    # ast.NodeVisitor has no hook ordering for For.iter vs For body with
    # the trace-depth state; run the main visit, then a focused second
    # walk for for-loop iterables (comprehensions are handled inline).
    linter.visit(tree)
    _walk_for_iters(tree, linter)
    return sorted(linter.findings, key=lambda f: (f.path, f.line, f.rule))


def _walk_for_iters(tree, linter: _Linter) -> None:
    """Second pass for FPS003 on ``for`` statements: re-derive the
    trace-depth context per loop (statement position, not visit order)."""

    def walk(node, depth):
        for child in ast.iter_child_nodes(node):
            d = depth
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if d or linter._subtree_is_builder(child):
                    d += 1
            if isinstance(child, (ast.For, ast.AsyncFor)) and d:
                linter._trace_depth = d
                linter._check_for_iter(child)
                linter._trace_depth = 0
            walk(child, d)

    walk(tree, 0)


def iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def lint_paths(paths, select=None) -> list[LintFinding]:
    """Lint every ``.py`` under ``paths``; ``select`` filters rule ids."""
    findings: list[LintFinding] = []
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        for finding in lint_source(src, path):
            if select is None or finding.rule in select:
                findings.append(finding)
    return findings
