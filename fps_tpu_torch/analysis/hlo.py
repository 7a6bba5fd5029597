"""StableHLO program model: the parse layer under the pass suite.

Port of ``fps_tpu/analysis/hlo.py``, a copy of its pure-text layer:
:class:`HloProgram` parses a lowered StableHLO module (the JAX package's
``jax.jit(...).lower(...).as_text()``) into a flat op list (payload bytes,
replica groups, custom-call targets) plus the ``@main`` argument and result
metadata (donation markers, ``jax.result_info`` paths) that the passes
(:mod:`fps_tpu_torch.analysis.passes`) audit. The port itself compiles no
program: its programs are :class:`~fps_tpu_torch.analysis.record.
ProgramRecord` records of one eager call, which offer the same model.
This layer stays so that the port's command line certifies saved StableHLO
dumps, and so that the parity tests hold the port's passes against the JAX
package's on the same text.

:func:`collective_profile` and :func:`count_collectives` take either text:
a record's text (it starts with
:data:`~fps_tpu_torch.analysis.record.RECORD_HEADER`) is read as a
record, any other text as StableHLO.

Parsing is line-based, matching the textual form jax 0.4.x emits, and
tolerant: unknown ops are still modelled (kind and types). Pure text: this
module imports neither torch nor jax.
"""

from __future__ import annotations

import dataclasses
import json
import re

# Cross-shard data-plane collectives (the set bench.py's tiered A/B counts).
COLLECTIVE_KINDS = (
    "all_gather",
    "all_reduce",
    "all_to_all",
    "reduce_scatter",
    "collective_permute",
)

# Infrastructure custom_calls jax/XLA emit for sharding annotation and
# shard_map manual-mode boundaries — pure metadata, no host transfer.
INFRA_CUSTOM_CALLS = frozenset({
    "Sharding",
    "SPMDFullToShardShape",
    "SPMDShardToFullShape",
    "annotate_device_placement",
})

_OP_RE = re.compile(r'^\s*%\S+\s*=\s*"?stablehlo\.([a-z_0-9]+)"?')
_TENSOR_RE = re.compile(r"tensor<([0-9]+(?:x[0-9]+)*)x([a-z]+[0-9]+)>")
_GROUPS_RE = re.compile(
    r"replica_groups\s*=\s*dense<(.*?)>\s*:\s*tensor<([0-9]+)x([0-9]+)xi64>"
)
_TARGET_RE = re.compile(r"custom_call\s+@([A-Za-z0-9_.]+)")
# Attribute dicts on @main args/results may hold quoted strings that
# themselves contain braces (mhlo.sharding = "{devices=[8,1]<=[8]}") —
# a naive [^}]* stops inside the quote and drops every attribute sorted
# after it (tf.aliasing_output sorts after mhlo.sharding). Allow quoted
# runs and one level of brace nesting.
_ATTRS = r'\{(?:[^{}"]|"[^"]*"|\{[^{}]*\})*\}'
_ARG_RE = re.compile(
    r"%arg(\d+):\s*(tensor<[^>]*>|![^,\s){]+)\s*(" + _ATTRS + r")?"
)
_RESULT_INFO_RE = re.compile(r'jax\.result_info\s*=\s*"([^"]*)"')
# Float element types inside tensor<...> forms: the dims and dtype are
# one word-char run ("64x8xf32"), so anchor on the preceding 'x' or '<'
# instead of a word boundary.
_FLOAT_RE = re.compile(r"[x<](bf16|f16|f32|f64)\b")

# How far past a region-opening op line the closing `})` carrying the
# operand/result signature may sit (all_reduce bodies are 3-4 lines).
_REGION_LOOKAHEAD = 12


def tensor_bytes(type_str: str) -> int:
    """Largest tensor payload (numel * itemsize) named in ``type_str``.

    Same semantics as the original ``bench.count_collectives`` helper:
    scalars (``tensor<f32>``) don't match, sub-byte dtypes (i1) floor to
    0 — the accounting tracks bulk data-plane traffic, not flags."""
    best = 0
    for dims, dt in _TENSOR_RE.findall(type_str):
        size = 1
        for d in dims.split("x"):
            size *= int(d)
        best = max(best, size * (int(re.sub(r"[a-z]+", "", dt)) // 8))
    return best


def float_widths(type_str: str) -> list[int]:
    """Bit widths of every float element type named in ``type_str``
    (``bf16`` reports 16)."""
    out = []
    for m in _FLOAT_RE.finditer(type_str):
        tok = m.group(1)
        out.append(16 if tok == "bf16" else int(tok[1:]))
    return out


def _parse_groups(content: str, n: int, m: int):
    """``dense<...>`` replica-groups payload → tuple of id tuples.

    Bracketed form is JSON-compatible after whitespace normalization; the
    splat form (``dense<0> : tensor<1x1xi64>``) only occurs for the
    trivial single-group case."""
    content = content.strip()
    if content.startswith("["):
        try:
            groups = json.loads(content)
            return tuple(tuple(int(i) for i in g) for g in groups)
        except (ValueError, TypeError):
            return None
    try:
        v = int(content)
    except ValueError:
        return None
    if n == 1 and m == 1:
        return ((v,),)
    return None  # splat over a non-trivial shape: shape info only


@dataclasses.dataclass(frozen=True)
class Collective:
    """One cross-shard collective, as the structured profile reports it:
    ``(kind, payload_bytes, replica_groups)`` plus the group size used
    for the singleton-mesh-axis exclusion."""

    kind: str
    payload_bytes: int
    replica_groups: tuple[tuple[int, ...], ...] | None
    group_size: int | None = None

    def as_tuple(self):
        return (self.kind, self.payload_bytes, self.replica_groups)


@dataclasses.dataclass(frozen=True)
class HloOp:
    """One ``stablehlo.*`` op line (region signatures folded in)."""

    kind: str
    line: int  # 1-indexed line number of the op in the module text
    text: str
    payload_bytes: int
    replica_groups: tuple[tuple[int, ...], ...] | None = None
    group_size: int | None = None
    custom_target: str | None = None

    @property
    def is_collective(self) -> bool:
        return self.kind in COLLECTIVE_KINDS


@dataclasses.dataclass(frozen=True)
class HloArg:
    """One ``@main`` argument: type plus whether jax marked its buffer
    as donated (``jax.buffer_donor``) / aliased to an output
    (``tf.aliasing_output``)."""

    index: int
    type: str
    donated: bool
    attrs: str = ""


@dataclasses.dataclass(frozen=True)
class HloResult:
    """One ``@main`` result: type plus the ``jax.result_info`` path
    (e.g. ``[0]['weights']`` — element 0 of the return tuple, dict key
    'weights')."""

    index: int
    type: str
    info: str = ""


class HloProgram:
    """Parsed model of one lowered StableHLO module."""

    def __init__(self, text: str, ops, args, results):
        self.text = text
        self.ops: list[HloOp] = list(ops)
        self.args: list[HloArg] = list(args)
        self.results: list[HloResult] = list(results)

    # -- construction -----------------------------------------------------

    @classmethod
    def from_text(cls, text: str) -> "HloProgram":
        lines = text.splitlines()
        ops: list[HloOp] = []
        for i, line in enumerate(lines):
            m = _OP_RE.match(line)
            if not m:
                continue
            kind = m.group(1)
            payload = tensor_bytes(line)
            region_sig = ""
            if "({" in line:
                # Region-carrying op (all_reduce/reduce_scatter/reduce):
                # the operand/result types sit on the region's CLOSING
                # line, not the op line (whose only tensor<> is the
                # replica-groups constant).
                for j in range(i + 1, min(i + _REGION_LOOKAHEAD, len(lines))):
                    if "})" in lines[j]:
                        region_sig = lines[j]
                        payload = max(payload, tensor_bytes(region_sig))
                        break
            groups = group_size = None
            g = _GROUPS_RE.search(line)
            if g:
                n, msize = int(g.group(2)), int(g.group(3))
                group_size = msize
                groups = _parse_groups(g.group(1), n, msize)
            target = None
            if kind == "custom_call":
                t = _TARGET_RE.search(line)
                target = t.group(1) if t else None
            ops.append(HloOp(
                kind=kind, line=i + 1, text=line.strip(),
                payload_bytes=payload, replica_groups=groups,
                group_size=group_size, custom_target=target,
            ))
        args, results = cls._parse_main(text)
        return cls(text, ops, args, results)

    @staticmethod
    def _parse_main(text: str) -> tuple[list[HloArg], list[HloResult]]:
        m = re.search(r"func\.func public @main\((.*)$", text, re.MULTILINE)
        if not m:
            return [], []
        sig = m.group(1)
        # The signature is one (long) line: "...args...) -> (results) {".
        if "->" in sig:
            args_part, res_part = sig.split("->", 1)
        else:
            args_part, res_part = sig, ""
        args = []
        for am in _ARG_RE.finditer(args_part):
            attrs = am.group(3) or ""
            args.append(HloArg(
                index=int(am.group(1)),
                type=am.group(2),
                donated=("jax.buffer_donor" in attrs
                         or "tf.aliasing_output" in attrs),
                attrs=attrs,
            ))
        results = []
        # Results: "(tensor<...> {jax.result_info = "..."}, ...) {"
        # Walk tensor types in order, pairing each with the result_info
        # attribute block that immediately follows it (if any).
        for idx, tm in enumerate(re.finditer(
                r"(tensor<[^>]*>|![^,\s){]+)(\s*(?:" + _ATTRS + r"))?",
                res_part)):
            attrs = tm.group(2) or ""
            im = _RESULT_INFO_RE.search(attrs)
            info = im.group(1) if im else ""
            results.append(HloResult(index=idx, type=tm.group(1), info=info))
        return args, results

    # -- queries ----------------------------------------------------------

    def by_kind(self, kind: str) -> list[HloOp]:
        return [op for op in self.ops if op.kind == kind]

    def custom_calls(self) -> list[HloOp]:
        return [op for op in self.ops if op.kind == "custom_call"]

    def collectives(self, min_bytes: int = 1024) -> list[HloOp]:
        """Cross-shard collectives whose payload is at least ``min_bytes``.

        Excluded: singleton replica groups (a size-1 mesh axis — no
        communication at all) and sub-threshold payloads (the per-step
        scalar metric psums), so the list tracks data-plane table/batch
        traffic. Static per compiled program: an op inside the step scan
        counts once, which is exactly the per-chunk program the two-tier
        A/B's claim is about."""
        out = []
        for op in self.ops:
            if not op.is_collective:
                continue
            if op.group_size is not None and op.group_size <= 1:
                continue
            if op.payload_bytes >= min_bytes:
                out.append(op)
        return out

    def profile(self, min_bytes: int = 1024) -> list[Collective]:
        """Structured collective profile: ``[(kind, payload_bytes,
        replica_groups)]`` per qualifying collective (see
        :meth:`collectives`)."""
        return [
            Collective(op.kind, op.payload_bytes, op.replica_groups,
                       op.group_size)
            for op in self.collectives(min_bytes)
        ]


def _program(text: str):
    """``text`` as its program model: a :class:`~fps_tpu_torch.analysis.
    record.ProgramRecord` for a record's text, else an
    :class:`HloProgram`."""
    from fps_tpu_torch.analysis.record import ProgramRecord, is_record_text

    if is_record_text(text):
        return ProgramRecord.from_text(text)
    return HloProgram.from_text(text)


def collective_profile(text: str, min_bytes: int = 1024) -> list[Collective]:
    """Structured cross-shard collective accounting of a program's text (a
    lowered StableHLO module or a program record): one
    ``Collective(kind, payload_bytes, replica_groups)`` per qualifying op
    (payload >= ``min_bytes``, singleton replica groups excluded); its
    ``len()`` is :func:`count_collectives`."""
    return _program(text).profile(min_bytes)


def count_collectives(text: str, min_bytes: int = 1024) -> int:
    """Cross-shard collectives in a program's text whose payload is at least
    ``min_bytes`` (see :func:`collective_profile` for the structured
    form)."""
    return len(collective_profile(text, min_bytes))
