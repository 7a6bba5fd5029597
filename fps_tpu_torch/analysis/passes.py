"""The analysis passes: each audits one plane of the program contract.

Port of ``fps_tpu/analysis/passes.py``. Every pass is a pure function of
``(program, ProgramContract) -> [Violation]``, where the program is either
model: a :class:`~fps_tpu_torch.analysis.record.ProgramRecord` (the port's
record of one eager call) or an :class:`~fps_tpu_torch.analysis.hlo.
HloProgram` (a StableHLO module of the JAX package). On StableHLO every
pass gives the JAX package's findings word for word; a record adds two
things the passes read:

* :class:`HostTransferDetector` also flags a record's ``host_transfer``
  entries (a ``.item()``, ``.tolist()``, ``bool(t)``, ... inside the call:
  a host synchronisation the step budget never priced in) unless the
  contract names the site (``path:function``) or the method in
  ``allow_host_transfers``;
* :class:`DtypeDriftDetector` skips the ops at the sites the contract names
  in ``allow_wide_float_sites``.

* :class:`CollectiveBudget` — count and byte-payload caps per collective
  kind.
* :class:`HostTransferDetector` — no unexpected host transfer inside the
  step.
* :class:`DonationAudit` — canonical tables updated in place (a record's
  evidence: every block kept its storage across the call).
* :class:`DtypeDriftDetector` — no accidental float widening between
  pull, compute and push.
* :class:`ReplicaConsistency` — tiered programs contain the shard-axis
  reconcile exchange at the hot head's payload size.
"""

from __future__ import annotations

from fps_tpu_torch.analysis.contract import ProgramContract, Violation
from fps_tpu_torch.analysis.hlo import (
    INFRA_CUSTOM_CALLS,
    HloProgram,
    float_widths,
)

__all__ = [
    "AnalysisPass",
    "CollectiveBudget",
    "HostTransferDetector",
    "DonationAudit",
    "DtypeDriftDetector",
    "ReplicaConsistency",
    "DEFAULT_PASSES",
]


# Where a record's hot-tier reconcile exchange is made (the static and the
# mapped tier's reconcile share it).
RECONCILE_SITES = frozenset({
    "fps_tpu_torch/core/store.py:_reconcile_combine"})


class AnalysisPass:
    """Base shape: stateless, named, returns violations (empty = clean)."""

    name = "analysis"

    def run(self, program: HloProgram,
            contract: ProgramContract) -> list[Violation]:
        raise NotImplementedError

    def _v(self, summary: str, op=None) -> Violation:
        return Violation(
            pass_name=self.name, summary=summary,
            op_kind=getattr(op, "kind", ""), line=getattr(op, "line", 0),
        )


class CollectiveBudget(AnalysisPass):
    """Total / per-kind collective count and payload-byte budgets."""

    name = "collective_budget"

    def run(self, program, contract):
        colls = program.collectives(contract.min_collective_payload)
        exact = contract.exact_collectives
        out = []
        n = len(colls)
        if contract.max_collectives is not None and (
                n != contract.max_collectives if exact
                else n > contract.max_collectives):
            verb = ("differ from the pinned budget" if exact and
                    n < contract.max_collectives else "exceed the budget")
            out.append(self._v(
                f"{n} cross-shard collectives {verb} "
                f"of {contract.max_collectives} (>= "
                f"{contract.min_collective_payload}B payload each)"
            ))
        total = sum(op.payload_bytes for op in colls)
        if (contract.max_collective_bytes is not None
                and total > contract.max_collective_bytes):
            out.append(self._v(
                f"{total} collective payload bytes exceed the budget of "
                f"{contract.max_collective_bytes}"
            ))
        if contract.per_kind_max:
            counts: dict[str, int] = {}
            for op in colls:
                counts[op.kind] = counts.get(op.kind, 0) + 1
            for kind, cap in sorted(contract.per_kind_max.items()):
                have = counts.get(kind, 0)
                if have > cap:
                    out.append(self._v(
                        f"{have} {kind} ops exceed the per-kind "
                        f"budget of {cap}"
                    ))
                elif exact and have < cap:
                    out.append(self._v(
                        f"{have} {kind} ops fall short of the pinned "
                        f"per-kind budget of {cap}"
                    ))
            if exact:
                for kind in sorted(set(counts) - set(contract.per_kind_max)):
                    out.append(self._v(
                        f"{counts[kind]} {kind} ops but the kind is not "
                        f"in the pinned per-kind budget"
                    ))
        return out


class HostTransferDetector(AnalysisPass):
    """No host transfers inside the step program.

    Flags infeed/outfeed/send/recv outright and any ``custom_call``
    whose target is neither shard_map/sharding infrastructure
    (:data:`~fps_tpu_torch.analysis.hlo.INFRA_CUSTOM_CALLS`) nor explicitly
    allowed by the contract — the lowering of ``io_callback`` /
    ``jax.debug.*`` / ``pure_callback`` is a custom_call into the host
    Python runtime, a per-step synchronization the step budget never
    priced in."""

    name = "host_transfer"

    _HARD_KINDS = ("infeed", "outfeed", "send", "recv")

    def run(self, program, contract):
        out = []
        allowed = INFRA_CUSTOM_CALLS | set(contract.allow_host_transfers)
        for op in program.ops:
            if op.kind == "host_transfer":
                if (op.custom_target in allowed
                        or op.site_function in allowed):
                    continue
                out.append(self._v(
                    f"host transfer Tensor.{op.custom_target}() at "
                    f"{op.site} ({op.function}), {op.count} time(s) in "
                    f"the call (line {op.line}) — a host synchronisation "
                    "not declared in the contract", op))
            elif op.kind in self._HARD_KINDS:
                out.append(self._v(
                    f"host transfer op stablehlo.{op.kind} inside the "
                    f"compiled step (line {op.line})", op))
            elif op.kind == "custom_call":
                target = op.custom_target or "?"
                if target not in allowed:
                    out.append(self._v(
                        f"unexpected custom_call @{target} (line "
                        f"{op.line}) — host callback / opaque transfer "
                        "not declared in the contract", op))
        return out


class DonationAudit(AnalysisPass):
    """Canonical tables donated/aliased in-place, no silent copies.

    Table outputs are identified by their ``jax.result_info`` path —
    the drivers return ``(tables, local_state, metrics)``, so every
    ``[0][...]`` result is a table leaf. For each, a distinct input
    argument of the identical tensor type must carry a donation marker
    (``jax.buffer_donor`` / ``tf.aliasing_output``); otherwise XLA
    double-buffers the table and every dispatch pays a copy."""

    name = "donation"

    def run(self, program, contract):
        if not contract.donated_tables:
            return []
        if not program.results or not program.args:
            return []  # no @main metadata — nothing to audit
        donated_pool: dict[str, int] = {}
        for a in program.args:
            if a.donated:
                donated_pool[a.type] = donated_pool.get(a.type, 0) + 1
        out = []
        for r in program.results:
            if not r.info.startswith("[0]"):
                continue
            if donated_pool.get(r.type, 0) > 0:
                donated_pool[r.type] -= 1
            else:
                label = r.info[3:] or f"result {r.index}"
                out.append(self._v(
                    f"table output {label} ({r.type}) has no donated "
                    "input buffer of matching type — the update is a "
                    "copy, not in-place"
                ))
        return out


class DtypeDriftDetector(AnalysisPass):
    """No accidental float widening in the step's dataflow.

    Two tiers: any float wider than ``contract.max_float_bits``
    anywhere in the program (an f64 creeping in via a Python float or a
    host-side default doubles bandwidth downstream), and — unless
    allowed — float→wider-float ``stablehlo.convert`` ops (a bf16 table
    pulled and silently computed in f32 defeats the narrow-dtype
    choice the table spec made)."""

    name = "dtype_drift"

    def run(self, program, contract):
        out = []
        wide_lines = []
        allowed = set(contract.allow_wide_float_sites)
        ops = [op for op in program.ops
               if getattr(op, "site_function", None) not in allowed]
        for op in ops:
            widths = float_widths(op.text)
            if widths and max(widths) > contract.max_float_bits:
                wide_lines.append(op)
        if wide_lines:
            op = wide_lines[0]
            out.append(self._v(
                f"{len(wide_lines)} op(s) touch floats wider than "
                f"f{contract.max_float_bits} (first: stablehlo.{op.kind} "
                f"at line {op.line})", op))
        if not contract.allow_widening_converts:
            for op in (op for op in ops if op.kind == "convert"):
                widths = float_widths(op.text)
                # A widening float->float convert names two widths with
                # the result strictly wider (operand type precedes the
                # result type in "(tensor<..A>) -> tensor<..B>").
                if len(widths) >= 2 and widths[-1] > widths[0]:
                    out.append(self._v(
                        f"widening convert f{widths[0]}->f{widths[-1]} at "
                        f"line {op.line} — dtype drift between pull/"
                        "compute/push", op))
        return out


class ReplicaConsistency(AnalysisPass):
    """Tiered programs must reconcile through the shard axis.

    The two-tier storage's correctness story (the reconcile sharded per
    arXiv:2004.13336) is that hot-tier replica updates are *dominated by
    one window-end collective exchange*: per-device pending deltas fold
    into replica + canonical head through a **reduce-scatter** over the
    shard axis (each replica applies its disjoint 1/S slice, re-broadcast
    by the paired all-gather), or, in the JAX package's older programs, a
    full-head ``all_reduce``. In a record the port's reconcile
    (:func:`~fps_tpu_torch.core.store.reconcile_hot`) is its
    ``psum_scatter``, a ``reduce_scatter``. A program that
    claims tiering but lowers with neither either silently dropped the
    reconcile (divergent replicas) or re-routed hot traffic through the
    gathered scatters (the budget the tier exists to avoid).

    Heuristic scope note: the op is identified by kind + shard group +
    payload size (>= the replicated head's bytes), not by dataflow — a
    cold-route reduce-scatter of at least that size also satisfies it.
    The collective BUDGET pass pins the exact op census; this pass only
    asserts the reconcile-shaped exchange exists."""

    name = "replica_consistency"

    _KINDS = ("reduce_scatter", "all_reduce")

    def run(self, program, contract):
        if not contract.require_shard_psum:
            return []
        want = contract.hot_reconcile_bytes
        for kind in self._KINDS:
            for op in program.by_kind(kind):
                site = getattr(op, "site_function", None)
                if site is not None and site not in RECONCILE_SITES:
                    # A record names each op's call site: the reconcile is
                    # the exchange made there, not any cold-route
                    # reduce-scatter of the size (the gathered pull's).
                    continue
                if op.group_size is not None and op.group_size <= 1:
                    continue
                if (contract.shard_group_size is not None
                        and op.group_size is not None
                        and op.group_size != contract.shard_group_size):
                    continue
                if op.payload_bytes >= want:
                    return []
        side = (f" over groups of {contract.shard_group_size}"
                if contract.shard_group_size else "")
        return [self._v(
            f"no hot-tier reconcile exchange found: expected a "
            f"reduce_scatter (or extremum/legacy all_reduce){side} with "
            f"payload >= {want}B — replica and canonical table cannot "
            "stay consistent without it"
        )]


DEFAULT_PASSES = (
    CollectiveBudget(),
    HostTransferDetector(),
    DonationAudit(),
    DtypeDriftDetector(),
    ReplicaConsistency(),
)
