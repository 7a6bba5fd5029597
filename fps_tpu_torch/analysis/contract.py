"""Program contracts and certificates: what a step program must look
like, and the machine-readable proof that it does.

Port of ``fps_tpu/analysis/contract.py``. A :class:`ProgramContract`
declares the budgets and invariants one ``(workload, route, tiering)``
configuration promises about its program: how many cross-shard collectives
(and payload bytes) it may move, that its canonical tables are donated,
that no host transfer hides inside it, that no dtype drift widens the
compute plane, and, for tiered programs, that the hot tier's reconcile is
present. :func:`certify` runs the pass suite
(:mod:`fps_tpu_torch.analysis.passes`) over a program, a
:class:`~fps_tpu_torch.analysis.record.ProgramRecord` (or its text), or a
lowered StableHLO module of the JAX package, and returns a
:class:`Certificate` whose ``to_json()`` has the JAX package's fields.

:class:`ProgramAuditor` is the live form: ``Trainer(audit=...)`` records
the first call of every program it runs and certifies it, recording
``analysis.certified_programs`` / ``analysis.contract_violations`` and an
``analysis.contract_violation`` event per finding through
:mod:`fps_tpu_torch.obs` (strict mode raises instead).

Two contract fields are the port's own: ``allow_host_transfers`` also names
record sites (``path:function``, the megastep vote's), and
``allow_wide_float_sites`` names the sites allowed float64 (the hot folds'
rounded-once ``sqrt`` and ``pow``). The latter appears in ``to_json()``
only when set, so a contract of the JAX package's fields serialises as
there. Imports neither torch nor jax.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from fps_tpu_torch.analysis.hlo import HloProgram

__all__ = [
    "ProgramContract",
    "Violation",
    "Certificate",
    "ContractViolationError",
    "ProgramAuditor",
    "as_auditor",
    "certify",
    "contract_for_trainer",
]


@dataclasses.dataclass(frozen=True)
class ProgramContract:
    """Static-shape budget for one step program.

    ``None`` / falsy fields mean "not asserted" — a default contract
    checks the structural invariants (host transfers, donation, dtype
    drift) without pinning collective counts, so it is safe to apply to
    any workload; the audit tool pins explicit budgets per workload.
    """

    name: str = "default"
    # -- CollectiveBudget -------------------------------------------------
    #: Max qualifying cross-shard collectives in the program (None = any).
    max_collectives: int | None = None
    #: Max total payload bytes across qualifying collectives.
    max_collective_bytes: int | None = None
    #: Per-kind count caps, e.g. {"all_reduce": 1} (unlisted kinds free).
    per_kind_max: Mapping[str, int] | None = None
    #: Treat the count budgets as PINNED exact values instead of
    #: ceilings: a removed collective (or an unlisted kind appearing)
    #: fails too — the audit tool's re-pinning workflow, where any
    #: structural change to the program must show up as a budget diff.
    exact_collectives: bool = False
    #: Payload threshold below which a collective is control-plane noise
    #: (scalar metric psums) — same default as the tiered A/B accounting.
    min_collective_payload: int = 1024
    # -- HostTransferDetector ---------------------------------------------
    #: Extra custom_call targets to allow beyond the sharding/shard_map
    #: infrastructure set (e.g. a deliberate io_callback tap).
    allow_host_transfers: tuple[str, ...] = ()
    # -- DonationAudit ----------------------------------------------------
    #: Require every table-typed output to have a donated input buffer.
    donated_tables: bool = True
    # -- DtypeDriftDetector -----------------------------------------------
    #: Widest float allowed anywhere in the program (f64 ops = drift).
    max_float_bits: int = 32
    #: Allow float->wider-float stablehlo.convert ops (off: a bf16 input
    #: silently widened to f32 inside the step is flagged).
    allow_widening_converts: bool = False
    #: Record sites (``path:function``) whose float64 ops and widening
    #: converts are deliberate (the port's own field).
    allow_wide_float_sites: tuple[str, ...] = ()
    # -- ReplicaConsistency -----------------------------------------------
    #: Tiered programs must contain the hot-tier reconcile psum
    #: (all_reduce, group_size > 1) ...
    require_shard_psum: bool = False
    #: ... whose payload is at least this many bytes (H*dim*itemsize of
    #: the smallest tiered table; 0 = any size).
    hot_reconcile_bytes: int = 0
    #: Expected reconcile group size (num_shards); None = any > 1.
    shard_group_size: int | None = None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if d.get("per_kind_max") is not None:
            d["per_kind_max"] = dict(d["per_kind_max"])
        d["allow_host_transfers"] = list(d["allow_host_transfers"])
        if d["allow_wide_float_sites"]:
            d["allow_wide_float_sites"] = list(d["allow_wide_float_sites"])
        else:
            del d["allow_wide_float_sites"]
        return d


@dataclasses.dataclass(frozen=True)
class Violation:
    """One contract violation, attributed to the pass that found it."""

    pass_name: str
    summary: str
    op_kind: str = ""
    line: int = 0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Certificate:
    """The audit result for one program: the measured collective budget
    plus every violation (empty = certified clean)."""

    program: str
    contract: ProgramContract
    collectives: list  # [Collective]
    violations: list  # [Violation]

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def collective_count(self) -> int:
        return len(self.collectives)

    @property
    def collective_bytes(self) -> int:
        return sum(c.payload_bytes for c in self.collectives)

    def per_kind(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for c in self.collectives:
            k = out.setdefault(c.kind, {"count": 0, "bytes": 0})
            k["count"] += 1
            k["bytes"] += c.payload_bytes
        return dict(sorted(out.items()))

    def to_json(self) -> dict:
        return {
            "program": self.program,
            "ok": self.ok,
            "contract": self.contract.to_json(),
            "collectives": {
                "count": self.collective_count,
                "bytes": self.collective_bytes,
                "per_kind": self.per_kind(),
                "ops": [
                    {"kind": c.kind, "payload_bytes": c.payload_bytes,
                     "replica_groups": (
                         [list(g) for g in c.replica_groups]
                         if c.replica_groups is not None else None)}
                    for c in self.collectives
                ],
            },
            "violations": [v.to_json() for v in self.violations],
        }


class ContractViolationError(AssertionError):
    """A strict audit found contract violations (carries the
    certificate on ``.certificate``)."""

    def __init__(self, certificate: Certificate):
        self.certificate = certificate
        lines = [f"program {certificate.program!r} violates contract "
                 f"{certificate.contract.name!r}:"]
        lines += [f"  [{v.pass_name}] {v.summary}"
                  for v in certificate.violations]
        super().__init__("\n".join(lines))


def certify(text, contract: ProgramContract | None = None, *,
            program: str = "program", passes=None) -> Certificate:
    """Run the pass suite over one program and return the certificate.
    ``text`` is a program record's text or a StableHLO module's (or an
    already-parsed :class:`~fps_tpu_torch.analysis.record.ProgramRecord` or
    :class:`HloProgram`)."""
    from fps_tpu_torch.analysis.hlo import _program
    from fps_tpu_torch.analysis.passes import DEFAULT_PASSES
    from fps_tpu_torch.analysis.record import ProgramRecord

    contract = contract or ProgramContract()
    prog = (text if isinstance(text, (HloProgram, ProgramRecord))
            else _program(text))
    violations: list[Violation] = []
    for p in (passes if passes is not None else DEFAULT_PASSES):
        violations.extend(p.run(prog, contract))
    return Certificate(
        program=program,
        contract=contract,
        collectives=prog.profile(contract.min_collective_payload),
        violations=violations,
    )


# The sanctioned sites of the port's programs (``path:function``): the
# megastep vote's one host read a group (core/megastep.py), and the hot
# folds' float64 square root and power, each taken in float64 and rounded
# once (core/store.py).
VOTE_SITE = "fps_tpu_torch/core/megastep.py:group_votes"
HOT_FOLD_F64_SITES = ("fps_tpu_torch/core/store.py:_pow",
                      "fps_tpu_torch/core/store.py:_sqrt")


def _itemsize(dtype) -> int:
    """Bytes of one element of a table's dtype (a torch dtype or a name)."""
    name = str(dtype).replace("torch.", "")
    sizes = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}
    if name in sizes:
        return sizes[name]
    import numpy as np

    return np.dtype(name).itemsize


def contract_for_trainer(trainer, mode: str = "sync", *,
                         program: str = "chunk") -> ProgramContract:
    """Structural default contract derived from a Trainer's own static
    resolution: donation from ``config.donate``, float width from the
    widest table dtype, and, when the hot tier resolves on, the reconcile's
    requirement sized to the smallest tiered head.

    ``program`` is the program's kind (``"chunk"``, ``"indexed"`` or
    ``"megastep"``): a megastep over compacted cold routes is allowed the
    vote's host read (:data:`VOTE_SITE`), and a trainer with a stateful
    hot fold the fold's float64 sites (:data:`HOT_FOLD_F64_SITES`), and
    nothing else.

    Collective COUNTS are deliberately not pinned here (they are
    workload-shaped); pass an explicit :class:`ProgramContract` (as
    ``fps_tpu_torch/examples/audit_programs.py`` does) to pin them.
    """
    bits = 32
    for spec in trainer.store.specs.values():
        bits = max(bits, _itemsize(spec.dtype) * 8)
    tier = trainer._hot_tier_map()
    hot_bytes = 0
    if tier:
        hot_bytes = min(
            H * trainer.store.specs[name].dim
            * _itemsize(trainer.store.specs[name].dtype)
            for name, H in tier.items()
        )
    hosts = ()
    if program == "megastep" and trainer._cold_compact_map():
        hosts = (VOTE_SITE,)
    return ProgramContract(
        name=f"trainer/{mode}" + ("/tiered" if tier else ""),
        allow_host_transfers=hosts,
        donated_tables=bool(trainer.config.donate),
        max_float_bits=bits,
        allow_wide_float_sites=(HOT_FOLD_F64_SITES
                                if trainer._hot_fold_map() else ()),
        require_shard_psum=bool(tier),
        hot_reconcile_bytes=hot_bytes,
        shard_group_size=trainer.num_shards if tier else None,
    )


class ProgramAuditor:
    """Certifies programs and reports through ``fps_tpu_torch.obs``.

    ``contract=None`` lets the caller supply one per certify() call
    (the Trainer hook derives :func:`contract_for_trainer` then);
    ``strict=True`` raises :class:`ContractViolationError` on any
    violation — CI semantics — instead of only recording.
    Certificates accumulate on ``self.certificates`` for end-of-run
    reporting.
    """

    def __init__(self, contract: ProgramContract | None = None, *,
                 recorder=None, strict: bool = False, passes=None):
        self.contract = contract
        self.recorder = recorder
        self.strict = strict
        self.passes = passes
        self.certificates: list[Certificate] = []

    def certify(self, program: str, text, *,
                contract: ProgramContract | None = None,
                recorder=None) -> Certificate:
        contract = contract or self.contract or ProgramContract()
        cert = certify(text, contract, program=program, passes=self.passes)
        self.certificates.append(cert)
        self._report(cert, recorder if recorder is not None
                     else self.recorder)
        if self.strict and not cert.ok:
            raise ContractViolationError(cert)
        return cert

    def _report(self, cert: Certificate, rec) -> None:
        from fps_tpu_torch.obs import events

        def _inc(name, value=1.0, **labels):
            if rec is not None:
                rec.inc(name, value, **labels)
            else:
                events.record_metric("inc", name, value, **labels)

        def _event(etype, **fields):
            if rec is not None:
                rec.event(etype, **fields)
            else:
                events.emit(etype, **fields)

        if cert.ok:
            _inc("analysis.certified_programs")
            return
        for v in cert.violations:
            _inc("analysis.contract_violations", rule=v.pass_name)
            _event("analysis.contract_violation", program=cert.program,
                   contract=cert.contract.name, rule=v.pass_name,
                   summary=v.summary)


def as_auditor(audit) -> ProgramAuditor | None:
    """Normalise the Trainer's ``audit=`` value: an auditor passes
    through; a :class:`ProgramContract` wraps; ``True`` builds a default
    recording auditor and ``"strict"`` a raising one. ``None`` and
    ``False`` mean disabled (returns None) — so a boolean flag can be
    wired straight through."""
    if audit is None or audit is False:
        return None
    if isinstance(audit, ProgramAuditor):
        return audit
    if isinstance(audit, ProgramContract):
        return ProgramAuditor(contract=audit)
    if audit is True:
        return ProgramAuditor()
    if audit == "strict":
        return ProgramAuditor(strict=True)
    raise TypeError(
        f"audit must be a ProgramAuditor, ProgramContract, True, or "
        f"'strict' — got {audit!r}"
    )
