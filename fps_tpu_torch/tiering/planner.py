"""The auto-tiering planner: each table's tier knobs from its observed
(sketched) id densities instead of by hand.

Port of ``fps_tpu/tiering/planner.py``, numpy only as the JAX package's is
(so the port keeps its own copy). Given each table's estimated id
frequencies (the tracker's decayed count-min, or any density estimate),
:func:`plan_tables` chooses

* ``hot_tier``: the replicated head ``H``, the whole table when it fits
  the replica budget (no pull or push exchange then), else the smallest
  head that covers ``coverage_target`` of the estimated traffic (within the
  budget), else 0 when the distribution is too flat for a head to pay;
* ``hot_sync_every``: the reconcile window ``E``, the smallest whose
  amortized reconcile bytes (``H * dim * itemsize / E`` a step, one more
  column under a ``"mean"`` fold) stay below ``reconcile_frac`` of the hot
  rows' pull bytes a step they replace, within ``[2, max_sync_every]``
  (1 is the exact mode, the tier off);
* ``dense``: the dense route (``TableSpec.dense_collectives``) for a table
  of at most ``dense_table_bytes``;
* ``cold_budget``: the ``cold_budget`` lane of a partial head on the
  gathered route.

The JAX package's trainer passes its own dense threshold, measured on a
TPU's interconnect; the port's ``dense_collectives="auto"`` keeps the
gathered route, so its :class:`~fps_tpu_torch.tiering.Retierer` passes
``dense_table_bytes=0`` (see there). :func:`plan_tenants` splits one
replica budget over several tenants' tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Default replica budget a table: the memory each position may spend on one
# table's replica. A policy default, generous beside the shipped workloads'
# tables; a caller with little device memory passes its own.
DEFAULT_REPLICA_BUDGET_BYTES = 64 << 20
# A head must cover at least this fraction of estimated traffic to be
# worth its reconcile + replica cost; flatter distributions stay
# untiered (the gathered route is already payload-balanced for them).
MIN_HEAD_COVERAGE = 0.5


@dataclasses.dataclass(frozen=True)
class TableDensity:
    """What the planner needs to know about one table: its geometry and
    the estimated pull frequency of each id (any non-negative array of
    ``num_ids`` entries; the tracker gives decayed count-min estimates)."""

    name: str
    num_ids: int
    dim: int
    counts: np.ndarray
    itemsize: int = 4

    def __post_init__(self):
        c = np.asarray(self.counts, np.float64)
        if c.shape != (self.num_ids,):
            raise ValueError(
                f"table {self.name!r}: counts shape {c.shape} != "
                f"({self.num_ids},)")
        if c.size and c.min() < 0:
            raise ValueError(f"table {self.name!r}: negative counts")
        object.__setattr__(self, "counts", c)


@dataclasses.dataclass(frozen=True)
class TierPlan:
    """One table's planned knobs; ``reason`` says why, in words.
    ``cold_budget`` is the cold route's lane width a worker (0: the static
    cold routes)."""

    hot_tier: int
    hot_sync_every: int
    dense: bool
    coverage: float  # estimated traffic fraction the head serves
    reason: str
    cold_budget: int = 0

    def knobs(self) -> tuple:
        """The knobs that change the trainer's resolution: what a re-plan
        compares to decide whether a fresh plan changes nothing (the same
        knobs) or re-resolves the tier once. ``coverage`` and ``reason``
        are evidence, which moves with every fold."""
        return (self.hot_tier, self.hot_sync_every, self.dense,
                self.cold_budget)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def head_coverage(counts: np.ndarray, H: int) -> float:
    """Estimated traffic fraction served by the TOP-H ids (by count)."""
    total = float(counts.sum())
    if total <= 0 or H <= 0:
        return 0.0
    top = np.sort(counts)[::-1][:H]
    return float(top.sum() / total)


def choose_sync_every(
    H: int,
    dim: int,
    itemsize: int,
    coverage: float,
    *,
    batch_rows_per_step: int,
    mean_combine: bool = False,
    reconcile_frac: float = 0.25,
    max_sync_every: int = 8,
) -> int:
    """Smallest reconcile window E whose amortized traffic stays under
    ``reconcile_frac`` of the per-step hot traffic it replaces.

    Cost model: a window moves
    one ``(H, dim (+1 if mean))`` psum, i.e. ``H*(dim+mean)*itemsize/E``
    bytes/step amortized; the hot rows it absorbs would otherwise ride
    per-step collectives carrying about ``coverage * B * dim * itemsize``
    bytes/step. E is the smallest integer making
    ``reconcile/step <= reconcile_frac * absorbed/step``, clamped to
    ``[2, max_sync_every]``: the bound is the staleness of the head's
    reads that the operator accepts.
    """
    reconcile_bytes = H * (dim + (1 if mean_combine else 0)) * itemsize
    absorbed = coverage * batch_rows_per_step * dim * itemsize
    if absorbed <= 0:
        return max_sync_every
    e = int(np.ceil(reconcile_bytes / (reconcile_frac * absorbed)))
    return int(np.clip(e, 2, max_sync_every))


def choose_cold_budget(
    coverage: float,
    batch_rows_per_step: int,
    *,
    num_workers: int = 1,
    margin: float = 4.0,
    min_budget: int = 8,
) -> int:
    """Per-worker cold-lane width for a partial head: the expected cold
    rows per worker per step (``(1 - coverage) · B / W``) times a safety
    ``margin`` (batch-to-batch variance — an undersized lane makes every
    chunk overflow back to the static route), rounded up to a multiple
    of 8 lanes. Returns 0 (static routes) when the margined lane would
    not be meaningfully narrower than the batch itself — the compacted
    route pays a pack/unpack per step, so it must buy a real payload
    reduction."""
    per_worker = max(batch_rows_per_step // max(num_workers, 1), 1)
    expect = (1.0 - coverage) * per_worker
    budget = int(np.ceil(max(expect * margin, min_budget) / 8.0) * 8)
    if budget * 2 >= per_worker:
        return 0
    return budget


def plan_tables(
    densities: list[TableDensity] | dict[str, TableDensity],
    *,
    batch_rows_per_step: int,
    replica_budget_bytes: int = DEFAULT_REPLICA_BUDGET_BYTES,
    dense_table_bytes: int = 1 << 20,
    coverage_target: float = 0.9,
    min_head_coverage: float = MIN_HEAD_COVERAGE,
    reconcile_frac: float = 0.25,
    max_sync_every: int = 8,
    mean_combine: bool = False,
    num_shards: int = 8,
    num_workers: int = 1,
    cold_budget_margin: float = 4.0,
) -> dict[str, TierPlan]:
    """Choose ``(hot_tier, hot_sync_every, dense)`` per table from its
    estimated density — the three knobs ``TableSpec``/``TrainerConfig``
    otherwise make users hand-tune.

    ``batch_rows_per_step``: pulled rows per step per table across all
    workers (the traffic unit the cost model amortizes against).
    ``num_shards`` informs only the reason strings (the single-shard
    no-op case is resolved by the trainer, not here).

    The driver's reconcile cadence is global (``TrainerConfig.
    hot_sync_every``); per-table recommendations are returned anyway and
    the applier takes the MIN over tiered tables — the tightest
    staleness bound any table asked for.
    """
    if isinstance(densities, dict):
        densities = list(densities.values())
    plans: dict[str, TierPlan] = {}
    for d in densities:
        table_bytes = d.num_ids * d.dim * d.itemsize
        dense = table_bytes <= dense_table_bytes
        total = float(d.counts.sum())
        if total <= 0:
            plans[d.name] = TierPlan(
                0, 1, dense, 0.0,
                "no observed traffic: untiered until the tracker has "
                "evidence")
            continue
        if table_bytes <= replica_budget_bytes:
            cov = 1.0
            H = d.num_ids
            E = choose_sync_every(
                H, d.dim, d.itemsize, cov,
                batch_rows_per_step=batch_rows_per_step,
                mean_combine=mean_combine,
                reconcile_frac=reconcile_frac,
                max_sync_every=max_sync_every)
            plans[d.name] = TierPlan(
                H, E, dense, cov,
                f"full replication ({table_bytes}B <= "
                f"{replica_budget_bytes}B budget): collective pull/push "
                "statically elided")
            continue
        order = np.sort(d.counts)[::-1]
        cum = np.cumsum(order) / total
        H_cov = int(np.searchsorted(cum, coverage_target) + 1)
        budget_rows = max(replica_budget_bytes // (d.dim * d.itemsize), 1)
        H = int(min(H_cov, budget_rows, d.num_ids))
        cov = float(cum[H - 1])
        if cov < min_head_coverage:
            plans[d.name] = TierPlan(
                0, 1, dense, cov,
                f"flat distribution: top-{H} covers only {cov:.2f} < "
                f"{min_head_coverage} — a head would not pay its "
                "reconcile")
            continue
        E = choose_sync_every(
            H, d.dim, d.itemsize, cov,
            batch_rows_per_step=batch_rows_per_step,
            mean_combine=mean_combine,
            reconcile_frac=reconcile_frac,
            max_sync_every=max_sync_every)
        # Partial head: the cold routes stay; their lane follows the
        # estimated cold traffic. Dense tables take none (their exchanges
        # are table-sized whatever the lane).
        C = 0 if dense else choose_cold_budget(
            cov, batch_rows_per_step, num_workers=num_workers,
            margin=cold_budget_margin)
        plans[d.name] = TierPlan(
            H, E, dense, cov,
            f"partial head: top-{H} covers {cov:.2f} of estimated "
            f"traffic (target {coverage_target}, budget "
            f"{budget_rows} rows, {num_shards} shards"
            + (f"; compacted cold lane {C}/worker" if C else "")
            + ")",
            cold_budget=C)
    return plans


def tenant_demand_bytes(
    densities: list[TableDensity] | dict[str, TableDensity],
    *,
    replica_budget_bytes: int = DEFAULT_REPLICA_BUDGET_BYTES,
    coverage_target: float = 0.9,
    min_head_coverage: float = MIN_HEAD_COVERAGE,
) -> int:
    """Replica bytes one tenant would CONSUME given a solo budget of
    ``replica_budget_bytes`` — the demand figure the multi-tenant
    arbitration splits. Mirrors :func:`plan_tables`' branch structure
    exactly (full replication / coverage-target head / flat-untiered),
    so ``granted >= demand`` guarantees the arbitrated plan is
    bit-identical to the solo plan."""
    if isinstance(densities, dict):
        densities = list(densities.values())
    demand = 0
    for d in densities:
        table_bytes = d.num_ids * d.dim * d.itemsize
        total = float(d.counts.sum())
        if total <= 0:
            continue
        if table_bytes <= replica_budget_bytes:
            demand += table_bytes
            continue
        order = np.sort(d.counts)[::-1]
        cum = np.cumsum(order) / total
        H_cov = int(np.searchsorted(cum, coverage_target) + 1)
        budget_rows = max(replica_budget_bytes // (d.dim * d.itemsize), 1)
        H = int(min(H_cov, budget_rows, d.num_ids))
        if float(cum[H - 1]) < min_head_coverage:
            continue
        demand += H * d.dim * d.itemsize
    return demand


def arbitrate_replica_budget(
    demands: dict[str, int],
    total_budget: int,
    *,
    weights: dict[str, float] | None = None,
) -> dict[str, int]:
    """Split ONE replica budget across tenants by weighted water-filling.

    ``demands`` maps tenant → bytes it would consume solo
    (:func:`tenant_demand_bytes`); ``weights`` maps tenant → arbitration
    weight (default 1.0 each; must be > 0).

    The blast-radius contract, stated as arithmetic:

    * a tenant demanding no more than its weighted fair share is granted
      its FULL demand — no neighbor, however hungry, can dilute it;
    * surplus left by under-demanders is redistributed among the
      still-hungry by weight (work-conserving);
    * a tenant's overflow (demand above its final share) is simply not
      granted — the shortfall degrades only that tenant's coverage.

    Returns ``{tenant: granted_bytes}`` with ``sum(granted) <=
    total_budget`` and ``granted[t] <= demands[t]`` for every tenant.
    """
    if total_budget < 0:
        raise ValueError(f"total_budget must be >= 0, got {total_budget}")
    weights = dict(weights or {})
    for name in demands:
        w = weights.setdefault(name, 1.0)
        if not (isinstance(w, (int, float)) and w > 0):
            raise ValueError(f"tenant {name!r}: weight must be > 0, "
                             f"got {w!r}")
    granted = {name: 0 for name in demands}
    active = {name for name, dem in demands.items() if dem > 0}
    remaining = int(total_budget)
    # Water-filling: repeatedly satisfy every tenant whose demand fits
    # its weighted share of what is left, then re-divide the surplus
    # among the rest. Terminates: each round either fully satisfies at
    # least one tenant or performs the final pro-rata split.
    while active and remaining > 0:
        wsum = sum(weights[n] for n in active)
        shares = {n: remaining * weights[n] / wsum for n in active}
        sated = [n for n in active if demands[n] <= shares[n]]
        if not sated:
            # Everyone overflows: final split, largest-remainder so the
            # full budget is handed out deterministically (sorted name
            # order breaks ties).
            floor = {n: int(shares[n]) for n in active}
            left = remaining - sum(floor.values())
            by_frac = sorted(active,
                             key=lambda n: (-(shares[n] - floor[n]), n))
            for n in by_frac[:left]:
                floor[n] += 1
            for n in active:
                granted[n] = min(floor[n], demands[n])
            break
        for n in sated:
            granted[n] = demands[n]
            remaining -= demands[n]
            active.remove(n)
    return granted


def plan_tenants(
    tenant_densities: dict[str, list[TableDensity] | dict[str, TableDensity]],
    *,
    batch_rows_per_step: int,
    weights: dict[str, float] | None = None,
    total_replica_budget_bytes: int = DEFAULT_REPLICA_BUDGET_BYTES,
    coverage_target: float = 0.9,
    min_head_coverage: float = MIN_HEAD_COVERAGE,
    **plan_kwargs,
) -> dict[str, dict]:
    """Plan every tenant's tables under ONE shared replica budget.

    Each tenant's demand (:func:`tenant_demand_bytes`, measured against
    the full shared budget — i.e. what it would consume running solo)
    is arbitrated by :func:`arbitrate_replica_budget`; the grant becomes
    that tenant's ``replica_budget_bytes`` for a normal
    :func:`plan_tables` call. A tenant
    whose demand fits its weighted share gets a plan whose
    :meth:`TierPlan.knobs` are identical to its solo plan's (``reason``
    strings cite the differing budgets; knobs are what lower); a noisy
    neighbor's overflow degrades only the noisy neighbor's coverage.

    Returns ``{tenant: {"demand": bytes, "granted": bytes,
    "plans": {table: TierPlan}}}``.
    """
    demands = {
        name: tenant_demand_bytes(
            dens, replica_budget_bytes=total_replica_budget_bytes,
            coverage_target=coverage_target,
            min_head_coverage=min_head_coverage)
        for name, dens in tenant_densities.items()}
    granted = arbitrate_replica_budget(
        demands, total_replica_budget_bytes, weights=weights)
    out: dict[str, dict] = {}
    for name, dens in tenant_densities.items():
        out[name] = {
            "demand": demands[name],
            "granted": granted[name],
            "plans": plan_tables(
                dens, batch_rows_per_step=batch_rows_per_step,
                replica_budget_bytes=granted[name],
                coverage_target=coverage_target,
                min_head_coverage=min_head_coverage,
                **plan_kwargs),
        }
    return out


def global_sync_every(plans: dict[str, TierPlan]) -> int:
    """The driver's single reconcile cadence from per-table plans: the
    MIN over tiered tables (tightest staleness bound requested); 1 (the
    exact mode / tier off) when nothing tiers."""
    es = [p.hot_sync_every for p in plans.values() if p.hot_tier > 0]
    return min(es) if es else 1
