"""Certify the example workloads' step programs and write the certificate
JSON.

The port of ``tools/audit_programs.py``, over :mod:`fps_tpu_torch.analysis`:
builds each example workload (mf, streaming_mf, logreg, w2v, pa, ials) and
the tiered MF rows on an 8-position CPU mesh ``(1, 8)`` at the reference's
small audit scale, records the exact program the driver runs
(:meth:`~fps_tpu_torch.core.driver.Trainer.lowered_chunk_text`, ``
lowered_megastep_text``; the iALS accumulate pass for the solver row) and
runs the pass suite against a pinned
:class:`~fps_tpu_torch.analysis.ProgramContract` per row: collective count
and byte budgets, no host transfer, donated tables, no dtype drift, and the
hot tier's reconcile for the tiered rows.

:data:`BUDGETS` is the port's own census, pinned from ``--measure`` on the
CPU mesh (the JAX package's pinned rows, ``AUDIT_r*.json``, count its
lowered programs; the port's routes and stream order differ by design,
``ROADMAP.md`` lists each departure). The counts are exact, not ceilings: a
change that adds or removes a data-plane collective fails here until the
row is pinned again.

Usage:
  python -m fps_tpu_torch.examples.audit_programs [--out CERTS.json]
                                                  [--only mf,logreg]
                                                  [--measure] [--mesh 2,4]
  python fps_tpu_torch/examples/audit_programs.py --hlo DUMP.txt [...]

``--measure`` prints each program's measured profile instead of enforcing
budgets. Exit status is 0 iff every selected program certifies clean (and
the two claims hold: ``rerank_byte_identity`` and
``megastep_k_independence``).

``--hlo`` profiles saved dumps instead of building workloads: a program
record's text (what ``lowered_chunk_text`` returns) or a StableHLO module's.
Run by path: the analysis package is loaded through a stub root package,
so neither torch nor jax is imported.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import types

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Audit scale: the reference's (tools/audit_programs.py), tiny but with
# every route of the bench scale; only the payload bytes shrink.
NU, NI, RANK = 96, 64, 8
NF, NNZ = 400, 8
VOCAB, W2V_DIM = 50, 8
LOCAL_BATCH, STEPS = 32, 4


def _load_analysis_offline():
    """Import ``fps_tpu_torch.analysis`` without executing
    ``fps_tpu_torch/__init__`` (which imports torch): a stub root package
    whose ``__path__`` is the real directory, then the subpackage as usual
    (its modules are stdlib only)."""
    if "fps_tpu_torch" not in sys.modules:
        stub = types.ModuleType("fps_tpu_torch")
        stub.__path__ = [os.path.join(_ROOT, "fps_tpu_torch")]
        sys.modules["fps_tpu_torch"] = stub
    return importlib.import_module("fps_tpu_torch.analysis")


def _offline_main(argv) -> int:
    """``--hlo``: profile saved program texts, with neither torch nor
    jax."""
    ap = argparse.ArgumentParser(
        description="profile saved program records or StableHLO dumps "
                    "(fps_tpu_torch.analysis; no torch, no jax)")
    ap.add_argument("--hlo", action="append", required=True, metavar="PATH",
                    help="a saved program record or lower(...).as_text() "
                         "dump (repeatable)")
    ap.add_argument("--min-bytes", type=int, default=1024,
                    help="collective payload threshold (default 1024)")
    args = ap.parse_args(argv)
    analysis = _load_analysis_offline()
    from fps_tpu_torch.analysis.record import is_record_text

    out = {}
    for path in args.hlo:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        prof = analysis.collective_profile(text, args.min_bytes)
        out[path] = {
            "format": "record" if is_record_text(text) else "stablehlo",
            "collectives": len(prof),
            "bytes": sum(c.payload_bytes for c in prof),
            "profile": [{"kind": c.kind, "bytes": c.payload_bytes,
                         "replica_groups": c.replica_groups}
                        for c in prof],
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__" and any(
        a == "--hlo" or a.startswith("--hlo=") for a in sys.argv[1:]):
    sys.exit(_offline_main(sys.argv[1:]))

if __name__ == "__main__" and _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402

from fps_tpu_torch.analysis import (  # noqa: E402
    ProgramContract,
    certify,
    collective_profile,
)
from fps_tpu_torch.core.driver import num_workers_of  # noqa: E402
from fps_tpu_torch.core.ingest import multi_epoch_chunks  # noqa: E402
from fps_tpu_torch.parallel.mesh import make_ps_mesh  # noqa: E402

# ---------------------------------------------------------------------------
# Pinned per-program budgets, measured at the audit scale on the (1, 8) CPU
# mesh (``--measure``). ROADMAP.md lists each row's departure from the JAX
# package's pinned census with its call sites.
# ---------------------------------------------------------------------------

BUDGETS: dict[str, dict] = {
    # Untiered sync MF on the gathered route (dense_collectives="auto"
    # keeps it): the pull's ids all_gather and values reduce_scatter
    # (store.py pull), the push's ids and deltas all_gathers over the shard
    # axis (store.py push; its data-axis gathers are singletons here). The
    # JAX package's row is a gathered pull and a routed all_to_all push.
    "mf": dict(max_collectives=4, max_collective_bytes=18432,
               per_kind_max={"all_gather": 3, "reduce_scatter": 1}),
    # SSP MF: each round's snapshot all_gather (driver.py _run_steps), the
    # push's two all_gathers; the pulls read the snapshot locally.
    "streaming_mf": dict(max_collectives=3, max_collective_bytes=11264,
                         per_kind_max={"all_gather": 3}),
    # Tiered MF (hot head H=32 replicated, E=2): the cold routes of "mf"
    # plus the window reconcile's reduce_scatter and its re-broadcast
    # all_gather (store.py _reconcile_combine, H*rank*4 = 1024B each);
    # ReplicaConsistency certifies the reduce_scatter.
    "mf_tiered": dict(max_collectives=6, max_collective_bytes=20480,
                      per_kind_max={"all_gather": 4, "reduce_scatter": 2}),
    # The same head over the gathered cold routes, forced: the JAX
    # package's census exactly.
    "mf_tiered_gathered": dict(max_collectives=6,
                               max_collective_bytes=20480,
                               per_kind_max={"all_gather": 4,
                                             "reduce_scatter": 2}),
    # cold_budget=8: the cold ids packed into the 8-wide lane; the values
    # reduce_scatter and deltas all_gather shrink to 2048B and the id lanes
    # (256B) fall below the threshold. The JAX package's census exactly.
    "mf_tiered_compact": dict(max_collectives=4,
                              max_collective_bytes=6144,
                              per_kind_max={"all_gather": 2,
                                            "reduce_scatter": 2}),
    # The adaptive tier over "mf_tiered": the same collectives (the mapped
    # reconcile scatters by id data) plus the tracker's sketch merge psum
    # (driver.py merge_windows, 4x2048 float32 = 32768B).
    "mf_retier": dict(max_collectives=7, max_collective_bytes=53248,
                      per_kind_max={"all_gather": 4, "all_reduce": 1,
                                    "reduce_scatter": 2}),
    # The megastep over the compacted tiered config: the record holds the
    # routes the call took. The audit chunk's stream is not skewed, so the
    # vote sends every segment down the static routes: "mf_tiered"'s
    # census. The JAX program holds both branches of its lax.cond (10
    # collectives). The same for every K (megastep_k_independence).
    "mf_megastep": dict(max_collectives=6, max_collective_bytes=20480,
                        per_kind_max={"all_gather": 4,
                                      "reduce_scatter": 2}),
    # Sparse logistic regression on the gathered route: "mf"'s four
    # collectives at its payloads.
    "logreg": dict(max_collectives=4, max_collective_bytes=32768,
                   per_kind_max={"all_gather": 3, "reduce_scatter": 1}),
    # Word2vec: each of the two tables' pull (ids all_gather, values
    # reduce_scatter) and push (ids and deltas all_gathers).
    "w2v": dict(max_collectives=8, max_collective_bytes=73728,
                per_kind_max={"all_gather": 6, "reduce_scatter": 2}),
    # Passive-aggressive shares logreg's route structure.
    "pa": dict(max_collectives=4, max_collective_bytes=32768,
               per_kind_max={"all_gather": 3, "reduce_scatter": 1}),
    # iALS accumulate: the fixed table's pull (ids all_gather, values
    # reduce_scatter) and the two accumulators' pushes (ids and rows
    # all_gathers each). The JAX package's census exactly.
    "ials": dict(max_collectives=6, max_collective_bytes=84992,
                 per_kind_max={"all_gather": 5, "reduce_scatter": 1}),
}


def pinned_budgets() -> dict:
    """:data:`BUDGETS` in :func:`fps_tpu_torch.obs.drift.
    load_pinned_budgets`' shape, for a :class:`~fps_tpu_torch.obs.drift.
    BudgetDriftDetector` (the per-kind bytes are not pinned: 0)."""
    return {name: {"count": b["max_collectives"],
                   "bytes": b["max_collective_bytes"],
                   "per_kind": {k: {"count": n, "bytes": 0}
                                for k, n in b["per_kind_max"].items()}}
            for name, b in BUDGETS.items()}


def make_mesh(shape=(1, 8)):
    """The audit's CPU mesh, ``(data, shard)`` positions on the CPU."""
    return make_ps_mesh(num_shards=shape[1], num_data=shape[0],
                        device="cpu")


def _mf_pieces(mesh, *, sync_every=None, hot_tier=0, hot_sync_every=1,
               cold_budget=0, gathered=False, skew=False):
    from fps_tpu_torch.models.matrix_factorization import MFConfig, online_mf
    from fps_tpu_torch.utils.datasets import synthetic_ratings

    cfg = MFConfig(num_users=NU, num_items=NI, rank=RANK)
    trainer, store = online_mf(mesh, cfg, sync_every=sync_every)
    if hot_tier:
        for name, spec in store.specs.items():
            over = {}
            if gathered:
                over["dense_collectives"] = False
            store.specs[name] = dataclasses.replace(
                spec, hot_tier=min(hot_tier, spec.num_ids),
                cold_budget=cold_budget, **over)
        trainer.config = dataclasses.replace(
            trainer.config, hot_sync_every=hot_sync_every)
    data = synthetic_ratings(NU, NI, 2000, rank=3, seed=3)
    if skew:
        # Hot-heavy item stream (~95% head hits), so the compacted row's
        # certifier accepts the audit chunk.
        rng = np.random.default_rng(7)
        item = np.where(
            rng.random(len(data["item"])) < 0.95,
            rng.integers(0, min(hot_tier, NI) or NI, len(data["item"])),
            rng.integers(min(hot_tier, NI), NI, len(data["item"])),
        ).astype(np.int32)
        data = dict(data, item=item)
    chunks = multi_epoch_chunks(
        data, 1, num_workers=num_workers_of(mesh), local_batch=LOCAL_BATCH,
        steps_per_chunk=STEPS, route_key="user", sync_every=sync_every,
        seed=11)
    return trainer, chunks


def _chunk_program(trainer, chunks, mode="sync") -> str:
    """The exact per-chunk program ``fit_stream`` runs, recorded."""
    return trainer.lowered_chunk_text(next(iter(chunks)), mode)


def build_mf(mesh) -> str:
    return _chunk_program(*_mf_pieces(mesh))


def build_streaming_mf(mesh) -> str:
    # The streaming example's program is the SSP mode.
    trainer, chunks = _mf_pieces(mesh, sync_every=2)
    return _chunk_program(trainer, chunks, mode="ssp")


def build_mf_tiered(mesh) -> str:
    return _chunk_program(*_mf_pieces(mesh, hot_tier=32, hot_sync_every=2))


def build_mf_tiered_gathered(mesh) -> str:
    """Partial head over the gathered cold routes, the static full-batch
    payload."""
    return _chunk_program(*_mf_pieces(mesh, hot_tier=32, hot_sync_every=2,
                                      gathered=True, skew=True))


def build_mf_tiered_compact(mesh) -> str:
    """The same partial head with ``cold_budget=8``: the cold ids packed
    into the certified lane."""
    return _chunk_program(*_mf_pieces(mesh, hot_tier=32, hot_sync_every=2,
                                      gathered=True, cold_budget=8,
                                      skew=True))


def _mf_retier_pieces(mesh):
    """The adaptive (mapped and tracked) tier over the tiered MF row."""
    from fps_tpu_torch.tiering import Retierer

    trainer, chunks = _mf_pieces(mesh, hot_tier=32, hot_sync_every=2)
    trainer.retierer = Retierer(check_every=4)
    return trainer, chunks


def build_mf_retier(mesh) -> str:
    return _chunk_program(*_mf_retier_pieces(mesh))


def rerank_byte_identity(mesh) -> bool:
    """Two re-ranks of the same (H, table) give byte-identical records: the
    hot membership rides as slot-map and id DATA, never as program
    structure."""
    trainer, chunks = _mf_retier_pieces(mesh)
    chunk = next(iter(chunks))
    t1 = trainer.lowered_chunk_text(chunk, "sync")
    trainer.retierer.hot_ids["item_factors"] = np.arange(
        32, 64, dtype=np.int64)
    t2 = trainer.lowered_chunk_text(chunk, "sync")
    return t1 == t2


def _mf_megastep_pieces(mesh):
    """Tiered partial-head MF (H=32 of 64, cold_budget=8, gathered cold
    routes) over a device plan: the megastep's vote and both cold-route
    branches."""
    from fps_tpu_torch.core.device_ingest import DeviceDataset, DeviceEpochPlan
    from fps_tpu_torch.models.matrix_factorization import MFConfig, online_mf
    from fps_tpu_torch.utils.datasets import synthetic_ratings

    cfg = MFConfig(num_users=NU, num_items=NI, rank=RANK)
    trainer, store = online_mf(mesh, cfg, max_steps_per_call=STEPS)
    for name, spec in store.specs.items():
        store.specs[name] = dataclasses.replace(
            spec, hot_tier=32, cold_budget=8, dense_collectives=False)
    trainer.config = dataclasses.replace(trainer.config, hot_sync_every=2)
    data = synthetic_ratings(NU, NI, 2000, rank=3, seed=3)
    plan = DeviceEpochPlan(
        DeviceDataset(mesh, data), num_workers=num_workers_of(mesh),
        local_batch=LOCAL_BATCH, route_key="user", seed=11)
    return trainer, plan


def build_mf_megastep(mesh) -> str:
    trainer, plan = _mf_megastep_pieces(mesh)
    return trainer.lowered_megastep_text(plan, chunks_per_dispatch=2)


def census(text: str) -> dict:
    """``{kind: sorted payloads}`` of a program's qualifying collectives."""
    kinds: dict[str, list] = {}
    for c in collective_profile(text):
        kinds.setdefault(c.kind, []).append(c.payload_bytes)
    return {k: sorted(v) for k, v in sorted(kinds.items())}


def megastep_k_independence(mesh, ks=(2, 4)) -> bool:
    """The megastep's census is the same for every K: its collectives run
    once a step or a window, never once a segment in a way the census
    would count."""
    cen = []
    for K in ks:
        trainer, plan = _mf_megastep_pieces(mesh)
        cen.append(census(trainer.lowered_megastep_text(
            plan, chunks_per_dispatch=K)))
    return all(c == cen[0] for c in cen)


def build_logreg(mesh) -> str:
    from fps_tpu_torch.models.logistic_regression import (
        LogRegConfig,
        logistic_regression,
    )
    from fps_tpu_torch.utils.datasets import synthetic_sparse_classification

    trainer, _ = logistic_regression(
        mesh, LogRegConfig(num_features=NF, learning_rate=0.5))
    data = synthetic_sparse_classification(2000, NF, NNZ, seed=7)
    data = dict(data, label=(data["label"] > 0).astype(np.float32))
    chunks = multi_epoch_chunks(
        data, 1, num_workers=num_workers_of(mesh), local_batch=LOCAL_BATCH,
        steps_per_chunk=STEPS, seed=3)
    return _chunk_program(trainer, chunks)


def build_w2v(mesh) -> str:
    from fps_tpu_torch.models.word2vec import (
        W2VConfig,
        skipgram_chunks,
        word2vec,
    )

    rng = np.random.default_rng(5)
    tokens = rng.integers(0, VOCAB, 20_000, dtype=np.int32)
    uni = np.bincount(tokens, minlength=VOCAB).astype(np.float64)
    cfg = W2VConfig(vocab_size=VOCAB, dim=W2V_DIM, window=2, negatives=2,
                    subsample_t=None)
    trainer, _ = word2vec(mesh, cfg, uni)
    chunks = skipgram_chunks(
        tokens, uni, cfg, num_workers=num_workers_of(mesh),
        local_batch=LOCAL_BATCH, steps_per_chunk=STEPS, seed=9)
    return _chunk_program(trainer, chunks)


def build_pa(mesh) -> str:
    from fps_tpu_torch.core.ingest import epoch_chunks
    from fps_tpu_torch.models.passive_aggressive import (
        PAConfig,
        passive_aggressive,
    )
    from fps_tpu_torch.utils.datasets import synthetic_sparse_classification

    trainer, _ = passive_aggressive(
        mesh, PAConfig(num_features=NF, variant="PA-I", C=1.0))
    data = synthetic_sparse_classification(2000, NF, NNZ, seed=7)
    chunks = epoch_chunks(
        data, num_workers=num_workers_of(mesh), local_batch=LOCAL_BATCH,
        steps_per_chunk=STEPS, seed=3)
    return _chunk_program(trainer, chunks)


def build_ials(mesh) -> str:
    """The iALS accumulate pass over one chunk (the solver's streaming hot
    path): the fixed table's pulls and the accumulators' pushes, the
    accumulators the record's tables (updated in place)."""
    import torch

    from fps_tpu_torch.analysis.record import record_call
    from fps_tpu_torch.core.prefetch import place_columns, placed_batches
    from fps_tpu_torch.core.store import rows_per_shard
    from fps_tpu_torch.parallel import collectives
    from fps_tpu_torch.models.ials import (
        ITEM_TABLE,
        IALSConfig,
        IALSSolver,
        interaction_chunks,
    )
    from fps_tpu_torch.utils.datasets import synthetic_implicit

    cfg = IALSConfig(num_users=NU, num_items=NI, rank=RANK)
    solver = IALSSolver(mesh, cfg)
    solver.init(0)
    data = synthetic_implicit(NU, NI, 2000, seed=3)
    chunk = next(iter(interaction_chunks(
        data, num_workers=num_workers_of(mesh), local_batch=LOCAL_BATCH,
        steps_per_chunk=STEPS, seed=11)))
    placed = placed_batches(place_columns(collectives.own_columns(mesh, {
        "solve_ids": chunk["user"], "fixed_ids": chunk["item"],
        "rating": chunk["rating"], "weight": chunk["weight"]}, 1),
        solver.device), solver.device)
    cut = {k: collectives.scatter_local(mesh, v, 1)
           for k, v in placed.items()}
    cols = [{k: v[i] for k, v in cut.items()}
            for i in range(len(mesh.local))]
    rps = rows_per_shard(NU, solver.num_shards)
    A = [torch.zeros((rps, RANK * RANK)) for _ in mesh.positions]
    b = [torch.zeros((rps, RANK)) for _ in mesh.positions]
    fixed = list(solver.store.tables[ITEM_TABLE])

    def call():
        solver._accumulate(fixed, A, b, cols)
        return ({"A": A, "b": b},)

    _, prog = record_call("ials/accumulate", {"A": A, "b": b}, call,
                          off_cpu=False)
    return prog.to_text()


BUILDERS = {
    "mf": build_mf,
    "streaming_mf": build_streaming_mf,
    "mf_tiered": build_mf_tiered,
    "mf_tiered_gathered": build_mf_tiered_gathered,
    "mf_tiered_compact": build_mf_tiered_compact,
    "mf_retier": build_mf_retier,
    "mf_megastep": build_mf_megastep,
    "logreg": build_logreg,
    "w2v": build_w2v,
    "pa": build_pa,
    "ials": build_ials,
}

TIERED_ROWS = ("mf_tiered", "mf_tiered_gathered", "mf_tiered_compact",
               "mf_retier", "mf_megastep")


def contract_for(name: str, *, pinned: bool = True,
                 shards: int = 8) -> ProgramContract:
    """Row ``name``'s contract: its pinned budget (exact counts) when
    ``pinned`` (the (1, 8) mesh's), else the structural passes only; the
    tiered rows' reconcile over groups of ``shards``; the megastep row's
    vote read allowed by its site."""
    from fps_tpu_torch.analysis.contract import VOTE_SITE

    budget = BUDGETS[name] if pinned else {}
    tiered = name in TIERED_ROWS
    return ProgramContract(
        name=f"audit/{name}",
        max_collectives=budget.get("max_collectives"),
        max_collective_bytes=budget.get("max_collective_bytes"),
        per_kind_max=budget.get("per_kind_max"),
        exact_collectives=pinned,
        allow_host_transfers=(VOTE_SITE,) if name == "mf_megastep" else (),
        donated_tables=True,
        max_float_bits=32,
        require_shard_psum=tiered,
        # H=32 head rows x RANK float32: the smallest tiered head's bytes.
        hot_reconcile_bytes=32 * RANK * 4 if tiered else 0,
        shard_group_size=shards if tiered else None,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="certify the example workloads' step programs "
                    "(fps_tpu_torch.analysis)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the certificate JSON here (default: "
                         "stdout only)")
    ap.add_argument("--only", default=None,
                    help="comma-separated workload subset "
                         f"(default: all of {', '.join(BUILDERS)})")
    ap.add_argument("--measure", action="store_true",
                    help="print measured profiles without enforcing "
                         "budgets (to pin them after a deliberate change)")
    ap.add_argument("--mesh", default="1,8", metavar="D,S",
                    help="the CPU mesh (data, shard); budgets are pinned "
                         "for 1,8 only, other meshes certify the "
                         "structural passes")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    names = args.only.split(",") if args.only else list(BUILDERS)
    unknown = [n for n in names if n not in BUILDERS]
    if unknown:
        ap.error(f"unknown workload(s): {', '.join(unknown)}")
    shape = tuple(int(x) for x in args.mesh.split(","))
    mesh = make_mesh(shape)
    pinned = shape == (1, 8) and not args.measure
    certs = {}
    for name in names:
        text = BUILDERS[name](mesh)
        contract = (ProgramContract(name=f"measure/{name}") if args.measure
                    else contract_for(name, pinned=pinned, shards=shape[1]))
        cert = certify(text, contract, program=name)
        certs[name] = cert
        mark = "OK " if cert.ok else "FAIL"
        print(f"[{mark}] {name}: {cert.collective_count} collectives, "
              f"{cert.collective_bytes} bytes "
              f"{json.dumps(cert.per_kind())}", file=sys.stderr)
        for v in cert.violations:
            print(f"       [{v.pass_name}] {v.summary}", file=sys.stderr)

    rerank_identical = None
    if "mf_retier" in names:
        rerank_identical = rerank_byte_identity(mesh)
        print(f"[{'OK ' if rerank_identical else 'FAIL'}] mf_retier: "
              "re-rank byte-identity", file=sys.stderr)
    megastep_k_ind = None
    if "mf_megastep" in names:
        megastep_k_ind = megastep_k_independence(mesh)
        print(f"[{'OK ' if megastep_k_ind else 'FAIL'}] mf_megastep: "
              "K-independence (K=2 vs K=4)", file=sys.stderr)

    ok = (all(c.ok for c in certs.values())
          and rerank_identical is not False
          and megastep_k_ind is not False)
    doc = {
        "audit_programs": {n: c.to_json() for n, c in certs.items()},
        "rerank_byte_identical": rerank_identical,
        "megastep_k_independent": megastep_k_ind,
        "ok": ok,
        "mesh": {"data": shape[0], "shard": shape[1]},
        "scale": {"nu": NU, "ni": NI, "rank": RANK, "nf": NF,
                  "vocab": VOCAB, "local_batch": LOCAL_BATCH,
                  "steps_per_chunk": STEPS},
    }
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps({
        "audit": {n: {"ok": c.ok, "collectives": c.collective_count,
                      "bytes": c.collective_bytes,
                      "per_kind": c.per_kind()}
                  for n, c in certs.items()},
        "ok": ok,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
