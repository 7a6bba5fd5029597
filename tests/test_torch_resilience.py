"""The guard and rollback of the port (``fps_tpu_torch.core.resilience``,
``TrainerConfig.guard``, ``RollbackPolicy``) against the JAX package's,
and the port's own oracles from ``tests/test_resilience.py``.

Against the JAX package, on the same numpy inputs: ``guard_pushes`` and
``guard_local_state`` (full and touched-row screens, observe and mask, a
norm limit, NaN in padding rows) give equal counts and bit-equal outputs;
``health_total`` and ``health_by_segment`` equal; the port's pytree flatten
orders every worker's local state as ``jax.tree.flatten`` does; a guarded
MF stream over a poisoned chunk counts what the JAX package counts.

The port's own: with ``guard=None`` a step calls exactly the kernels it
called before the guard existed (the plain versions counted, as
``tests/test_torch_hot_tier.py`` does; the reference compares lowered HLO)
and a clean ``"mask"`` run gives the unguarded bits; a quarantined chunk
leaves the state a preset skip of it leaves, with ``health_lag`` 0 and 1
alike, also under the hot tier; the budget, the policy checks and the
trainer's guard checks.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fps_tpu.core import resilience as jres
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.parallel import mesh as jmesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import (
    LogRegConfig,
    MFConfig,
    PAConfig,
    logistic_regression,
    online_mf,
    passive_aggressive,
)
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax, to_numpy
from fps_tpu_torch.core import resilience as tres
from fps_tpu_torch.core import store as tstore
from fps_tpu_torch.core.ingest import multi_epoch_chunks
from fps_tpu_torch.models import word2vec as tw2v
from fps_tpu_torch.parallel import mesh as tmesh
from fps_tpu_torch.testing import chaos
from fps_tpu_torch import obs
from fps_tpu_torch.obs import events as obs_events

ITEM = "item_factors"
MF_KW = dict(num_users=96, num_items=61, rank=4, learning_rate=0.08,
             reg=0.005)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def journal():
    """A process-default recorder over a memory sink for the test: the
    trail and metrics as a run's journal gets them."""
    sink = obs.MemorySink()
    rec = obs.Recorder(sinks=[sink])
    with obs_events.default_recorder(rec):
        yield rec, sink


def _tmesh(D, S):
    return tmesh.make_ps_mesh(S, D, device="cpu")


def _jmesh(D, S):
    return jmesh.make_ps_mesh(num_shards=S, num_data=D,
                              devices=jax.devices()[:D * S])


def _bits(x):
    x = np.asarray(x)
    return x.view(f"u{x.itemsize}") if x.dtype.kind == "f" else x


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(_bits(a), _bits(b), what)


def _poisoned_push(seed, B=40, D=5):
    """A push with NaN, Inf, huge and -0.0 rows, padding rows among them
    (one padding row NaN)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 50, B).astype(np.int32)
    ids[[3, 7, 11]] = -1
    deltas = rng.normal(size=(B, D)).astype(np.float32)
    deltas[1, min(2, D - 1)] = np.nan
    deltas[2] = np.inf
    deltas[5, 0] = -np.inf
    deltas[9] = 1e20
    deltas[7, D - 1] = np.nan  # a padding row's NaN: scrubbed, uncounted
    deltas[12] = -0.0
    return ids, deltas


GUARDS = [dict(mode="mask"), dict(mode="observe"),
          dict(mode="mask", norm_limit=3.0),
          dict(mode="observe", norm_limit=3.0),
          dict(mode="mask", tables=("a",))]


@pytest.mark.parametrize("kw", GUARDS,
                         ids=["mask", "observe", "mask_norm",
                              "observe_norm", "mask_one_table"])
def test_guard_pushes_matches_the_jax_package(kw):
    pushes = {"a": _poisoned_push(0), "b": _poisoned_push(1, D=1)}
    jout, jh = jres.guard_pushes(
        {k: (jnp.asarray(i), jnp.asarray(d)) for k, (i, d) in
         pushes.items()}, jres.GuardConfig(**kw))
    tout, th = tres.guard_pushes(
        {k: (torch.from_numpy(i), torch.from_numpy(d)) for k, (i, d) in
         pushes.items()}, tres.GuardConfig(**kw))
    assert sorted(jh) == sorted(th)
    for name in pushes:
        _eq(tout[name][0].numpy(), jout[name][0], f"{name} ids")
        _eq(tout[name][1].numpy(), jout[name][1], f"{name} deltas")
    for name in jh:
        for k in ("nonfinite", "norm", "masked"):
            assert th[name][k].dtype == torch.int32
            assert int(th[name][k]) == int(jh[name][k]), (name, k)
    if kw["mode"] == "mask":
        # The padding row's NaN is scrubbed, and the push is finite.
        assert torch.isfinite(tout["a"][1]).all()
        assert int(th["a"]["nonfinite"]) == 3


def _local_pair(seed):
    rng = np.random.default_rng(seed)
    old = {"u": rng.normal(size=(20, 3)).astype(np.float32),
           "s": (rng.normal(size=(6,)).astype(np.float32),
                 np.arange(4, dtype=np.int32)),
           "z": np.float32(1.5)}
    new = {"u": old["u"] + 0.1, "s": (old["s"][0] * 2, old["s"][1] + 1),
           "z": np.float32(np.nan)}
    new["u"][2, 1] = np.nan
    new["u"][4] = 100.0
    new["u"][15, 0] = np.inf  # outside the touched rows
    new["s"][0][3] = np.inf
    return old, new


@pytest.mark.parametrize("touched", [False, True], ids=["full", "touched"])
@pytest.mark.parametrize("kw", GUARDS[:4],
                         ids=["mask", "observe", "mask_norm",
                              "observe_norm"])
def test_guard_local_state_matches_the_jax_package(kw, touched):
    old, new = _local_pair(2)
    t_ids = [np.array([2, 4, 7, -1, 40, 2], np.int32), None, None] \
        if touched else None

    def jx(tree):
        return jax.tree.map(jnp.asarray, tree)

    def tx(tree):
        return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)

    # The leaves' order: "s" (a tuple of two), "u", "z".
    j_t = ([None, None, jnp.asarray(t_ids[0]), None] if touched else None)
    t_t = ([None, None, torch.from_numpy(t_ids[0]), None] if touched
           else None)
    jnew, jc = jres.guard_local_state(jx(old), jx(new),
                                      jres.GuardConfig(**kw), touched=j_t)
    tnew, tc = tres.guard_local_state(tx(old), tx(new),
                                      tres.GuardConfig(**kw), touched=t_t)
    jl, tl = jax.tree.leaves(jnew), tres.tree_flatten(tnew)[0]
    assert len(jl) == len(tl) == 4
    for a, b in zip(tl, jl):
        _eq(a.numpy(), np.asarray(b), "leaf")
    for k in ("nonfinite", "norm", "masked"):
        assert int(tc[k]) == int(jc[k]), k
    assert tres.guard_local_state((), (), tres.GuardConfig()) == ((), None)


def test_health_totals_match_the_jax_package():
    m = {"se": np.ones(6), "health": {
        "a": {"nonfinite": np.array([0, 2, 0, 1, 0, 0]),
              "norm": np.array([0, 0, 3, 0, 0, 1]),
              "masked": np.array([0, 2, 3, 1, 0, 1])},
        "local_state": {"nonfinite": np.array([1, 0, 0, 0, 0, 0]),
                        "norm": np.zeros(6, int), "masked": np.zeros(6)}}}
    assert tres.health_total(m) == jres.health_total(m) == 8
    for seg, per in ((3, 2), (2, 3), (4, 2)):
        assert (tres.health_by_segment(m, seg, per)
                == jres.health_by_segment(m, seg, per))
    assert tres.health_total({"se": 1}) == 0


def _local_states():
    """Every worker's local state, in both packages' forms."""
    out = []
    mesh = _tmesh(1, 2)
    for tr in (online_mf(mesh, MFConfig(**MF_KW))[0],
               passive_aggressive(mesh, PAConfig(num_features=50))[0],
               logistic_regression(mesh, LogRegConfig(num_features=50))[0]):
        out.append(tr.init_state(0)[1])
    cfg = tw2v.W2VConfig(vocab_size=40, dim=4, subsample_t=None)
    uni = np.ones(40)
    out.append(tw2v.word2vec(mesh, cfg, uni)[0].init_state(0)[1])
    out.append(tw2v.word2vec_block(mesh, cfg, uni, 8)[0].init_state(0)[1])
    return out


def test_tree_flatten_follows_jax_tree_flatten():
    """The port's flatten orders leaves as ``jax.tree.flatten`` does: every
    worker's local state, and a nested tree of dicts (keys sorted),
    tuples, lists and ``None``; ``tree_unflatten`` inverts it."""
    trees = _local_states() + [
        {"b": (np.zeros(2), [np.ones(1), None]), "a": {"z": np.full(1, 2.0),
                                                      "c": np.full(1, 3.0)}},
        (), None, [np.zeros(1)]]
    for tree in trees:
        leaves, treedef = tres.tree_flatten(tree)
        host = jax.tree.map(
            lambda x: x.numpy() if isinstance(x, (tmesh.Blocks,
                                                  torch.Tensor)) else x,
            tree, is_leaf=lambda x: isinstance(x, tmesh.Blocks))
        jleaves = jax.tree.leaves(host)
        assert len(leaves) == len(jleaves)
        for a, b in zip(leaves, jleaves):
            a = a.numpy() if isinstance(a, (tmesh.Blocks,
                                            torch.Tensor)) else a
            np.testing.assert_array_equal(a, b)
        back = tres.tree_unflatten(treedef, leaves)
        assert tres.tree_flatten(back)[1] == treedef


# ---------------------------------------------------------------------------
# The guard in the trainer.
# ---------------------------------------------------------------------------

def _mf_chunks(W, n=6, sync_every=None):
    data = jdatasets.synthetic_ratings(96, 61, 2000, rank=3, noise=0.05,
                                       seed=3)
    return list(multi_epoch_chunks(
        data, 2, num_workers=W, local_batch=8, steps_per_chunk=4,
        route_key="user", sync_every=sync_every, seed=11))[:n]


def _kernel_calls(monkeypatch):
    from fps_tpu_torch.ops import kernels

    calls = {}
    for name in ("gather_rows_plain", "gather_rows_dim1_plain",
                 "scatter_add_plain", "scatter_add_dim1_plain",
                 "scatter_add_packed_plain"):
        fn = getattr(kernels, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(kernels, name, spy)
    return calls


def _run(D, S, chunks, *, guard=None, rollback=None, lag=0, sync_every=None,
         build=None, **cfg):
    tr, st = (build or (lambda: online_mf(
        _tmesh(D, S), MFConfig(**MF_KW), combine="mean", guard=guard,
        sync_every=sync_every)))()
    tr.config = dataclasses.replace(tr.config, health_lag=lag, **cfg)
    t, l = tr.init_state(0)
    t, l, m = tr.fit_stream(t, l, chunks, 1, rollback=rollback)
    return tr, st, t, l, m


@pytest.mark.parametrize("family", ["mf", "logreg"])
def test_guard_none_calls_the_same_kernels_and_mask_keeps_clean_bits(
        monkeypatch, family):
    """With ``guard=None`` a run calls exactly the kernels of the
    unguarded program (the guard adds elementwise ops, never a kernel
    call), and a clean stream under ``"mask"`` or ``"observe"`` gives the
    unguarded tables, local state and metrics bit for bit."""
    if family == "mf":
        chunks = _mf_chunks(4)

        def build(guard):
            return lambda: online_mf(_tmesh(2, 2), MFConfig(**MF_KW),
                                     combine="mean", guard=guard)
    else:
        from fps_tpu_torch.utils import datasets as tds

        data = tds.synthetic_sparse_classification(800, 200, 6, seed=1)
        data["label"] = (data["label"] > 0).astype(np.float32)
        chunks = list(multi_epoch_chunks(data, 1, num_workers=4,
                                         local_batch=16,
                                         steps_per_chunk=4, seed=3))[:4]

        def build(guard):
            return lambda: logistic_regression(
                _tmesh(2, 2), LogRegConfig(num_features=200), guard=guard)
    runs = {}
    for guard in (None, "mask", "observe"):
        calls = _kernel_calls(monkeypatch)
        _, _, t, l, m = _run(2, 2, chunks, build=build(guard))
        runs[guard] = (t, l, m, dict(calls))
        monkeypatch.undo()
    t0, l0, m0, c0 = runs[None]
    assert c0 and all("health" not in x for x in m0)
    for guard in ("mask", "observe"):
        t, l, m, c = runs[guard]
        assert c == c0, guard
        for k in t0:
            _eq(t[k].numpy(), t0[k].numpy(), k)
        for a, b in zip(tres.tree_flatten(l)[0], tres.tree_flatten(l0)[0]):
            _eq(a.numpy(), b.numpy(), "local")
        for a, b in zip(m, m0):
            assert "health" in a
            assert tres.health_total(a) == 0
            for k in b:
                _eq(a[k], b[k], k)


def test_guarded_stream_counts_what_the_jax_package_counts(devices8):
    """MF at (2, 4) over a chunk stream whose chunk 2 has NaN ratings:
    the port's and the JAX package's ``health`` counts are equal step for
    step (observe); under mask with the local guard (so a poisoned user
    row cannot spread NaN to its later ratings) the tables stay finite
    and the masked counts equal the live poisoned rows."""
    jtr, _ = jonline_mf(_jmesh(2, 4), JMFConfig(**MF_KW), combine="mean",
                        guard="observe")
    ttr, tst = online_mf(_tmesh(2, 4), MFConfig(**MF_KW), combine="mean",
                         guard="observe")
    jt, jl = jtr.init_state(jax.random.key(0))
    tt = tables_from_jax(tst, {k: np.asarray(v) for k, v in jt.items()})
    tl = local_state_from_jax(ttr.logic, np.asarray(jl), mesh=ttr.mesh)
    chunks = list(chaos.poison_chunks(_mf_chunks(8, n=4), chunk_index=2,
                                      column="rating", kind="nan",
                                      frac=0.05, seed=1))
    _, _, jm = jtr.fit_stream(jt, jl, chunks, jax.random.key(1))
    _, _, tm = ttr.fit_stream(tt, tl, chunks, 1)
    for a, b in zip(tm, jm):
        for k in ("nonfinite", "norm", "masked"):
            np.testing.assert_array_equal(a["health"][ITEM][k],
                                          np.asarray(b["health"][ITEM][k]))
    assert tres.health_total(tm[2]) > 0 and tres.health_total(tm[1]) == 0
    mtr, mst = online_mf(_tmesh(2, 4), MFConfig(**MF_KW), combine="mean",
                         guard=tres.GuardConfig(mode="mask", local=True))
    t, l = mtr.init_state(0)
    t, l, mm = mtr.fit_stream(t, l, chunks, 1)
    assert np.isfinite(t[ITEM].numpy()).all()
    live = np.isnan(chunks[2]["rating"]) & (chunks[2]["weight"] > 0) \
        if "weight" in chunks[2] else np.isnan(chunks[2]["rating"])
    assert int(np.sum(mm[2]["health"][ITEM]["masked"])) == int(live.sum())


@pytest.mark.parametrize("lag", [0, 1])
@pytest.mark.parametrize("sync_every", [None, 2], ids=["sync", "ssp"])
def test_quarantine_equals_a_preset_skip(lag, sync_every, journal):
    """``guard="observe"`` with a rollback policy: the poisoned chunk 3 is
    quarantined and the run ends where a run that skips chunk 3 outright
    (``preset={3}``) ends, bit for bit, tables, local state and metrics,
    with ``health_lag`` 0 and 1; a deferred (prefetch) boundary save sees
    only clean chunks."""
    chunks = list(chaos.poison_chunks(_mf_chunks(4, sync_every=sync_every),
                                      chunk_index=3, column="rating",
                                      kind="huge", frac=0.1))
    rb = tres.RollbackPolicy(max_rollbacks=2)
    _, _, t, l, m = _run(2, 2, chunks, guard="observe", rollback=rb, lag=lag,
                         sync_every=sync_every)
    assert rb.quarantined == [3] and len(m) == len(chunks) - 1
    assert [e["event"] for e in journal[1].events()] == ["rollback"]
    pre = tres.RollbackPolicy(preset={3})
    _, _, t2, l2, m2 = _run(2, 2, chunks, guard="observe", rollback=pre,
                            sync_every=sync_every)
    assert pre.skipped == [3]
    _eq(t[ITEM].numpy(), t2[ITEM].numpy(), "tables")
    _eq(l.numpy(), l2.numpy(), "local")
    for a, b in zip(m, m2):
        _eq(a["se"], b["se"], "se")


def test_rollback_under_the_hot_tier_restores_replica_and_table():
    """At (2, 2) with the tier on (``hot_tier=16``, window 2): a
    quarantined chunk equals a preset skip bit for bit, the replica
    included, and the replica equals the canonical head rows after it."""
    chunks = list(chaos.poison_chunks(_mf_chunks(4), chunk_index=2,
                                      column="rating", kind="nan",
                                      frac=0.1))

    def build():
        tr, st = online_mf(_tmesh(2, 2), MFConfig(**MF_KW), combine="mean",
                           guard="observe")
        st.specs[ITEM] = dataclasses.replace(st.specs[ITEM], hot_tier=16,
                                             dense_collectives=False)
        tr.config = dataclasses.replace(tr.config, hot_sync_every=2)
        return tr, st

    rb = tres.RollbackPolicy()
    _, st, t, l, _ = _run(2, 2, chunks, rollback=rb, build=build)
    _, _, t2, l2, _ = _run(2, 2, chunks, build=build,
                           rollback=tres.RollbackPolicy(preset={2}))
    assert rb.quarantined == [2]
    for k in (ITEM, tstore.hot_key(ITEM)):
        _eq(t[k].numpy(), t2[k].numpy(), k)
    full = t[ITEM].numpy()
    ids = np.arange(16)
    _eq(t[tstore.hot_key(ITEM)].numpy()[:16],
        full[(ids % 2) * (full.shape[0] // 2) + ids // 2], "replica")


def test_budget_and_policy_checks():
    """Past its budget a policy raises ``PoisonedStreamError`` with the
    last good state restored in the store; a rollback without a guard
    needs a preset; a guard naming an unknown table, or a local guard
    beside a ``local_state`` table, is refused."""
    chunks = list(chaos.poison_chunks(_mf_chunks(4, n=3), chunk_index=1,
                                      column="rating", kind="nan"))
    chunks = chunks[:2] + list(chaos.poison_chunks(
        chunks[2:], chunk_index=0, column="rating", kind="inf"))
    rb = tres.RollbackPolicy(max_rollbacks=1)
    tr, st = online_mf(_tmesh(1, 2), MFConfig(**MF_KW), guard="observe")
    t, l = tr.init_state(0)
    with pytest.raises(tres.PoisonedStreamError):
        tr.fit_stream(t, l, chunks, 1, rollback=rb)
    assert rb.quarantined == [1, 2]
    assert np.isfinite(st.tables[ITEM].numpy()).all()
    tr, _ = online_mf(_tmesh(1, 2), MFConfig(**MF_KW))
    t, l = tr.init_state(0)
    with pytest.raises(ValueError, match="health channel"):
        tr.fit_stream(t, l, chunks, 1, rollback=tres.RollbackPolicy())
    with pytest.raises(TypeError, match="RollbackPolicy"):
        tr.fit_stream(t, l, chunks, 1, rollback=object())
    with pytest.raises(ValueError, match="unknown tables"):
        online_mf(_tmesh(1, 2), MFConfig(**MF_KW),
                  guard=tres.GuardConfig(tables=("nope",)))
    with pytest.raises(TypeError, match="guard must be"):
        online_mf(_tmesh(1, 2), MFConfig(**MF_KW), guard=3)
    with pytest.raises(ValueError, match="reserves"):
        from fps_tpu_torch.core.driver import Trainer

        st2 = tstore.ParamStore(_tmesh(1, 1), [tstore.TableSpec(
            name="local_state", num_ids=4, dim=1)])
        Trainer(_tmesh(1, 1), st2, tr.logic,
                config=dataclasses.replace(
                    tr.config, guard=tres.GuardConfig(local=True)))


def test_local_guard_reverts_poisoned_user_rows_as_the_jax_package(
        devices8):
    """``GuardConfig(local=True)`` on MF at (1, 4): poisoned ratings reach
    the user factors through the local scatter; mask reverts those rows
    (the local state stays finite) and counts them under
    ``"local_state"``, step for step as the JAX package counts."""
    g = dict(mode="mask", local=True)
    jtr, _ = jonline_mf(_jmesh(1, 4), JMFConfig(**MF_KW), combine="mean",
                        guard=jres.GuardConfig(**g))
    ttr, tst = online_mf(_tmesh(1, 4), MFConfig(**MF_KW), combine="mean",
                         guard=tres.GuardConfig(**g))
    jt, jl = jtr.init_state(jax.random.key(0))
    tt = tables_from_jax(tst, {k: np.asarray(v) for k, v in jt.items()})
    tl = local_state_from_jax(ttr.logic, np.asarray(jl), mesh=ttr.mesh)
    chunks = list(chaos.poison_chunks(_mf_chunks(4, n=3), chunk_index=1,
                                      column="rating", kind="nan",
                                      frac=0.05))
    jt, jl, jm = jtr.fit_stream(jt, jl, chunks, jax.random.key(1))
    tt, tl, tm = ttr.fit_stream(tt, tl, chunks, 1)
    assert np.isfinite(tl.numpy()).all()
    for a, b in zip(tm, jm):
        for k in ("nonfinite", "norm", "masked"):
            np.testing.assert_array_equal(
                a["health"]["local_state"][k],
                np.asarray(b["health"]["local_state"][k]))
    assert int(np.sum(tm[1]["health"]["local_state"]["masked"])) > 0
    np.testing.assert_allclose(to_numpy(tl), np.asarray(jl), rtol=0,
                               atol=1e-5)
