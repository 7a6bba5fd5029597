"""Driver entry points: the one-position step check and the multi-position
dry run.

Port of ``__graft_entry__.py``. ``entry()`` returns one chunk of the
flagship model (online matrix factorization, the reference's headline
workload) on one position, with example arguments. ``dryrun_multichip(n)``
builds an ``n``-position ``(data, shard)`` mesh and runs every model family
over it once, on tiny shapes: MF (sync and SSP, chunked and indexed), the
word2vec block worker on the ``hot_words="auto"`` route (K3 over the whole
shard), iALS, binary and 5-class PA-I, AdaGrad logistic regression with a
dense head and ``push_delay``, and the hot tier (MF ``sum``, w2v ``mean``).

Both run on the visible CUDA devices unless given ``device`` (``"cpu"`` for
the tests; ``"cuda:0"`` for every position on one card); without CUDA and
without a device they raise. The dry run's positions go round-robin over
the visible cards: on a one-card host they all share it, so the run checks
the mesh's program, not scaling over cards. The JAX package re-executes its
dry run in a subprocess to get virtual XLA devices; the port's positions
may share a device, so nothing is re-executed.

Run: ``python -m fps_tpu_torch.entry [--device cpu]`` prints ``entry OK``;
``python -m fps_tpu_torch.entry --dryrun N [--device cpu]`` runs the dry
run over ``N`` positions.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from fps_tpu_torch.analysis import record as _record
from fps_tpu_torch.core.device_ingest import DeviceDataset, DeviceEpochPlan
from fps_tpu_torch.core.driver import num_workers_of
from fps_tpu_torch.core.ingest import epoch_chunks
from fps_tpu_torch.core.store import hot_key
from fps_tpu_torch.models.ials import (
    IALSConfig,
    IALSSolver,
    interaction_chunks,
)
from fps_tpu_torch.models.logistic_regression import (
    LogRegConfig,
    logistic_regression,
)
from fps_tpu_torch.models.matrix_factorization import MFConfig, online_mf
from fps_tpu_torch.models.passive_aggressive import (
    PAConfig,
    passive_aggressive,
)
from fps_tpu_torch.models.word2vec import (
    W2VConfig,
    Word2VecDevicePlan,
    word2vec_block,
)
from fps_tpu_torch.ops import kernels
from fps_tpu_torch.parallel.mesh import default_mesh_shape, make_ps_mesh
from fps_tpu_torch.utils.datasets import (
    synthetic_corpus,
    synthetic_implicit,
    synthetic_ratings,
    synthetic_sparse_classification,
    synthetic_sparse_multiclass,
)


def positions(n: int, device=None) -> list[torch.device]:
    """``n`` position devices: all on ``device`` where given, else
    round-robin over the visible CUDA devices.

    Raises:
      RuntimeError: no ``device`` and CUDA is not available.
    """
    if device is not None:
        return [torch.device(device)] * n
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available and no device was given; "
                           "pass device='cpu' to run on the CPU")
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n)]


def _build(mesh, sync_every=None, *, num_users=64, num_items=48, rank=4,
           local_batch=8, steps=2, donate=True):
    """``(trainer, tables, local_state, chunk)``: the reference's MF job
    (``__graft_entry__._build``) on ``mesh``, its first chunk and its state
    from seed 0."""
    cfg = MFConfig(num_users=num_users, num_items=num_items, rank=rank)
    trainer, _ = online_mf(mesh, cfg, sync_every=sync_every, donate=donate)
    W = num_workers_of(mesh)
    data = synthetic_ratings(num_users, num_items, W * local_batch * steps * 2,
                             rank=3, seed=0)
    chunk = next(epoch_chunks(data, num_workers=W, local_batch=local_batch,
                              steps_per_chunk=steps, route_key="user",
                              sync_every=sync_every))
    tables, local_state = trainer.init_state(0)
    return trainer, tables, local_state, chunk


def entry(device=None):
    """``(fn, example_args)``: one sync chunk of the one-position MF trainer.

    ``fn(tables, local_state, batches, seed)`` is the trainer's bound
    ``run_chunk`` (the port's one-chunk program; the JAX package returns
    its jitted chunk function). The trainer is built with ``donate=False``,
    so ``fn`` may be called again and again on the same arguments: each
    push makes a new tensor and the arguments keep their values. The
    batches are tensors on the position's device, and the seed is a host
    int (the JAX package's is a key).
    """
    mesh = make_ps_mesh(1, 1, devices=positions(1, device))
    trainer, tables, local_state, chunk = _build(mesh, donate=False)
    batches = {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
               for k, v in chunk.items()}
    return trainer.run_chunk, (tables, local_state, batches, 1)


def _total(x) -> float:
    """The sum of a metric: a device tensor (``run_chunk``) or an array
    (``run_indexed``)."""
    return float(x.sum()) if isinstance(x, torch.Tensor) else float(
        np.asarray(x).sum())


def _examples(metrics) -> float:
    """Examples of a call: ``n`` summed over its steps."""
    return _total(metrics["n"])


def _kernel_calls(name: str, mesh, tables, call):
    """``(call(), calls of kernel name)``: counted by the card's launch
    counter on the card, and by the program record's kernel entries on the
    CPU (where the plain versions launch nothing)."""
    if mesh.device.type == "cuda":
        before = kernels.launch_counts()[name]
        out = call()
        return out, kernels.launch_counts()[name] - before
    out, rec = _record.record_call(f"dryrun/{name}", tables, call,
                                   off_cpu=False)
    return out, rec.kernel_counts().get(name, 0)


def _mf_indexed(mesh, sync_every):
    """``(trainer, tables, local_state, plan)``: the dry run's MF over the
    device-resident dataset, calls of 2 steps."""
    cfg = MFConfig(num_users=64, num_items=48, rank=4)
    trainer, _ = online_mf(mesh, cfg, sync_every=sync_every,
                           max_steps_per_call=2)
    tables, local_state = trainer.init_state(0)
    W = num_workers_of(mesh)
    ds = DeviceDataset(mesh, synthetic_ratings(64, 48, 64 * W, seed=0))
    plan = DeviceEpochPlan(ds, num_workers=W, local_batch=8,
                           route_key="user", sync_every=sync_every)
    return trainer, tables, local_state, plan


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run every model family once over an ``n_devices``-position mesh of
    :func:`~fps_tpu_torch.parallel.mesh.default_mesh_shape`, with the JAX
    package's shapes, seeds and assertions, and print its summary line.

    Returns what it asserted on (the JAX package returns nothing):
    ``mesh``, ``examples`` a family, ``k3_calls`` (the w2v route's
    whole-shard head scatter-adds), ``hot_rows`` of both tiers and, on the
    card, ``launches`` of each kernel over the whole run.
    """
    num_data, num_shards = default_mesh_shape(n_devices)
    mesh = make_ps_mesh(num_shards, num_data,
                        devices=positions(n_devices, device))
    W = num_workers_of(mesh)
    before = kernels.launch_counts()
    examples: dict[str, float] = {}

    for sync_every in (None, 2):  # sync mode and SSP bounded staleness
        trainer, tables, local_state, chunk = _build(mesh, sync_every)
        tables, local_state, metrics = trainer.run_chunk(
            tables, local_state, chunk, 2)
        n = _examples(metrics)
        assert n > 0, "no examples processed"
        examples[f"mf_chunked_{'sync' if sync_every is None else 'ssp'}"] = n

    # The device-resident path, in calls of 2 steps.
    for sync_every in (None, 2):
        trainer, tables, local_state, plan = _mf_indexed(mesh, sync_every)
        tables, local_state, metrics = trainer.run_indexed(
            tables, local_state, plan, 3)
        n = _examples(metrics[0])
        assert n == 64 * W, f"indexed path processed {n} != {64 * W}"
        examples[f"mf_indexed_{'sync' if sync_every is None else 'ssp'}"] = n

    # The word2vec block worker with hot_words="auto": the vocabulary's
    # shard is far below the packed crossover, so the whole push of each
    # shard takes K3, counted where it runs (the route equality alone
    # would pass vacuously).
    tokens = synthetic_corpus(60, 4000, seed=0)
    uni = np.bincount(tokens, minlength=60).astype(np.float64)
    wcfg = W2VConfig(vocab_size=60, dim=8, window=2, negatives=2,
                     subsample_t=None, hot_words="auto")
    wtr, wstore = word2vec_block(mesh, wcfg, uni, 16, max_steps_per_call=4)
    rows = wtr._hot_rows("in_embeddings")
    assert rows > 0, "hot_words='auto' did not resolve to whole-shard packing"
    wt, wls = wtr.init_state(0)
    wplan = Word2VecDevicePlan(tokens, uni, wcfg, mesh, num_workers=W,
                               block_len=16, seed=0, mode="block")
    (wt, wls, wm), k3_calls = _kernel_calls(
        "scatter_add_packed", mesh, wt,
        lambda: wtr.run_indexed(wt, wls, wplan, 4))
    examples["w2v_block"] = _examples(wm[0])
    assert examples["w2v_block"] > 0, "w2v processed nothing"
    assert k3_calls > 0, \
        "hot_words='auto' never routed through the packed scatter kernel"

    idata = synthetic_implicit(32, 24, 8, seed=0)
    solver = IALSSolver(mesh, IALSConfig(num_users=32, num_items=24, rank=4))
    solver.init(0)
    solver.epoch(lambda: interaction_chunks(
        idata, num_workers=n_devices, local_batch=16, steps_per_chunk=2,
        seed=0))
    pf, qf = solver.factors()
    assert np.isfinite(pf).all() and np.isfinite(qf).all()
    examples["ials_interactions"] = float(len(idata["user"]))

    # Passive-aggressive, binary and multiclass, over a zero-initialised
    # sharded weight table.
    for name, pacfg, pdata in (
        ("pa_binary", PAConfig(num_features=96, variant="PA-I", C=1.0),
         synthetic_sparse_classification(W * 32, 96, 6, seed=0)),
        ("pa_5class", PAConfig(num_features=96, num_classes=5,
                               variant="PA-I", C=1.0),
         synthetic_sparse_multiclass(W * 32, 96, 5, 6, seed=0)),
    ):
        ptr, _ = passive_aggressive(mesh, pacfg)
        pt, pls = ptr.init_state(0)
        pchunk = next(epoch_chunks(pdata, num_workers=W, local_batch=8,
                                   steps_per_chunk=2, seed=0))
        pt, pls, pm = ptr.run_chunk(pt, pls, pchunk, 5)
        examples[name] = _examples(pm)
        assert examples[name] > 0, "PA processed nothing"

    # Logistic regression with the AdaGrad fold in the table, the dense
    # head and push_delay > 0, over the device-resident path.
    ldata = synthetic_sparse_classification(W * 32, 128, 6, seed=1,
                                            dense_features=3)
    ldata = dict(ldata, label=(ldata["label"] > 0).astype(np.float32))
    lcfg = LogRegConfig(num_features=128, learning_rate=0.3,
                        optimizer="adagrad", dense_features=3)
    ltr, _ = logistic_regression(mesh, lcfg, sync_every=2, push_delay=2,
                                 max_steps_per_call=2)
    lt, lls = ltr.init_state(0)
    lplan = DeviceEpochPlan(DeviceDataset(mesh, ldata), num_workers=W,
                            local_batch=8, sync_every=2, seed=0)
    lt, lls, lm = ltr.run_indexed(lt, lls, lplan, 6)
    examples["logreg"] = _examples(lm[0])
    assert examples["logreg"] > 0, "logreg processed nothing"

    # The hot tier: MF's additive fold over a replicated item head
    # (chunked), w2v's mean fold (indexed); each must resolve on.
    hot_rows = {}
    trainer, tables, local_state, chunk = _build(mesh)
    trainer.store.specs["item_factors"] = dataclasses.replace(
        trainer.store.specs["item_factors"], hot_tier=16)
    trainer.config = dataclasses.replace(trainer.config, hot_sync_every=2)
    assert trainer._resolve_hot_tier(
        trainer.store.specs["item_factors"]) > 0, \
        "MF hot tier did not resolve on"
    tables, local_state, metrics = trainer.run_chunk(tables, local_state,
                                                     chunk, 8)
    assert hot_key("item_factors") in tables, "hot replica missing"
    examples["mf_hot_tier"] = _examples(metrics)
    assert examples["mf_hot_tier"] > 0
    hot_rows["mf"] = _total(metrics["hot_tier"]["item_factors"]["hot_rows"])
    assert hot_rows["mf"] > 0, "hot tier served no rows on the zipf-free smoke"

    wtr2, wstore2 = word2vec_block(mesh, wcfg, uni, 16, max_steps_per_call=4)
    wstore2.specs["in_embeddings"] = dataclasses.replace(
        wstore2.specs["in_embeddings"], hot_tier=16)
    wtr2.config = dataclasses.replace(wtr2.config, hot_sync_every=2)
    assert wtr2._resolve_hot_tier(wstore2.specs["in_embeddings"]) > 0, \
        "w2v (mean-combine) hot tier did not resolve on"
    wt2, wls2 = wtr2.init_state(0)
    wplan2 = Word2VecDevicePlan(tokens, uni, wcfg, mesh, num_workers=W,
                                block_len=16, seed=0, mode="block")
    wt2, wls2, wm2 = wtr2.run_indexed(wt2, wls2, wplan2, 9)
    examples["w2v_hot_tier"] = _examples(wm2[0])
    assert examples["w2v_hot_tier"] > 0, "tiered w2v processed nothing"
    hot_rows["w2v"] = _total(wm2[0]["hot_tier"]["in_embeddings"]["hot_rows"])
    assert hot_rows["w2v"] > 0, "the w2v hot tier served no rows"
    assert np.isfinite(
        np.asarray(wstore2.dump_model("in_embeddings")[1])).all()

    print(f"dryrun_multichip OK on {num_data}x{num_shards} mesh: "
          "mf(sync+ssp, chunked+indexed) w2v-block(hot_ids=auto packed) "
          "ials pa(binary+multiclass) logreg(adagrad+dense+push_delay) "
          "hot-tier(mf sum + w2v mean, replicated head, sharded "
          "reduce-scatter reconcile)", flush=True)
    out = {"mesh": (num_data, num_shards), "examples": examples,
           "k3_calls": k3_calls, "hot_rows": hot_rows}
    if mesh.device.type == "cuda":
        after = kernels.launch_counts()
        out["launches"] = {k: after[k] - before[k] for k in after}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="every position on this device (default: the "
                         "visible CUDA devices; 'cpu' for the CPU)")
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="run dryrun_multichip(N) instead of entry()")
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, device=args.device)
        return 0
    fn, example_args = entry(device=args.device)
    fn(*example_args)
    print("entry OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
