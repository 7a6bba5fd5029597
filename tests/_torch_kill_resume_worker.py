"""Subprocess body of the port's SIGKILL-and-resume test
(``tests/test_torch_checkpoint.py``).

Usage: python _torch_kill_resume_worker.py <mode> <ckdir> <out_npz>

MF on a (2, 2) mesh of the CPU, 4 epochs of ``run_indexed``:

* ``straight``: the 4 epochs uninterrupted; the model dumped.
* ``victim``: saves every epoch (``keep=2``) and SIGKILLs itself from the
  ``on_epoch`` callback of epoch 3 (index 2), after its training and before
  its save (``kill_at_epoch``).
* ``victim-midwrite``: the same, but dies leaving a torn ``.tmp.npz`` in
  the directory (``partial_write_then_kill``), as a kill mid-write does.
* ``victim-async``: saves through the ``AsyncCheckpointer`` and SIGKILLs
  from inside its writer thread while step 3 is being written (a partial
  tmp on disk, the rename never reached).
* ``resume-any``: a fresh process restores the newest intact snapshot
  (falling back past a corrupt one), finishes the 4 epochs from
  ``start_epoch`` and dumps the model.

The parent asserts that ``resume-any`` equals ``straight`` bit for bit.
"""

import os
import sys


def main() -> int:
    mode, ckdir, out = sys.argv[1], sys.argv[2], sys.argv[3]

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from fps_tpu_torch import DeviceDataset, DeviceEpochPlan
    from fps_tpu_torch.core import checkpoint as ck_mod
    from fps_tpu_torch.models.matrix_factorization import MFConfig, online_mf
    from fps_tpu_torch.models.recommendation import mf_user_vectors
    from fps_tpu_torch.parallel.mesh import make_ps_mesh, num_workers_of
    from fps_tpu_torch.testing import chaos
    from fps_tpu_torch.utils.datasets import synthetic_ratings

    mesh = make_ps_mesh(2, 2, device="cpu")
    W = num_workers_of(mesh)
    data = synthetic_ratings(57, 31, 2000, seed=0)
    cfg = MFConfig(num_users=57, num_items=31, rank=4, learning_rate=0.1)
    trainer, store = online_mf(mesh, cfg)
    tables, ls = trainer.init_state(0)
    plan = DeviceEpochPlan(DeviceDataset(mesh, data), num_workers=W,
                           local_batch=32, route_key="user", seed=5)

    def dump(path, ls):
        np.savez(path, item_factors=store.dump_model("item_factors")[1],
                 user_factors=mf_user_vectors(ls.numpy(), W, np.arange(57)))

    if mode == "straight":
        tables, ls, _ = trainer.run_indexed(tables, ls, plan, 1, epochs=4)
        dump(out, ls)
        return 0
    if mode.startswith("victim"):
        os.makedirs(ckdir, exist_ok=True)
        on_epoch = None
        if mode == "victim":
            ck = ck_mod.Checkpointer(ckdir, keep=2)
            on_epoch = chaos.kill_at_epoch(2)
        elif mode == "victim-midwrite":
            ck = ck_mod.Checkpointer(ckdir, keep=2)

            def on_epoch(e, _m):
                if e == 2:
                    chaos.partial_write_then_kill(ckdir)
        else:
            ck = ck_mod.AsyncCheckpointer(ckdir, keep=2)
            real = ck_mod._atomic_savez

            def dying(path, arrays, precommit=None):
                if os.path.basename(path) == ck_mod.SNAPSHOT_FMT.format(
                        step=3):
                    chaos.partial_write_then_kill(ckdir)
                return real(path, arrays, precommit=precommit)

            ck_mod._atomic_savez = dying
        trainer.run_indexed(tables, ls, plan, 1, epochs=4, checkpointer=ck,
                            checkpoint_every=1, on_epoch=on_epoch)
        return 1  # never reached: the victim dies
    if mode == "resume-any":
        ck = ck_mod.Checkpointer(ckdir)
        tables, ls, step = trainer.restore_checkpoint(ck, ls)
        tables, ls, _ = trainer.run_indexed(tables, ls, plan, 1,
                                            epochs=4 - step,
                                            start_epoch=step)
        dump(out, ls)
        return 0
    raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    raise SystemExit(main())
