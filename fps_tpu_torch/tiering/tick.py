"""The megastep's tier tick: the adaptive tier's boundary on the device.

Port of ``fps_tpu/tiering/tick.py``. The host :class:`~fps_tpu_torch.
tiering.retier.Retierer` runs the boundary between calls: it reads the
windows to the host, folds them into a decayed count-min, re-ranks the head
and re-splits the replica. :meth:`Trainer.run_megastep
<fps_tpu_torch.core.driver.Trainer.run_megastep>` runs K chunk segments in
one Python dispatch and reads nothing back between them, so its boundary
stays on the device.

:class:`MegastepTick` is that contract. It subclasses ``Retierer``, so the
trainer's resolution (``manages``, ``track_specs``, ``hot_ids_for``,
``_table_cm``, the sidecar) is the host tier's: the mapped tier, the
tracker's windows and their merge are unchanged. The boundary itself runs
on device tensors with the host tier's arithmetic
(:mod:`fps_tpu_torch.core.megastep` ``apply_tick``):

* the decayed fold is :func:`fps_tpu_torch.sketch.dcm_fold_traced` (a
  power-of-two halving and a float32 add: the host fold's bits);
* the ranking is :func:`device_top_ids`, the same total order (count
  descending, id ascending) as :func:`fps_tpu_torch.tiering.retier.
  top_ids`, so both pick the same head from the same estimates;
* the re-split is :func:`fps_tpu_torch.core.store.replica_from_shard`, a
  copy of the canonical rows, valid because every segment ends in a
  reconcile.

The decayed state and the fold counter pass from one dispatch to the next
as device tensors (:meth:`tick_ops` in, the dispatch's ``aux["tick"]``
out); the host mirrors (:attr:`state`, :attr:`tick`, :attr:`hot_ids`) are
read back only at checkpoints and at the end of a run (:meth:`absorb`),
and the inherited sidecar persists them for a resume.
"""

from __future__ import annotations

import numpy as np
import torch

from fps_tpu_torch import sketch as sklib
from fps_tpu_torch.core.store import ids_key, sketch_key
from fps_tpu_torch.tiering.retier import Retierer

Tensor = torch.Tensor


def device_top_ids(est: Tensor, H: int) -> Tensor:
    """:func:`~fps_tpu_torch.tiering.retier.top_ids` on the device: the top
    ``H`` ids of an estimate vector by count descending, then id ascending,
    as an int32 tensor. A stable sort of ``-est`` keeps equal counts in id
    order (a stable sort is deterministic on CUDA too), the total order the
    host ranking realises, so both select the same head."""
    order = torch.sort(-est.to(torch.float32), stable=True).indices
    return order[:H].to(torch.int32)


class MegastepTick(Retierer):
    """The tier tick of ``Trainer.run_megastep``.

    Args, as :class:`~fps_tpu_torch.tiering.retier.Retierer`'s where shared:

      tables: the tables to manage (default: every store table).
      spec: the decayed count-min (each table's hash seed derives from its
        name, as the host tracker's).
      check_every: the tick's cadence in chunk segments of the megastep; it
        must divide ``chunks_per_dispatch``.
      churn_threshold: re-rank when ``|top-H \\ current| / H`` exceeds it;
        ``< 0`` re-ranks at every tick.
      state_dir / keep: the sidecar beside the checkpoints (inherited),
        written at the megastep's checkpoints.

    It does not plan: ``run_megastep`` refuses ``auto_tier`` too.
    """

    def __init__(self, tables=None, *,
                 spec: sklib.DecayedCountMinSpec | None = None,
                 check_every: int = 1,
                 churn_threshold: float = 0.25,
                 state_dir: str | None = None,
                 keep: int = 3):
        super().__init__(tables, spec=spec, check_every=check_every,
                         churn_threshold=churn_threshold,
                         state_dir=state_dir, keep=keep)

    # -- what the megastep reads and writes ---------------------------------

    def tick_ops(self, trainer) -> dict:
        """The first dispatch's operands on the trainer's device: the host
        mirrors' decayed states (zeros where there is none of the spec's
        shape) and the fold counter, a 0-d int32 tensor. Later dispatches
        take the previous one's ``aux["tick"]``, with no host read."""
        dev = trainer.device
        dcm = {}
        for name in sorted(trainer._track_specs()):
            st = self.state.get(name)
            if st is None or st.shape != (self.spec.depth, self.spec.width):
                st = sklib.dcm_init(self.spec)
            dcm[name] = torch.from_numpy(
                np.array(st, np.float32)).to(dev)
        return {"dcm": dcm,
                "tick": torch.tensor(self.tick, dtype=torch.int32,
                                     device=dev)}

    def absorb(self, trainer, tick_dev, tables) -> None:
        """Read the host mirrors back from the device state (called only at
        checkpoints and at the end of a run): the decayed sketches, the fold
        counter and the hot ids the tables carry (``::hotids``, in rank
        order, as a host re-rank leaves them). Over several processes a
        collective (``Blocks.numpy``)."""
        for name in sorted(tick_dev["dcm"]):
            self.state[name] = tick_dev["dcm"][name].detach().cpu().numpy(
            ).copy()
        self.tick = int(tick_dev["tick"])
        self.checks = self.tick
        for name in sorted(trainer._mapped_tables()):
            k = ids_key(name)
            if k in tables:
                self.hot_ids[name] = tables[k].numpy().astype(np.int64)

    def save_boundary(self, step: int, tables) -> None:
        """The sidecar at a megastep checkpoint: the merged windows not yet
        folded live in the tables' ``::sketch`` entries and are saved beside
        the mirrors, so a resume seeds them as the host tracker's does."""
        windows = {}
        for name in sorted(self.state):
            k = sketch_key(name)
            if k in tables:
                windows[name] = tables[k].numpy()
        self._save_sidecar(step, windows)
