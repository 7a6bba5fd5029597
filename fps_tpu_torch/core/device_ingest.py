"""Device-resident ingest: epochs over a dataset that lies on the device.

Port of ``fps_tpu/core/device_ingest.py``. The host ingest
(:mod:`fps_tpu_torch.core.ingest`) builds every chunk in numpy and copies it
to the card; here the columnar dataset is copied **once** and every batch is
an index-select over the resident columns. What carries over from the JAX
package is which example lands in which step, array for array:

* **routing**: per-worker queues (example indices with
  ``route_key % num_workers == w``, in stream order, or round-robin without a
  key), computed on the host once and kept on the device as a padded
  ``(num_workers, max_queue)`` matrix;
* **shuffle**, per epoch: ``"interleave"`` (default) walks each worker's
  queue under the randomized block transpose
  ``pos -> ((pos % r) * c + pos // r + off) mod r*c`` with a per-epoch
  offset drawn on the host (``_epoch_rng``); ``None`` keeps stream order;
  ``"sort"`` draws a uniform permutation per worker. The JAX package draws
  the last from ``jax.random``; the port draws it from a ``torch.Generator``
  seeded by ``_epoch_rng``, so it keeps only the coverage contract;
* **padding**: positions past a worker's queue are weight-0 rows.

The JAX package relays the packed columns into a transposed buffer once an
epoch, so that each batch is a contiguous slice (a TPU layout concern). The
port computes the same rows directly; the contents of the weight-0 padding
rows follow the JAX package's too (zeros where its buffer is padded, the
clamped reads where it gathers), so chunks are equal array for array.

Two consumers, one geometry (:class:`DeviceEpochPlan`):
:func:`device_epoch_chunks` yields ``(T, B)`` chunks of device tensors for
``Trainer.fit_stream``, and ``Trainer.run_indexed`` reads each step's batch
from :meth:`DeviceEpochPlan.call_batches` (``call_rows``, then ``gather``).

Over several processes every process holds the dataset on its home device
and computes the same queues; ``call_batches`` builds the rows of its own
workers only, and the chunks stay global (``run_chunk`` places its own
workers' columns).

Coverage contract (every shuffle): every example exactly once per epoch.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch

from fps_tpu_torch.parallel.mesh import PSMesh

Tensor = torch.Tensor

# Cap on interleave grid rows: consecutive emitted examples sit ~count/r
# apart in stream order, and r*c must stay int32-safe (as in the JAX
# package, whose bijection runs in int32).
_GRID_ROWS_MAX = 1 << 12


class DeviceDataset:
    """A columnar dataset resident on the mesh's (home) device.

    Columns are equal-length arrays; each is kept with one zero row appended
    (row ``n``), which the plan reads for the padding positions that the JAX
    package fills with zeros. Per-(route_key, num_workers) queues are
    computed once on the host and cached on the device.
    """

    def __init__(self, mesh: PSMesh, data: Mapping[str, np.ndarray]):
        self.mesh = mesh
        lengths = {k: len(v) for k, v in data.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"column lengths differ: {lengths}")
        self.n = next(iter(lengths.values()))
        self._host_data = {k: np.asarray(v) for k, v in data.items()}
        self._padded = {}
        for k, v in self._host_data.items():
            col = torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            self._padded[k] = torch.cat(
                [col, torch.zeros((1,) + col.shape[1:], dtype=col.dtype,
                                  device=col.device)])
        self._queues: dict[tuple[str | None, int], tuple[Tensor, np.ndarray]]
        self._queues = {}

    @property
    def columns(self) -> dict[str, Tensor]:
        """The resident columns (views without the zero row)."""
        return {k: v[:self.n] for k, v in self._padded.items()}

    def column_names(self):
        return list(self._padded)

    def queues(self, route_key: str | None, num_workers: int):
        """``(device queue matrix, host per-worker counts)``.

        The queue matrix is ``(num_workers, max_queue)`` int64: worker
        ``w``'s first ``counts[w]`` entries are the example indices it owns,
        in stream order; the rest is 0 (padding, read with weight 0).
        """
        ck = (route_key, num_workers)
        if ck not in self._queues:
            if route_key is None:
                counts = np.full(num_workers, self.n // num_workers, np.int64)
                counts[: self.n % num_workers] += 1
                maxq = max(int(counts.max()), 1)
                q = np.zeros((num_workers, maxq), np.int64)
                for w in range(num_workers):
                    q[w, : counts[w]] = np.arange(w, self.n, num_workers)
            else:
                keys = self._host_data[route_key].astype(np.int64) % num_workers
                order = np.argsort(keys, kind="stable")
                counts = np.bincount(keys, minlength=num_workers)
                maxq = max(int(counts.max()), 1)
                q = np.zeros((num_workers, maxq), np.int64)
                start = 0
                for w in range(num_workers):
                    q[w, : counts[w]] = order[start : start + counts[w]]
                    start += counts[w]
            self._queues[ck] = (torch.from_numpy(q).to(self.mesh.device),
                                counts.astype(np.int64))
        return self._queues[ck]

    def packable(self, route_key: str | None, num_workers: int) -> bool:
        """Whether the JAX package would take its packed-row fast path for
        this geometry: every column 1-D with a 4-byte dtype, and the padded
        queues at most twice the data. It decides what the weight-0 padding
        rows hold (see :class:`DeviceEpochPlan`)."""
        _, counts = self.queues(route_key, num_workers)
        blowup = num_workers * int(counts.max()) / max(self.n, 1)
        return blowup <= 2.0 and all(
            v.ndim == 1 and v.dtype.itemsize == 4
            for v in self._host_data.values())

    def gather(self, rows: Tensor) -> dict[str, Tensor]:
        """Each column at ``rows`` (indices into ``[0, n]``; ``n`` is the
        zero row): one index-select per column."""
        flat = rows.reshape(-1)
        return {k: v.index_select(0, flat).reshape(rows.shape + v.shape[1:])
                for k, v in self._padded.items()}


class DeviceEpochPlan:
    """Epoch traversal geometry over a :class:`DeviceDataset`.

    Owns the per-worker queues, the shuffle parameters and the step count;
    :meth:`call_rows` gives the example rows of a run of steps and
    :meth:`gather` (or :meth:`local_batch_at`) the batches. Steps past the
    epoch (the last call's padding) read weight-0 rows.

    Coverage contract (all shuffle modes): every example exactly once per
    epoch; positions past a worker's queue produce weight-0 padding rows.
    """

    def __init__(self, dataset: DeviceDataset, *, num_workers: int,
                 local_batch: int, route_key: str | None = None,
                 shuffle: str | None = "interleave", seed: int = 0,
                 sync_every: int | None = None):
        if shuffle not in (None, "interleave", "sort"):
            raise ValueError(f"unknown shuffle mode {shuffle!r}")
        self.dataset = dataset
        self.num_workers = num_workers
        self.local_batch = local_batch
        self.route_key = route_key
        self.shuffle = shuffle
        self.seed = seed
        self.sync_every = sync_every

        queues, host_counts = dataset.queues(route_key, num_workers)
        self._queues = queues.reshape(-1)
        self._host_counts = host_counts
        self.maxq = queues.shape[1]
        max_count = int(host_counts.max())
        # ~sqrt(count) rows, a power of two, capped.
        self.grid_r = 1 << max(0, min(_GRID_ROWS_MAX.bit_length() - 1,
                                      int(max(max_count, 1)).bit_length() // 2))
        self.grid_c = np.maximum(
            -(-host_counts // self.grid_r), 1).astype(np.int32)
        self.grid_m = (self.grid_r * self.grid_c).astype(np.int32)
        self.counts = host_counts.astype(np.int32)

        # Each worker scans [0, r*ceil(count/r)): at most count + grid_r.
        scan_len = max_count + (self.grid_r if shuffle == "interleave" else 0)
        steps = max(1, -(-scan_len // local_batch))
        if sync_every:
            steps = -(-steps // sync_every) * sync_every
        self.steps_per_epoch = steps

        # Where the JAX package relays packed rows into a transposed buffer,
        # its padding rows are zeros and its reads past the epoch clamp to
        # the last step; elsewhere it reads clamped queue slots.
        self._buffered = (shuffle in (None, "interleave")
                          and dataset.packable(route_key, num_workers))
        dev = dataset.mesh.device
        self._counts_t = torch.from_numpy(host_counts).to(dev)[:, None]
        self._c_t = torch.from_numpy(self.grid_c.astype(np.int64)).to(
            dev)[:, None]
        self._m_t = torch.from_numpy(self.grid_m.astype(np.int64)).to(
            dev)[:, None]
        self._w_t = torch.arange(num_workers, dtype=torch.int64,
                                 device=dev)[:, None]
        # The workers whose rows call_batches builds: this process's.
        mesh = dataset.mesh
        self._own = ((0, num_workers) if mesh.procs is None
                     else (mesh.local[0], mesh.local[-1] + 1))
        if mesh.procs is not None and num_workers != len(mesh.slot):
            raise ValueError(f"a plan of {num_workers} workers on a mesh of "
                             f"{len(mesh.slot)} positions over processes")
        self._b_t = torch.arange(local_batch, dtype=torch.int64, device=dev)

    def calls_per_epoch(self, steps_per_call: int) -> int:
        """Calls covering one epoch at ``steps_per_call`` steps each (the
        final call may hold fewer steps)."""
        if steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {steps_per_call}")
        return -(-self.steps_per_epoch // steps_per_call)

    def _epoch_rng(self, tag: int, epoch: int) -> np.random.Generator:
        """Deterministic host rng for (tag, seed, epoch); accepts negative
        seeds (masked to 64 bits), as in the JAX package."""
        return np.random.default_rng(
            (tag, self.seed & ((1 << 64) - 1), epoch))

    def epoch_args(self, epoch: int) -> dict:
        """One epoch's shuffle: the per-worker interleave offsets (the JAX
        package's host draw, the same numbers) and, for ``"sort"``, the
        per-worker permutations ``(num_workers, max_queue)``."""
        dev = self.dataset.mesh.device
        off_w = np.zeros(self.num_workers, np.int64)
        perm = None
        if self.shuffle == "interleave":
            off = int(self._epoch_rng(0x0FF5E7, epoch).integers(
                0, max(int(self._host_counts.max()), 1)))
            off_w = off % self.grid_m.astype(np.int64)
        elif self.shuffle == "sort":
            seed = int(self._epoch_rng(0x5037, epoch).integers(0, 1 << 63))
            gen = torch.Generator().manual_seed(seed)
            rows = []
            for cnt in self.counts:
                cnt = int(cnt)
                rows.append(torch.cat([
                    torch.randperm(cnt, generator=gen),
                    torch.arange(cnt, self.maxq)]))
            perm = torch.stack(rows).reshape(-1).to(dev)
        return {"off_w": torch.from_numpy(off_w).to(dev)[:, None],
                "perm": perm}

    def call_rows(self, args: dict, start: int, steps: int,
                  workers: tuple[int, int] | None = None):
        """Example rows and weights of steps ``[start, start + steps)``:
        ``(rows, weight)``, each ``(steps, n * local_batch)`` for the ``n``
        workers ``[lo, hi)`` of ``workers`` (default: every worker),
        worker-major; ``rows`` index the dataset's columns (``n`` is the
        zero row), ``weight`` is 1.0 for a real example and 0.0 for
        padding."""
        ts = torch.arange(start, start + steps, dtype=torch.int64,
                          device=self._b_t.device)
        B, r, maxq = self.local_batch, self.grid_r, self.maxq
        lo, hi = workers or (0, self.num_workers)
        w, cnt, c, m = (x[lo:hi] for x in (
            self._w_t, self._counts_t, self._c_t, self._m_t))
        off_w = args["off_w"][lo:hi]

        def qpos_of(pos):
            x = (pos % r) * c + pos // r  # bijection on [0, m)
            q = x + off_w
            return torch.where(q >= m, q - m, q)

        pos = ts[:, None, None] * B + self._b_t  # (T, 1, B) + (W, 1) below
        pos = pos + torch.zeros_like(w)[None]    # (T, W, B)
        if self.shuffle == "interleave":
            qpos = qpos_of(pos)
            valid = (pos < m) & (qpos < cnt)
        elif self.shuffle == "sort":
            qpos = args["perm"][w * maxq + pos.clamp(0, maxq - 1)]
            valid = pos < cnt
        else:
            qpos = pos
            valid = pos < cnt
        if self._buffered:
            # The JAX package's buffer holds steps_per_epoch steps and its
            # slice clamps to the last; rows past the worker's grid, or
            # past its queue, are zeros.
            last = self.steps_per_epoch - 1
            pos_d = ts.clamp(max=last)[:, None, None] * B + self._b_t
            pos_d = pos_d + torch.zeros_like(w)[None]
            q_d = qpos_of(pos_d) if self.shuffle == "interleave" else pos_d
            ok = (pos_d < m) & (q_d < maxq)
            rows = torch.where(
                ok, self._queues[w * maxq + q_d.clamp(0, maxq - 1)],
                self.dataset.n)
        else:
            rows = self._queues[w * maxq + qpos.clamp(0, maxq - 1)]
        shape = (steps, (hi - lo) * B)
        return rows.reshape(shape), valid.to(torch.float32).reshape(shape)

    def gather(self, rows: Tensor, weight: Tensor) -> dict[str, Tensor]:
        """The batch at ``rows``: every column plus the ``weight`` mask."""
        batch = self.dataset.gather(rows)
        batch["weight"] = weight
        return batch

    def call_batches(self, args: dict, start: int,
                     steps: int) -> dict[str, Tensor]:
        """The batches of steps ``[start, start + steps)``, what
        ``Trainer.run_indexed`` reads: every column and the ``weight`` mask,
        each ``(steps, n * local_batch, ...)`` for this process's ``n``
        workers (every worker on one process); one index-select per
        column."""
        return self.gather(*self.call_rows(args, start, steps, self._own))

    def local_batch_at(self, args: dict, w: int, t: int) -> dict[str, Tensor]:
        """Worker ``w``'s step-``t`` batch: dict of ``(local_batch, ...)``
        tensors plus the ``weight`` mask."""
        rows, weight = self.call_rows(args, t, 1)
        sl = slice(w * self.local_batch, (w + 1) * self.local_batch)
        return self.gather(rows[0, sl], weight[0, sl])

    def chunk(self, args: dict, start: int, steps: int) -> dict[str, Tensor]:
        """Steps ``[start, start + steps)`` as one chunk: leaves ``(T, B)``,
        or ``(T / s, s, B)`` with ``sync_every = s``."""
        chunk = self.gather(*self.call_rows(args, start, steps))
        s = self.sync_every
        if s:
            chunk = {k: v.reshape((steps // s, s) + v.shape[1:])
                     for k, v in chunk.items()}
        return chunk


_UNSET = object()  # distinguishes omitted kwargs from explicit defaults


def device_epoch_chunks(
    dataset: DeviceDataset,
    *,
    num_workers: int,
    local_batch: int,
    steps_per_chunk: int,
    route_key=_UNSET,
    sync_every=_UNSET,
    seed=_UNSET,
    epochs: int = 1,
    start_epoch: int = 0,
    shuffle=_UNSET,
    plan: DeviceEpochPlan | None = None,
) -> Iterator[dict]:
    """Yield device-resident chunks for ``epochs`` passes over the data.

    The chunk contract of :func:`fps_tpu_torch.core.ingest.epoch_chunks`:
    leaves shaped ``(T, B)`` (or ``(R, s, B)`` with ``sync_every``) with a
    ``weight`` mask column, batch dim worker-major, but every leaf is a
    tensor on the dataset's device, so the trainer copies nothing. Each
    epoch's steps are padded to a whole number of chunks. Pass an existing
    ``plan`` to reuse it; ``start_epoch`` selects which epoch's shuffle the
    pass replays. Kwargs that disagree with an explicit plan raise.
    """
    if plan is None:
        plan = DeviceEpochPlan(
            dataset, num_workers=num_workers, local_batch=local_batch,
            route_key=None if route_key is _UNSET else route_key,
            shuffle="interleave" if shuffle is _UNSET else shuffle,
            seed=0 if seed is _UNSET else seed,
            sync_every=None if sync_every is _UNSET else sync_every,
        )
    else:
        mismatches = {
            k: (got, want)
            for k, got, want in (
                ("num_workers", num_workers, plan.num_workers),
                ("local_batch", local_batch, plan.local_batch),
                ("route_key", route_key, plan.route_key),
                ("shuffle", shuffle, plan.shuffle),
                ("seed", seed, plan.seed),
                (
                    "sync_every",
                    _UNSET if sync_every is _UNSET else (sync_every or None),
                    plan.sync_every or None,
                ),
            )
            if got is not _UNSET and got != want
        }
        if mismatches:
            raise ValueError(
                "explicit plan disagrees with kwargs: "
                + ", ".join(f"{k}={got!r} but plan.{k}={want!r}"
                            for k, (got, want) in mismatches.items()))
    if plan.sync_every and steps_per_chunk % plan.sync_every:
        raise ValueError("steps_per_chunk must be a multiple of sync_every")

    def _chunks():
        steps_total = (
            -(-plan.steps_per_epoch // steps_per_chunk) * steps_per_chunk)
        for epoch in range(start_epoch, start_epoch + epochs):
            args = plan.epoch_args(epoch)
            for start in range(0, steps_total, steps_per_chunk):
                yield plan.chunk(args, start, steps_per_chunk)

    return _chunks()
