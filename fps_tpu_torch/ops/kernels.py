"""The port's hand-written CUDA kernels, each beside its plain version.

For each kernel this module holds the CUDA wrapper, the plain PyTorch version
of the same function, and the wrapper's launch counter (a plain int,
``<wrapper>.launches``, raised by one where the wrapper launches its kernel
and nowhere else). The wrappers take CUDA tensors only and raise on anything
else; :mod:`fps_tpu_torch.ops` chooses between kernel and plain version by
the device the tensor lies on.

K1 ``gather_rows_cuda`` (``csrc/gather_rows.cu``) replaces
``gather_rows_pallas`` (``fps_tpu/ops/pallas_kernels.py``). It is bound by
the bytes it moves: the requested rows read once, the output written once.
One thread per output element copies its value or writes zero for an id
outside ``[0, R)``; a bounds check takes the place of the TPU kernel's
one-hot matmul over every row tile.

K2 ``scatter_add_cuda_`` (``csrc/scatter_add.cu``) replaces
``scatter_add_pallas``. It is bound by bytes too (deltas and ids read, the
touched rows read and written), but it must also be deterministic, which
rules out the float atomics of ``index_add_`` on the card. The wrapper sorts
the ids stably (a permutation), and the kernel gives each run of equal ids to
one thread per column, which adds the run's deltas to the row in batch order.
The serial run of a Zipf-hot id is its slow spot.

K5 ``gather_rows_dim1_cuda`` (``csrc/gather_rows_dim1.cu``) replaces
``gather_rows_dim1_pallas``, the read of an ``(R, 1)`` scalar table. It is
bound by the stream of ids in and values out (the table, at most 4 MB on the
paths that use it, stays in L2). Each thread takes four ids with one 16-byte
load and writes four values with one 16-byte store; a bounds check writes
zero for a dropped id. The read is exact, where the TPU kernel's hi+lo bf16
read keeps about 16 mantissa bits.

K4 ``scatter_add_dim1_cuda_`` (``csrc/scatter_add_dim1.cu``) replaces
``scatter_add_dim1_pallas``, the push into an ``(R, 1)`` table. It is bound
by bytes and must be deterministic, like K2, but K2's serial walk of a run
would cost milliseconds here: a scalar push carries 2^20 Zipf ids, and the
hottest row takes tens of thousands of them. The wrapper sorts the ids
stably; the kernel reduces every run by a segmented scan in a fixed tree
order (within each tile of 1,024 sorted positions, then across the tiles'
partials), and adds each run's sum into its row once. No atomics: the same
bits on every launch, and a batch that is one run costs what a uniform batch
costs.

K3 ``scatter_add_packed_cuda_`` (``csrc/scatter_add_packed.cu``) replaces
``scatter_add_packed_pallas``, the push into the write-hot head rows
``[0, H)`` (the hot/cold split's head, or the whole table when ``H = R``).
It is bound by bytes, must be deterministic and must not serialise on the
Zipf-hot rows that the head holds, with no sort. Each block takes a (row
tile, column tile, batch slice), compacts its slice's ids to those in its
row tile in batch order, stages their deltas in shared memory and adds them
into per-thread row accumulators: the one-hot contraction on CUDA cores, in
exact float32. A second pass sums the slices' partials in slice order into
``table[:H]``. The wrapper picks the slice count (:func:`packed_slices`).
"""

from __future__ import annotations

import operator

import torch

from fps_tpu_torch.ops import _build


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")


def _check_table_ids(fn: str, table: torch.Tensor, ids: torch.Tensor) -> None:
    _check(table.is_cuda and ids.is_cuda,
           f"{fn}: table and ids must be CUDA tensors "
           f"(got {table.device}, {ids.device})")
    _check(table.device == ids.device,
           f"{fn}: table on {table.device}, ids on {ids.device}")
    _check(table.dtype == torch.float32 and table.dim() == 2,
           f"{fn}: table must be 2-D float32, got {tuple(table.shape)} "
           f"{table.dtype}")
    _check(ids.dtype == torch.int32 and ids.dim() == 1,
           f"{fn}: ids must be 1-D int32, got {tuple(ids.shape)} {ids.dtype}")
    _check(table.is_contiguous() and ids.is_contiguous(),
           f"{fn}: table and ids must be contiguous")
    _check(table.shape[0] < 2**31, f"{fn}: table has >= 2**31 rows")


# ---------------------------------------------------------------------------
# K1: gather
# ---------------------------------------------------------------------------

def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, zero rows for ids outside ``[0, R)``."""
    R = table.shape[0]
    in_range = (ids >= 0) & (ids < R)
    if R == 0:
        return table.new_zeros((ids.shape[0], table.shape[1]))
    vals = table.index_select(0, torch.where(in_range, ids, 0))
    return torch.where(in_range[:, None], vals, torch.zeros_like(vals))


def gather_rows_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """K1 on the card: ``(B, D)`` rows of the ``(R, D)`` float32 table for
    ``(B,)`` int32 ids, zero rows for ids outside ``[0, R)``."""
    _check_table_ids("gather_rows_cuda", table, ids)
    R, D = table.shape
    B = ids.shape[0]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B * D == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.fps_gather_rows_f32(table.data_ptr(), ids.data_ptr(),
                                     out.data_ptr(), R, B, D, _stream(table))
    _raise_on_error(rc, "gather_rows_cuda")
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


# ---------------------------------------------------------------------------
# K2: scatter-add
# ---------------------------------------------------------------------------

def scatter_add_plain(table: torch.Tensor, ids: torch.Tensor,
                      deltas: torch.Tensor) -> torch.Tensor:
    """In place: ``table[ids[b]] += deltas[b]``; duplicates add, ids outside
    ``[0, R)`` are dropped. Returns ``table``. The contract of the JAX
    package's ``_xla_scatter_add``."""
    keep = (ids >= 0) & (ids < table.shape[0])
    return table.index_add_(0, ids[keep], deltas[keep].to(table.dtype))


def scatter_add_cuda_(table: torch.Tensor, ids: torch.Tensor,
                      deltas: torch.Tensor) -> torch.Tensor:
    """K2 on the card, in place: ``table[ids[b]] += deltas[b]`` for the
    ``(R, D)`` float32 table, ``(B,)`` int32 ids and ``(B, D)`` float32
    deltas; duplicates add in batch order, ids outside ``[0, R)`` are
    dropped. Deterministic: the same inputs give the same bits. Returns
    ``table``."""
    _check_table_ids("scatter_add_cuda_", table, ids)
    _check(deltas.is_cuda and deltas.device == table.device,
           f"scatter_add_cuda_: deltas on {deltas.device}, table on "
           f"{table.device}")
    _check(deltas.dtype == torch.float32 and deltas.is_contiguous(),
           "scatter_add_cuda_: deltas must be contiguous float32")
    R, D = table.shape
    B = ids.shape[0]
    _check(tuple(deltas.shape) == (B, D),
           f"scatter_add_cuda_: deltas {tuple(deltas.shape)} != ({B}, {D})")
    if B * D == 0:
        return table
    sorted_ids, order = torch.sort(ids, stable=True)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.fps_scatter_add_sorted_f32(
            table.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
            deltas.data_ptr(), R, B, D, _stream(table))
    _raise_on_error(rc, "scatter_add_cuda_")
    scatter_add_cuda_.launches += 1
    return table


scatter_add_cuda_.launches = 0

# ---------------------------------------------------------------------------
# K5: scalar-table gather
# ---------------------------------------------------------------------------

def _check_dim1(fn: str, table: torch.Tensor) -> None:
    _check(table.dim() == 2 and table.shape[1] == 1,
           f"{fn}: table must be (R, 1), got {tuple(table.shape)}")


def gather_rows_dim1_plain(table: torch.Tensor,
                           ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for an ``(R, 1)`` table, zero for ids outside
    ``[0, R)``."""
    _check_dim1("gather_rows_dim1_plain", table)
    return gather_rows_plain(table, ids)


def gather_rows_dim1_cuda(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """K5 on the card: ``(B, 1)`` values of the ``(R, 1)`` float32 table for
    ``(B,)`` int32 ids, zero for ids outside ``[0, R)``."""
    _check_table_ids("gather_rows_dim1_cuda", table, ids)
    _check_dim1("gather_rows_dim1_cuda", table)
    R = table.shape[0]
    B = ids.shape[0]
    out = torch.empty((B, 1), dtype=table.dtype, device=table.device)
    if B == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.fps_gather_rows_dim1_f32(table.data_ptr(), ids.data_ptr(),
                                          out.data_ptr(), R, B,
                                          _stream(table))
    _raise_on_error(rc, "gather_rows_dim1_cuda")
    gather_rows_dim1_cuda.launches += 1
    return out


gather_rows_dim1_cuda.launches = 0


# ---------------------------------------------------------------------------
# K4: scalar-table scatter-add
# ---------------------------------------------------------------------------

DIM1_TILE = 1024  # sorted positions per block of K4 (kTile in the source)


def scatter_add_dim1_plain(table: torch.Tensor, ids: torch.Tensor,
                           deltas: torch.Tensor) -> torch.Tensor:
    """In place, for an ``(R, 1)`` table: ``table[ids[b]] += deltas[b]``;
    duplicates add, ids outside ``[0, R)`` are dropped. Returns ``table``."""
    _check_dim1("scatter_add_dim1_plain", table)
    return scatter_add_plain(table, ids, deltas)


def scatter_add_dim1_cuda_(table: torch.Tensor, ids: torch.Tensor,
                           deltas: torch.Tensor) -> torch.Tensor:
    """K4 on the card, in place: ``table[ids[b]] += deltas[b]`` for the
    ``(R, 1)`` float32 table, ``(B,)`` int32 ids and ``(B, 1)`` float32
    deltas; duplicates add in a fixed tree order, ids outside ``[0, R)`` are
    dropped. Deterministic: the same inputs give the same bits. Returns
    ``table``."""
    _check_table_ids("scatter_add_dim1_cuda_", table, ids)
    _check_dim1("scatter_add_dim1_cuda_", table)
    _check(deltas.is_cuda and deltas.device == table.device,
           f"scatter_add_dim1_cuda_: deltas on {deltas.device}, table on "
           f"{table.device}")
    _check(deltas.dtype == torch.float32 and deltas.is_contiguous(),
           "scatter_add_dim1_cuda_: deltas must be contiguous float32")
    R = table.shape[0]
    B = ids.shape[0]
    _check(tuple(deltas.shape) == (B, 1),
           f"scatter_add_dim1_cuda_: deltas {tuple(deltas.shape)} != "
           f"({B}, 1)")
    if B == 0:
        return table
    sorted_ids, order = torch.sort(ids, stable=True)
    num_tiles = -(-B // DIM1_TILE)
    fwork = torch.empty(2 * num_tiles, dtype=torch.float32,
                        device=table.device)
    iwork = torch.empty(2 * num_tiles, dtype=torch.int32,
                        device=table.device)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.fps_scatter_add_dim1_f32(
            table.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
            deltas.data_ptr(), R, B, fwork.data_ptr(), iwork.data_ptr(),
            fwork[num_tiles:].data_ptr(), iwork[num_tiles:].data_ptr(),
            num_tiles, _stream(table))
    _raise_on_error(rc, "scatter_add_dim1_cuda_")
    scatter_add_dim1_cuda_.launches += 1
    return table


scatter_add_dim1_cuda_.launches = 0

# ---------------------------------------------------------------------------
# K3: scatter-add into the write-hot head rows
# ---------------------------------------------------------------------------

PACKED_SLICE_IDS = 512       # fewest ids a batch slice of K3 takes
PACKED_SLICES_MAX = 256      # most batch slices of one launch
PACKED_PARTIAL_BYTES = 32 << 20  # most scratch for the slices' partial sums


def packed_slices(batch: int, head_rows: int, dim: int) -> int:
    """K3's batch slices for a push: enough that the blocks of one row tile
    (where a single hot row puts all the work) fill the card, at least
    ``PACKED_SLICE_IDS`` ids each, and no more than ``PACKED_PARTIAL_BYTES``
    of ``(slices, H, D)`` float32 partial sums."""
    by_bytes = PACKED_PARTIAL_BYTES // max(1, head_rows * dim * 4)
    return max(1, min(-(-batch // PACKED_SLICE_IDS), PACKED_SLICES_MAX,
                      by_bytes))


def _head_rows(fn: str, table: torch.Tensor, hot_rows) -> int:
    hot_rows = operator.index(hot_rows)
    _check(hot_rows >= 0, f"{fn}: hot_rows must be >= 0, got {hot_rows}")
    return min(hot_rows, table.shape[0])


def scatter_add_packed_plain(table: torch.Tensor, ids: torch.Tensor,
                             deltas: torch.Tensor,
                             hot_rows: int) -> torch.Tensor:
    """In place, for the head rows ``[0, H)`` with ``H = min(hot_rows, R)``:
    ``table[r] += sum of deltas[b] with ids[b] == r``; ids outside ``[0, H)``
    are left alone. The head's sums are taken into zeros (``index_add_``, in
    batch order) and added into ``table[:H]`` once. Returns ``table``."""
    H = _head_rows("scatter_add_packed_plain", table, hot_rows)
    keep = (ids >= 0) & (ids < H)
    head = torch.zeros((H, table.shape[1]), dtype=table.dtype,
                       device=table.device)
    head.index_add_(0, ids[keep], deltas[keep].to(table.dtype))
    table[:H] += head
    return table


def scatter_add_packed_cuda_(table: torch.Tensor, ids: torch.Tensor,
                             deltas: torch.Tensor,
                             hot_rows: int) -> torch.Tensor:
    """K3 on the card, in place: ``table[r] += sum of deltas[b] with
    ids[b] == r`` for the head rows ``[0, H)``, ``H = min(hot_rows, R)``, of
    the ``(R, D)`` float32 table, ``(B,)`` int32 ids and ``(B, D)`` float32
    deltas; ids outside ``[0, H)`` are left alone. Exact float32 sums in a
    fixed order: the same inputs give the same bits. Returns ``table``."""
    fn = "scatter_add_packed_cuda_"
    _check_table_ids(fn, table, ids)
    _check(deltas.is_cuda and deltas.device == table.device,
           f"{fn}: deltas on {deltas.device}, table on {table.device}")
    _check(deltas.dtype == torch.float32 and deltas.is_contiguous(),
           f"{fn}: deltas must be contiguous float32")
    R, D = table.shape
    B = ids.shape[0]
    _check(tuple(deltas.shape) == (B, D),
           f"{fn}: deltas {tuple(deltas.shape)} != ({B}, {D})")
    _check(B < 2**31, f"{fn}: batch has >= 2**31 ids")
    H = _head_rows(fn, table, hot_rows)
    if B * D * H == 0:
        return table
    slices = packed_slices(B, H, D)
    partial = torch.empty(slices * H * D, dtype=torch.float32,
                          device=table.device)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.fps_scatter_add_packed_f32(
            table.data_ptr(), ids.data_ptr(), deltas.data_ptr(), H, B, D,
            partial.data_ptr(), slices, _stream(table))
    _raise_on_error(rc, fn)
    scatter_add_packed_cuda_.launches += 1
    return table


scatter_add_packed_cuda_.launches = 0

WRAPPERS = {"gather_rows": gather_rows_cuda, "scatter_add": scatter_add_cuda_,
            "gather_rows_dim1": gather_rows_dim1_cuda,
            "scatter_add_dim1": scatter_add_dim1_cuda_,
            "scatter_add_packed": scatter_add_packed_cuda_}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
