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
"""

from __future__ import annotations

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

WRAPPERS = {"gather_rows": gather_rows_cuda, "scatter_add": scatter_add_cuda_,
            "gather_rows_dim1": gather_rows_dim1_cuda,
            "scatter_add_dim1": scatter_add_dim1_cuda_}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
