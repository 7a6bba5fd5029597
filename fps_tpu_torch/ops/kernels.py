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

K2 ``scatter_add_cuda_`` (``csrc/scatter_add.cu``, with the sort in
``csrc/radix_sort.cu``) replaces ``scatter_add_pallas``. It is bound by
bytes too (deltas and ids read, the touched rows read and written), but it
must also be deterministic, which rules out the float atomics of
``index_add_`` on the card, and a push's Zipf-hot id owns up to tens of
thousands of its rows, so no run may be walked serially. One C call sorts
and sums: a stable LSD radix sort of the keys (the id, or ``R`` for a
dropped id) with their batch positions, on the ``ceil(log2(R + 1))`` bits
the table needs, 8 a pass (:func:`radix_sort_passes`); then K4's segmented
tree over rows of ``D`` columns: each thread reads its sorted position's
delta row through the permutation, each tile of 128 positions scans its
rows by run in a fixed shuffle tree, the tiles' partials are scanned in
tile order, and each run's sum is added into its row once. It stops at the first dropped key. No atomics and the same bits
on every launch; a batch that is one run costs what a uniform batch costs.

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
Zipf-hot rows that the head holds, with no sort of the batch. Each block
keeps a head tile (the whole 2,048-row head at the paths' widths) in shared
memory for a batch slice: it collects the slice's pushes into the tile in
batch order, ranks each 1,024 of them stably by row (K2's ballot-per-bit
radix ranks, in shared memory), sums each run of a row by K2's segmented
tree and adds the run's sum into the row once. Blocks in clusters of up to
8 sum their tiles through distributed shared memory in rank order; a
second kernel sums the clusters' partials in order into ``table[:H]``. The
wrapper plans tiles, slices and clusters (:func:`packed_plan`,
:func:`card_packed_plan`).
"""

from __future__ import annotations

import functools
import operator
from typing import NamedTuple

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
# K2's sort: a stable radix sort of the ids on the bits the table needs
# ---------------------------------------------------------------------------

# The tile sizes of csrc/radix_sort.cu and csrc/scatter_add.cu, which size
# the scratch: the sort's tiles are 256 to 4,096 positions, as few tiles as
# keep their count at 64 where the largest tile allows.
SORT_MAX_TILE = 4096     # kMaxTile
SORT_TARGET_TILES = 64   # kTargetTiles
SORT_RADIX = 256         # kRadix: 8-bit digits
SUM_TILE = 128           # kTile of the sum


def radix_sort_passes(num_rows: int) -> int:
    """The sort's passes for a table of ``num_rows`` rows: its keys lie in
    ``[0, R]`` and take ``max(1, ceil(log2(R + 1)))`` bits, 8 a pass."""
    num_rows = operator.index(num_rows)
    _check(num_rows >= 0, f"radix_sort_passes: num_rows {num_rows} < 0")
    return -(-max(1, num_rows.bit_length()) // 8)


def _sort_keys(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The sort key of each id: the id in ``[0, R)``, ``R`` for any other,
    so that dropped ids sort last."""
    return torch.where((ids >= 0) & (ids < num_rows), ids,
                       num_rows).to(torch.int32)


def _sort_words(batch: int) -> int:
    """int32 scratch of the sort: keys and positions double-buffered, and
    the (digit, tile) counts of the most tiles the sort can cut."""
    tiles = max(SORT_TARGET_TILES, -(-batch // SORT_MAX_TILE))
    return 4 * batch + SORT_RADIX * tiles


def radix_sort_plain(ids: torch.Tensor,
                     num_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(keys, positions)``: the keys of ``ids`` (``R`` for an id outside
    ``[0, R)``) in ascending order, stable, and the int32 batch position of
    each. ``torch.sort(keys, stable=True)``."""
    keys, order = torch.sort(_sort_keys(ids, num_rows), stable=True)
    return keys, order.to(torch.int32)


def radix_sort_cuda(ids: torch.Tensor,
                    num_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's sort on the card, alone: what :func:`radix_sort_plain` returns,
    from ``radix_sort_passes(num_rows)`` passes of an 8-bit LSD radix sort
    (``csrc/radix_sort.cu``). K2 runs the same sort inside its own C call;
    this wrapper serves the tests and ``chip_smoke.py``."""
    fn = "radix_sort_cuda"
    _check(ids.is_cuda, f"{fn}: ids must be a CUDA tensor (got {ids.device})")
    _check(ids.dtype == torch.int32 and ids.dim() == 1 and
           ids.is_contiguous(),
           f"{fn}: ids must be contiguous 1-D int32, got {tuple(ids.shape)} "
           f"{ids.dtype}")
    _check_batch(fn, ids)
    num_rows = operator.index(num_rows)
    _check(0 <= num_rows < 2**31,
           f"{fn}: num_rows {num_rows} outside [0, 2**31)")
    B = ids.shape[0]
    work = torch.empty(max(1, _sort_words(B)), dtype=torch.int32,
                       device=ids.device)
    if B == 0:
        return work[:0], work[:0]
    lib = _build.library()
    with torch.cuda.device(ids.device):
        rc = lib.fps_radix_sort_i32(ids.data_ptr(), num_rows, B,
                                    work.data_ptr(), work.numel(),
                                    _stream(ids))
    _raise_on_error(rc, fn)
    radix_sort_cuda.launches += 1
    return work[:B], work[2 * B:3 * B]


radix_sort_cuda.launches = 0


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


def _check_batch(fn: str, ids: torch.Tensor) -> None:
    _check(ids.shape[0] < 2**31, f"{fn}: batch has >= 2**31 ids")


def scatter_add_cuda_(table: torch.Tensor, ids: torch.Tensor,
                      deltas: torch.Tensor) -> torch.Tensor:
    """K2 on the card, in place: ``table[ids[b]] += deltas[b]`` for the
    ``(R, D)`` float32 table, ``(B,)`` int32 ids and ``(B, D)`` float32
    deltas; duplicates add in a fixed tree order, ids outside ``[0, R)`` are
    dropped. Deterministic: the same inputs give the same bits. One C call
    launches the sort's and the sum's kernels. Returns ``table``."""
    _check_table_ids("scatter_add_cuda_", table, ids)
    _check_batch("scatter_add_cuda_", ids)
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
    sort_words = _sort_words(B)
    sum_words = (2 * D + 2) * -(-B // SUM_TILE)
    work = torch.empty(sort_words + sum_words, dtype=torch.int32,
                       device=table.device)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.fps_scatter_add_f32(
            table.data_ptr(), ids.data_ptr(), deltas.data_ptr(), R, B, D,
            work.data_ptr(), sort_words, work[sort_words:].data_ptr(),
            sum_words, _stream(table))
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

# The constants of csrc/scatter_add_packed.cu that shape its plan.
PACKED_MAX_WIDTH = 64       # kMaxWidth: columns a head tile
PACKED_MAX_CLUSTER = 8      # kMaxCluster
PACKED_MAX_SMEM = 232_448   # kMaxSmem: 227 KB, a block's most
PACKED_FIXED_SMEM = 33_792  # kFixedSmem: shared memory beside the head tile
PACKED_STRIDES = (4, 8, 12, 16, 20, 32, 64)  # kStrides
PACKED_SLICE_IDS = 512      # fewest ids a batch slice takes
H100_SMS = 132


class PackedPlan(NamedTuple):
    """How K3 cuts a push: head tiles of ``tile_rows`` x ``width`` (of
    ``row_tiles`` x ``col_tiles``; a row takes ``stride`` floats of shared
    memory), ``slices`` batch slices in clusters of ``cluster`` (``groups``
    clusters a tile), ``smem_bytes`` of shared memory a block, and
    ``partial_words`` float32 of scratch (none with one cluster)."""
    width: int
    stride: int
    col_tiles: int
    tile_rows: int
    row_tiles: int
    slices: int
    cluster: int
    groups: int
    smem_bytes: int
    partial_words: int


def packed_plan(batch: int, head_rows: int, dim: int, sms: int = H100_SMS,
                resident=None) -> PackedPlan:
    """K3's plan for a push of ``batch`` ids into a head of ``head_rows`` x
    ``dim`` on a card of ``sms`` multiprocessors.

    Columns go in tiles of at most ``PACKED_MAX_WIDTH``, as even as may be
    (multiples of 4 where ``dim`` is, for 16-byte loads); rows in as few
    tiles as fit in ``PACKED_MAX_SMEM`` beside the fixed staging, as even
    as may be, a row taking the least of ``PACKED_STRIDES`` that holds the
    tile's width, and a byte.
    Slices: about one block per multiprocessor over all tiles, at least
    ``PACKED_SLICE_IDS`` ids each, rounded down to a multiple of the
    cluster, which is ``PACKED_MAX_CLUSTER`` or the slice count if fewer.
    ``resident(width, smem_bytes, cluster)``, where given, is the most
    clusters the card holds at once; the slices are cut so that every tile's
    clusters run in one wave where that leaves each tile a cluster.
    """
    batch, head_rows, dim, sms = (operator.index(x)
                                  for x in (batch, head_rows, dim, sms))
    _check(batch >= 0 and head_rows >= 1 and dim >= 1 and sms >= 1,
           f"packed_plan: batch {batch}, head_rows {head_rows}, dim {dim}, "
           f"sms {sms}")
    chunks = -(-dim // PACKED_MAX_WIDTH)
    width = -(-dim // chunks)
    if dim % 4 == 0:
        width = -(-width // 4) * 4
    stride = min(w for w in PACKED_STRIDES if w >= width)
    col_tiles = -(-dim // width)
    # A row: stride floats and a byte (16 bytes of bytes at a time).
    fit = (PACKED_MAX_SMEM - PACKED_FIXED_SMEM - 15) // (4 * stride + 1)
    row_tiles = -(-head_rows // fit)
    tile_rows = -(-head_rows // row_tiles)  # as even as may be
    tiles = row_tiles * col_tiles
    smem_bytes = (PACKED_FIXED_SMEM + 4 * tile_rows * stride
                  + -(-tile_rows // 16) * 16)
    slices = max(1, min(sms // tiles, -(-batch // PACKED_SLICE_IDS), 65535))
    cluster = min(PACKED_MAX_CLUSTER, slices)
    slices -= slices % cluster
    if resident is not None:
        most = resident(width, smem_bytes, cluster)
        if tiles <= most < tiles * (slices // cluster):
            slices = most // tiles * cluster
    groups = slices // cluster
    return PackedPlan(
        width=width, stride=stride, col_tiles=col_tiles, tile_rows=tile_rows,
        row_tiles=row_tiles, slices=slices, cluster=cluster, groups=groups,
        smem_bytes=smem_bytes,
        partial_words=groups * head_rows * dim if groups > 1 else 0)


@functools.lru_cache(maxsize=None)
def _resident(device: torch.device, width: int, smem_bytes: int,
              cluster: int) -> int:
    with torch.cuda.device(device):
        return _build.library().fps_packed_clusters_resident(
            width, smem_bytes, cluster)


@functools.lru_cache(maxsize=256)
def card_packed_plan(device: torch.device, batch: int, head_rows: int,
                     dim: int) -> PackedPlan:
    """:func:`packed_plan` for the CUDA ``device``: its multiprocessors, and
    the clusters it holds at once (``cudaOccupancyMaxActiveClusters``, which
    builds the kernels). What :func:`scatter_add_packed_cuda_` launches; a
    training loop asks for the same few shapes every step."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return packed_plan(batch, head_rows, dim, sms,
                       functools.partial(_resident, device))


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
                             deltas: torch.Tensor, hot_rows: int, *,
                             plan: PackedPlan | None = None) -> torch.Tensor:
    """K3 on the card, in place: ``table[r] += sum of deltas[b] with
    ids[b] == r`` for the head rows ``[0, H)``, ``H = min(hot_rows, R)``, of
    the ``(R, D)`` float32 table, ``(B,)`` int32 ids and ``(B, D)`` float32
    deltas; ids outside ``[0, H)`` are left alone. Exact float32 sums in a
    fixed order: the same inputs and plan give the same bits. ``plan``
    (default :func:`card_packed_plan`) is for tests and measurements; the
    kernel refuses one it cannot run. Returns ``table``."""
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
    if plan is None:
        plan = card_packed_plan(table.device, B, H, D)
    partial = torch.empty(max(1, plan.partial_words), dtype=torch.float32,
                          device=table.device)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.fps_scatter_add_packed_f32(
            table.data_ptr(), ids.data_ptr(), deltas.data_ptr(), H, B, D,
            plan.slices, plan.cluster, plan.tile_rows, plan.width,
            partial.data_ptr(), partial.numel(), _stream(table))
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
