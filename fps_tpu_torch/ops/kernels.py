"""The port's hand-written CUDA kernels, each beside its plain version.

For each kernel this module holds the CUDA wrapper, the plain PyTorch version
of the same function, and the wrapper's launch counter (a plain int,
``<wrapper>.launches``, raised by one where the wrapper launches its kernel
and nowhere else). The wrappers take CUDA tensors only and raise on anything
else; :mod:`fps_tpu_torch.ops` chooses between kernel and plain version by
the device the tensor lies on.

K1 ``gather_rows_cuda`` (``csrc/gather_rows.cu``) replaces
``gather_rows_pallas`` (``fps_tpu/ops/pallas_kernels.py``). It is bound by
the bytes it moves (the requested rows read once, the output written once)
and, at the smaller pulls, by the latency of the id load and the dependent
table load. The output is cut into 16-byte chunks; a thread loads the one
or two ids of each of its chunks, then their table values (8 or 16 bytes a
load where D allows), then writes them with streaming stores, a chunk a
pass over a grid of one wave; a bounds check writes zero for an id outside
``[0, R)`` in place of the TPU kernel's one-hot matmul over every row
tile. :func:`gather_plan` picks the kernel
instance (a compiled D for the paths' widths) and the grid.

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
paths that use it, stays in L2) and the latency of the dependent loads. It
cuts the output as K1 does: four ids a chunk with one 16-byte load (4-byte
loads on a misaligned view), four values, one 16-byte streaming store; a
bounds check writes zero for a dropped id. The head-prefix route is one
launch: the first ``head_prefix`` positions read against ``head_rows``
rows, the rest against ``R``. Every read goes to L2 (staging the head or a
small table in shared memory measured no faster). The read is exact, where
the TPU kernel's hi+lo bf16 read keeps about 16 mantissa bits.

K4 ``scatter_add_dim1_cuda_`` (``csrc/scatter_add_dim1.cu``) replaces
``scatter_add_dim1_pallas``, the push into an ``(R, 1)`` table. It is bound
by bytes and must be deterministic, like K2, and must not serialise on the
Zipf-hot features of a 2^20-id scalar push, with no library sort. A row is
one float, so a row tile of about 50,000 rows fits in a block's shared
memory: the whole table on every path but the 1M-feature logistic
regression, which first takes a bucket pass by row tile (a count, then a
stable write of each push's id and delta into its tile's stretch). The
tile pass cuts the pushes, in bucket order, evenly over clusters of 8
blocks whatever the tiles hold; each block sums its share into the tile in
shared memory (each chunk of 1,024 ranked by row, K3's ranking, each run
by a fixed tree), the cluster sums its tiles through distributed shared
memory in rank order, and a fold adds the clusters' partials in order
where a tile had more than one. 1 to 4 kernels a call (:func:`dim1_plan`,
:func:`card_dim1_plan`); no atomics, the same bits on every launch.

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
    # Each message is formatted only where its check fails: these checks run
    # on every launch of a host-bound step.
    if not (table.is_cuda and ids.is_cuda):
        raise ValueError(f"{fn}: table and ids must be CUDA tensors "
                         f"(got {table.device}, {ids.device})")
    if table.device != ids.device:
        raise ValueError(f"{fn}: table on {table.device}, ids on "
                         f"{ids.device}")
    if not (table.dtype == torch.float32 and table.dim() == 2):
        raise ValueError(f"{fn}: table must be 2-D float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if not (ids.dtype == torch.int32 and ids.dim() == 1):
        raise ValueError(f"{fn}: ids must be 1-D int32, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{fn}: table and ids must be contiguous")
    if table.shape[0] >= 2**31:
        raise ValueError(f"{fn}: table has >= 2**31 rows")


H100_SMS = 132  # multiprocessors of an H100 SXM, where the card is not asked

# ---------------------------------------------------------------------------
# K1: gather
# ---------------------------------------------------------------------------

# The constants of csrc/gather.cuh and csrc/gather_rows.cu that shape the
# gathers' plan.
GATHER_THREADS = 256     # kThreads: a block, a 16-byte output chunk a thread
GATHER_WIDTHS = (2, 3, 10, 11, 20)  # the D with an instance of their own
# Blocks of 256 threads an SM holds at once where the card is not asked:
# 2,048 threads, an SM's most.
GATHER_BLOCKS_PER_SM = 8


class GatherPlan(NamedTuple):
    """How K1 and K5 cut a gather: the kernel instance (``width``, the D
    compiled in: 0 for any D read at run time, 1 for K5's scalar kernel;
    ``vec`` floats a table load; ``index_bits`` of the flat output index;
    ``aligned_ids``, K5's 16-byte id loads) and ``blocks``."""
    width: int
    vec: int
    index_bits: int
    aligned_ids: bool
    blocks: int


def gather_plan(batch: int, dim: int, ids_offset_bytes: int = 0,
                sms: int = H100_SMS, *, table_offset_bytes: int = 0,
                resident=None) -> GatherPlan:
    """The plan of a gather of ``batch`` ids from a table of ``dim``
    columns whose ids and table start ``ids_offset_bytes`` and
    ``table_offset_bytes`` past a 16-byte boundary, on a card of ``sms``
    multiprocessors.

    The instance: D = 1 takes K5's scalar kernel, a D in
    ``GATHER_WIDTHS`` its own, any other D the one that reads it at run
    time; the table loads are 16 bytes where D is a multiple of 4, 8 where
    it is even, 4 otherwise, each only where the table's base is so
    aligned; the index math is 32-bit while ``batch * dim < 2^31``, past
    that one 64-bit instance (any D, 4-byte loads). K5 loads ids 16 bytes
    at a time where they are so aligned. A thread takes one 16-byte output
    chunk a pass; the grid is as many blocks of ``GATHER_THREADS`` as the
    chunks need, at most one wave: ``resident(plan)`` blocks a
    multiprocessor, the most of the plan's instance one holds
    (``GATHER_BLOCKS_PER_SM`` where it is not given).
    """
    batch, dim, ids_offset_bytes, sms, table_offset_bytes = (
        operator.index(x) for x in (batch, dim, ids_offset_bytes, sms,
                                    table_offset_bytes))
    _check(batch >= 0 and dim >= 1 and sms >= 1,
           f"gather_plan: batch {batch}, dim {dim}, sms {sms}")
    n = batch * dim
    index_bits = 32 if n < 2**31 else 64
    if dim == 1:
        width, vec = 1, 1
    elif index_bits == 64:
        width, vec = 0, 1
    else:
        width = dim if dim in GATHER_WIDTHS else 0
        vec = next(v for v in (4, 2, 1)
                   if dim % v == 0 and table_offset_bytes % (4 * v) == 0)
    plan = GatherPlan(width=width, vec=vec, index_bits=index_bits,
                      aligned_ids=dim == 1 and ids_offset_bytes % 16 == 0,
                      blocks=0)
    per_sm = GATHER_BLOCKS_PER_SM if resident is None else resident(plan)
    chunks = -(-n // 4)
    return plan._replace(blocks=max(1, min(-(-chunks // GATHER_THREADS),
                                           sms * per_sm)))


@functools.lru_cache(maxsize=None)
def _gather_resident(device: int, plan: GatherPlan) -> int:
    lib = _build.library()
    with torch.cuda.device(device):
        if plan.width == 1:
            return lib.fps_gather_dim1_blocks_per_sm(int(plan.aligned_ids))
        return lib.fps_gather_rows_blocks_per_sm(plan.width, plan.vec,
                                                 plan.index_bits)


@functools.lru_cache(maxsize=1024)
def card_gather_plan(device: int, batch: int, dim: int,
                     ids_offset_bytes: int = 0,
                     table_offset_bytes: int = 0) -> GatherPlan:
    """:func:`gather_plan` for the CUDA device of index ``device``: its
    multiprocessors, and the blocks of the plan's instance one holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, which builds
    the kernels). What :func:`gather_rows_cuda` and
    :func:`gather_rows_dim1_cuda` launch; a training loop asks for the same
    few shapes every step, so the key is a few ints."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return gather_plan(batch, dim, ids_offset_bytes, sms,
                       table_offset_bytes=table_offset_bytes,
                       resident=functools.partial(_gather_resident, device))


def card_plan_for(table: torch.Tensor, ids: torch.Tensor) -> GatherPlan:
    """The plan :func:`gather_rows_cuda` or :func:`gather_rows_dim1_cuda`
    launches for these CUDA tensors."""
    return card_gather_plan(table.device.index, ids.shape[0], table.shape[1],
                            ids.data_ptr() % 16, table.data_ptr() % 16)


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, zero rows for ids outside ``[0, R)``."""
    R = table.shape[0]
    in_range = (ids >= 0) & (ids < R)
    if R == 0:
        return table.new_zeros((ids.shape[0], table.shape[1]))
    vals = table.index_select(0, torch.where(in_range, ids, 0))
    return torch.where(in_range[:, None], vals, torch.zeros_like(vals))


def gather_rows_cuda(table: torch.Tensor, ids: torch.Tensor, *,
                     plan: GatherPlan | None = None) -> torch.Tensor:
    """K1 on the card: ``(B, D)`` rows of the ``(R, D)`` float32 table for
    ``(B,)`` int32 ids, zero rows for ids outside ``[0, R)``; the bits of
    :func:`gather_rows_plain`. One launch. A table of one column is K5's
    (:func:`gather_rows_dim1_cuda`; :func:`fps_tpu_torch.ops.gather_rows`
    routes it there) and is refused. ``plan`` (default
    :func:`card_plan_for`) is for tests and measurements; the kernel
    refuses one it cannot run."""
    fn = "gather_rows_cuda"
    _check_table_ids(fn, table, ids)
    _check_batch(fn, ids)
    R, D = table.shape
    if D == 1:
        raise ValueError(f"{fn}: an (R, 1) table is K5's "
                         "(gather_rows_dim1_cuda)")
    B = ids.shape[0]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B * D == 0:
        return out
    if plan is None:
        plan = card_plan_for(table, ids)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.fps_gather_rows_f32(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), R, B, D,
            plan.width, plan.vec, plan.index_bits, plan.blocks,
            _stream(table))
    _raise_on_error(rc, fn)
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
    if ids.shape[0] >= 2**31:
        raise ValueError(f"{fn}: batch has >= 2**31 ids")


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
    if not (table.dim() == 2 and table.shape[1] == 1):
        raise ValueError(f"{fn}: table must be (R, 1), got "
                         f"{tuple(table.shape)}")


def _head(fn: str, table: torch.Tensor, ids: torch.Tensor, head_rows,
          head_prefix) -> tuple[int, int]:
    """``(H, q)``: the head ``min(head_rows, R)`` and the prefix
    ``min(head_prefix, B)``, both >= 0."""
    head_rows, head_prefix = (operator.index(head_rows),
                              operator.index(head_prefix))
    if head_rows < 0 or head_prefix < 0:
        raise ValueError(f"{fn}: head_rows {head_rows} and head_prefix "
                         f"{head_prefix} must be >= 0")
    return min(head_rows, table.shape[0]), min(head_prefix, ids.shape[0])


def gather_rows_dim1_plain(table: torch.Tensor, ids: torch.Tensor, *,
                           head_rows: int = 0,
                           head_prefix: int = 0) -> torch.Tensor:
    """``table[ids]`` for an ``(R, 1)`` table, zero for ids outside
    ``[0, R)``; the first ``head_prefix`` positions read against the head
    ``table[:head_rows]`` instead, so an id ``>= head_rows`` there reads
    zero (the head-prefix route in one call)."""
    fn = "gather_rows_dim1_plain"
    _check_dim1(fn, table)
    H, q = _head(fn, table, ids, head_rows, head_prefix)
    if q > 0:
        head = ids[:q]
        ids = torch.cat([torch.where(head < H, head, -1), ids[q:]])
    return gather_rows_plain(table, ids)


def gather_rows_dim1_cuda(table: torch.Tensor, ids: torch.Tensor, *,
                          head_rows: int = 0, head_prefix: int = 0,
                          plan: GatherPlan | None = None) -> torch.Tensor:
    """K5 on the card: ``(B, 1)`` values of the ``(R, 1)`` float32 table for
    ``(B,)`` int32 ids, zero for ids outside ``[0, R)``, the first
    ``head_prefix`` positions read against ``table[:head_rows]``; the bits
    of :func:`gather_rows_dim1_plain`, in one launch. ``plan`` (default
    :func:`card_plan_for`) is for tests and measurements; the kernel
    refuses one it cannot run."""
    fn = "gather_rows_dim1_cuda"
    _check_table_ids(fn, table, ids)
    _check_dim1(fn, table)
    _check_batch(fn, ids)
    H, q = _head(fn, table, ids, head_rows, head_prefix)
    B = ids.shape[0]
    out = torch.empty((B, 1), dtype=table.dtype, device=table.device)
    if B == 0:
        return out
    if plan is None:
        plan = card_plan_for(table, ids)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.fps_gather_rows_dim1_f32(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), table.shape[0],
            B, H, q, int(plan.aligned_ids), plan.blocks, _stream(table))
    _raise_on_error(rc, fn)
    gather_rows_dim1_cuda.launches += 1
    return out


gather_rows_dim1_cuda.launches = 0


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

# ---------------------------------------------------------------------------
# K4: scalar-table scatter-add
# ---------------------------------------------------------------------------

# The constants of csrc/scatter_add_dim1.cu that shape its plan.
DIM1_CHUNK = 1024           # kTileChunk: pushes the tile pass sums at once
DIM1_MAX_CLUSTER = 8        # kMaxCluster
# Blocks a cluster of the tile pass with a bucket pass: each piece's
# reduction through distributed shared memory reads half as many tiles.
DIM1_BUCKETED_CLUSTER = 4
DIM1_MAX_BUCKETS = 256      # kMaxBuckets: buckets of the bucket pass
DIM1_MAX_BUCKET_BLOCKS = 512  # kMaxBucketBlocks: blocks of the bucket pass
DIM1_FIXED_SMEM = 17_424    # kFixedSmem: shared memory beside the row tile
DIM1_GROUP_ROWS = 4         # kGroupRows: rows a written-flag byte
DIM1_TILE_ALIGN = 64        # kTileAlign: tile rows come in multiples of it
DIM1_BUCKET_IDS = 2048      # kChunk: fewest ids a block of the bucket pass
                            # takes, a round of it
# What a piece of a bucket costs the tile pass beside its pushes, in pushes:
# the weight of each bucket in the cut of the pushes over the clusters.
DIM1_PIECE_PUSHES = 16_384
# The most rows a tile holds: a float a row and a flag byte for each
# DIM1_GROUP_ROWS rows beside the fixed staging, in a block's shared memory.
DIM1_MAX_TILE_ROWS = ((PACKED_MAX_SMEM - DIM1_FIXED_SMEM) * DIM1_GROUP_ROWS
                      // (4 * DIM1_GROUP_ROWS + 1)
                      // DIM1_TILE_ALIGN * DIM1_TILE_ALIGN)


def _dim1_smem(tile_rows: int) -> int:
    return DIM1_FIXED_SMEM + 4 * tile_rows + tile_rows // DIM1_GROUP_ROWS


class Dim1Plan(NamedTuple):
    """How K4 cuts a push: row tiles of ``tile_rows`` rows (``row_tiles``
    of them), ``tiles_per_bucket`` a bucket of ``bucket_rows`` rows,
    ``buckets`` buckets (one: no bucket pass) counted and written by
    ``bucket_blocks`` blocks; the tile pass in ``clusters`` clusters of
    ``cluster`` blocks, ``smem_bytes`` of shared memory a block, each
    bucket weighing ``piece_weight`` pushes more than it holds in the cut
    of the pushes over the clusters; and the
    kernels a call: 2 for the bucket pass, 1 for the tile pass, 1 for the
    fold with more than one cluster."""
    tile_rows: int
    row_tiles: int
    tiles_per_bucket: int
    bucket_rows: int
    buckets: int
    bucket_blocks: int
    piece_weight: int
    cluster: int
    clusters: int
    smem_bytes: int
    kernels: int


def dim1_plan(batch: int, rows: int, sms: int = H100_SMS,
              resident=None) -> Dim1Plan:
    """K4's plan for a push of ``batch`` ids into an ``(rows, 1)`` table on
    a card of ``sms`` multiprocessors.

    Row tiles: as few as fit a float a row and a flag byte for each 4 rows
    in ``PACKED_MAX_SMEM`` beside the fixed staging
    (``DIM1_MAX_TILE_ROWS``), as even as may be, a multiple of
    ``DIM1_TILE_ALIGN`` rows. More than one
    tile takes a bucket pass by tile, at most ``DIM1_MAX_BUCKETS`` buckets
    (past that many tiles, a bucket holds several), its blocks at least
    ``DIM1_BUCKET_IDS`` ids each, at most two a multiprocessor (and
    ``DIM1_MAX_BUCKET_BLOCKS``); each bucket then weighs
    ``DIM1_PIECE_PUSHES`` more in the cut.
    The tile pass: about one block a multiprocessor, at least a chunk
    (``DIM1_CHUNK``) of ids each, in clusters of ``DIM1_MAX_CLUSTER``
    (``DIM1_BUCKETED_CLUSTER`` with a bucket pass), or all of them if
    fewer. ``resident(smem_bytes, cluster)``, where given, is the most
    clusters the card holds at once; the clusters are cut to that, so that
    they run in one wave. The kernels a call follow from ``(batch, rows)``
    and never from the ids.
    """
    batch, rows, sms = (operator.index(x) for x in (batch, rows, sms))
    _check(batch >= 0 and rows >= 1 and sms >= 1,
           f"dim1_plan: batch {batch}, rows {rows}, sms {sms}")
    row_tiles = -(-rows // DIM1_MAX_TILE_ROWS)
    tile_rows = -(-rows // row_tiles)  # as even as may be
    tile_rows = -(-tile_rows // DIM1_TILE_ALIGN) * DIM1_TILE_ALIGN
    tiles_per_bucket = -(-row_tiles // DIM1_MAX_BUCKETS)
    buckets = -(-row_tiles // tiles_per_bucket)
    bucket_blocks = (0 if buckets == 1 else
                     max(1, min(2 * sms, DIM1_MAX_BUCKET_BLOCKS,
                                -(-batch // DIM1_BUCKET_IDS))))
    blocks = max(1, min(sms, -(-batch // DIM1_CHUNK), 65535))
    cluster = min(DIM1_MAX_CLUSTER if buckets == 1 else DIM1_BUCKETED_CLUSTER,
                  blocks)
    clusters = blocks // cluster
    smem_bytes = _dim1_smem(tile_rows)
    if resident is not None:
        most = resident(smem_bytes, cluster)
        if 1 <= most < clusters:
            clusters = most
    return Dim1Plan(
        tile_rows=tile_rows, row_tiles=row_tiles,
        tiles_per_bucket=tiles_per_bucket,
        bucket_rows=tiles_per_bucket * tile_rows, buckets=buckets,
        bucket_blocks=bucket_blocks,
        piece_weight=DIM1_PIECE_PUSHES if buckets > 1 else 0,
        cluster=cluster, clusters=clusters,
        smem_bytes=smem_bytes,
        kernels=(2 if buckets > 1 else 0) + 1 + (clusters > 1))


def _dim1_bucket_words(batch: int, plan: Dim1Plan) -> int:
    """int32 scratch of the bucket pass: the kept ids and deltas in bucket
    order, the blocks' counts, the buckets' starts; a multiple of 4."""
    if plan.buckets == 1:
        return 0
    n = 2 * batch + plan.bucket_blocks * plan.buckets + plan.buckets + 1
    return -(-n // 4) * 4


def dim1_work_words(batch: int, plan: Dim1Plan) -> int:
    """int32 scratch of a K4 call: the bucket pass's, then, with more than
    one cluster, a partial of every row of a bucket a slot, for the
    ``clusters + buckets - 1`` slots a cluster's pieces can take."""
    partial = ((plan.clusters + plan.buckets - 1) * plan.bucket_rows
               if plan.clusters > 1 else 0)
    return _dim1_bucket_words(batch, plan) + partial


@functools.lru_cache(maxsize=None)
def _dim1_resident(device: torch.device, smem_bytes: int,
                   cluster: int) -> int:
    with torch.cuda.device(device):
        return _build.library().fps_dim1_clusters_resident(smem_bytes,
                                                           cluster)


@functools.lru_cache(maxsize=256)
def card_dim1_plan(device: torch.device, batch: int, rows: int) -> Dim1Plan:
    """:func:`dim1_plan` for the CUDA ``device``: its multiprocessors, and
    the clusters it holds at once (``cudaOccupancyMaxActiveClusters``,
    which builds the kernels). What :func:`scatter_add_dim1_cuda_`
    launches."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return dim1_plan(batch, rows, sms, functools.partial(_dim1_resident,
                                                         device))


def scatter_add_dim1_plain(table: torch.Tensor, ids: torch.Tensor,
                           deltas: torch.Tensor) -> torch.Tensor:
    """In place, for an ``(R, 1)`` table: ``table[ids[b]] += deltas[b]``;
    duplicates add, ids outside ``[0, R)`` are dropped. Returns ``table``."""
    _check_dim1("scatter_add_dim1_plain", table)
    return scatter_add_plain(table, ids, deltas)


def _check_dim1_push(fn: str, table: torch.Tensor, ids: torch.Tensor,
                     deltas: torch.Tensor) -> None:
    _check_table_ids(fn, table, ids)
    _check_dim1(fn, table)
    _check_batch(fn, ids)
    _check(deltas.is_cuda and deltas.device == table.device,
           f"{fn}: deltas on {deltas.device}, table on {table.device}")
    _check(deltas.dtype == torch.float32 and deltas.is_contiguous(),
           f"{fn}: deltas must be contiguous float32")
    B = ids.shape[0]
    _check(tuple(deltas.shape) == (B, 1),
           f"{fn}: deltas {tuple(deltas.shape)} != ({B}, 1)")


def scatter_add_dim1_cuda_(table: torch.Tensor, ids: torch.Tensor,
                           deltas: torch.Tensor, *,
                           plan: Dim1Plan | None = None) -> torch.Tensor:
    """K4 on the card, in place: ``table[ids[b]] += deltas[b]`` for the
    ``(R, 1)`` float32 table, ``(B,)`` int32 ids and ``(B, 1)`` float32
    deltas; duplicates add in a fixed tree order, ids outside ``[0, R)`` are
    dropped. Deterministic: the same inputs and plan give the same bits.
    One C call launches the plan's kernels; ``plan`` (default
    :func:`card_dim1_plan`) is for tests and measurements, and the kernel
    refuses one it cannot run. Returns ``table``."""
    fn = "scatter_add_dim1_cuda_"
    _check_dim1_push(fn, table, ids, deltas)
    R = table.shape[0]
    B = ids.shape[0]
    if B == 0 or R == 0:
        return table
    if plan is None:
        plan = card_dim1_plan(table.device, B, R)
    work = torch.empty(max(1, dim1_work_words(B, plan)), dtype=torch.int32,
                       device=table.device)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.fps_scatter_add_dim1_f32(
            table.data_ptr(), ids.data_ptr(), deltas.data_ptr(), R, B,
            plan.tile_rows, plan.tiles_per_bucket, plan.buckets,
            plan.bucket_blocks, plan.piece_weight, plan.cluster, plan.clusters,
            work.data_ptr(), work.numel(), _stream(table))
    _raise_on_error(rc, fn)
    scatter_add_dim1_cuda_.launches += 1
    return table


scatter_add_dim1_cuda_.launches = 0


def dim1_bucket_plain(ids: torch.Tensor, deltas: torch.Tensor,
                      num_rows: int, bucket_rows: int, buckets: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ids, values, starts)``: the ids in ``[0, num_rows)`` and their
    deltas (flat), ordered by bucket ``id // bucket_rows`` and in batch
    order within one (a boolean select a bucket), and the int32 start of
    each of the ``buckets`` buckets, then the count kept."""
    keep = (ids >= 0) & (ids < num_rows)
    kid, kd = ids[keep], deltas.reshape(-1)[keep]
    bucket = torch.div(kid, bucket_rows, rounding_mode="floor")
    ins = [bucket == b for b in range(buckets)]
    counts = torch.stack([m.sum() for m in ins])
    starts = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return (torch.cat([kid[m] for m in ins]), torch.cat([kd[m] for m in ins]),
            starts.to(torch.int32))


def dim1_bucket_cuda(ids: torch.Tensor, deltas: torch.Tensor, num_rows: int,
                     *, plan: Dim1Plan | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's bucket pass on the card, alone: what :func:`dim1_bucket_plain`
    returns for the plan's buckets, except that the ids and values are
    ``(B,)`` and only their first ``starts[-1]`` entries are written (no
    host sync). K4 runs the same kernels inside its own C call; this
    wrapper serves the tests and ``chip_smoke.py``."""
    fn = "dim1_bucket_cuda"
    _check(ids.is_cuda and ids.dtype == torch.int32 and ids.dim() == 1 and
           ids.is_contiguous(),
           f"{fn}: ids must be contiguous 1-D int32 on the card, got "
           f"{tuple(ids.shape)} {ids.dtype} on {ids.device}")
    _check_batch(fn, ids)
    B = ids.shape[0]
    _check(deltas.device == ids.device and deltas.dtype == torch.float32
           and deltas.is_contiguous() and deltas.numel() == B,
           f"{fn}: deltas must be {B} contiguous float32 beside the ids")
    num_rows = operator.index(num_rows)
    _check(1 <= num_rows < 2**31, f"{fn}: num_rows {num_rows}")
    if plan is None:
        plan = card_dim1_plan(ids.device, B, num_rows)
    _check(plan.buckets > 1, f"{fn}: a table of one tile takes no bucket "
           "pass")
    work = torch.empty(max(4, _dim1_bucket_words(B, plan)),
                       dtype=torch.int32, device=ids.device)
    if B > 0:
        lib = _build.library()
        with torch.cuda.device(ids.device):
            rc = lib.fps_dim1_bucket_f32(
                ids.data_ptr(), deltas.data_ptr(), num_rows, B,
                plan.bucket_rows, plan.buckets, plan.bucket_blocks,
                work.data_ptr(), work.numel(), _stream(ids))
        _raise_on_error(rc, fn)
        dim1_bucket_cuda.launches += 1
    else:
        work.zero_()
    at = 2 * B + plan.bucket_blocks * plan.buckets
    return (work[:B], work[B:2 * B].view(torch.float32),
            work[at:at + plan.buckets + 1])


dim1_bucket_cuda.launches = 0

WRAPPERS = {"gather_rows": gather_rows_cuda, "scatter_add": scatter_add_cuda_,
            "gather_rows_dim1": gather_rows_dim1_cuda,
            "scatter_add_dim1": scatter_add_dim1_cuda_,
            "scatter_add_packed": scatter_add_packed_cuda_}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
