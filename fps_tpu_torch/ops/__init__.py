"""Row gather and duplicate-combining scatter-add: the two local operations
the store's pull and push come down to.

Port of ``fps_tpu/ops/__init__.py`` (``gather_rows``, ``scatter_add``). The
choice of implementation is the device the table lies on and the kernel's
contract, and nothing else: a CUDA table of one column goes to the scalar
kernels (K5 gather, K4 scatter-add), any other CUDA table to the row kernels
(K1, K2), each in :mod:`fps_tpu_torch.ops.kernels`, which raise on what they
do not take; a CPU tensor goes to the kernel's plain PyTorch version. There
are no routing thresholds (the JAX package's were measured on a TPU, and its
``SCATTER_FLOP_BUDGET`` fallback is gone) and no fallback from one to the
other.

Routes a push takes with ``hot_rows = H > 0`` (``TableSpec.hot_ids``):

* ``head_prefix > 0`` on a scalar table: the head-prefix route. The leading
  ``head_prefix`` ids fold through the kernel on the head view
  ``table[:H]`` and the rest through the whole table, as in the JAX
  package; a read is one call (K5, or its plain version, with a bound a
  position), where the JAX package makes two and concatenates.
* a table wider than one column, ``H >= R``: the whole push through K3, the
  head scatter-add, with no tail.
* a table wider than one column, ``0 < H < R``: the hot/cold split. Ids in
  ``[0, H)`` go to K3 into ``table[:H]``; the rest go to K2 with the head ids
  rewritten to ``-1``.
* a scalar ``(R, 1)`` table without the prefix route: K4 alone, ``H``
  ignored. K4 already sums every run of equal ids by a tree without walking
  it serially, so a hot head costs it nothing extra, and the JAX package
  also gives its scalar route precedence over the split; the function is
  the same either way.

A read ignores ``hot_rows`` except on the head-prefix route.

:func:`packed_crossover_rows` is the ``TableSpec.hot_ids="auto"`` policy,
with thresholds measured on the H100.
"""

from __future__ import annotations

import torch

from fps_tpu_torch.analysis import record as _record
from fps_tpu_torch.ops import kernels

Tensor = torch.Tensor


def packed_crossover_rows(dim: int) -> int:
    """The ``TableSpec.hot_ids="auto"`` policy: the most rows a shard may
    have for its whole push to take K3 (``hot_rows = R``) rather than K2.

    Measured by ``chip_smoke.py`` phase 3 on an NVIDIA H100 80GB HBM3 at
    700.00 W: K3 over the whole table against K2 with its radix sort,
    B = 32,768 Zipf(0.8) ids (the JAX package's sweep shape), R from 512 to
    32,768. K3 was not slower than K2 through R = 16,384 at D = 10, 8,192
    at D = 32, 1,024 at D = 100 and 512 at D = 200. Between measured widths
    the threshold of the wider one applies, so a table wider than 200
    columns always takes K2. ``PERF.md`` has the sweep's times.
    """
    for width, rows in _PACKED_CROSSOVER:
        if dim <= width:
            return rows
    return 0


# (widest D, most rows) from the sweep above; wider than 200: K2.
_PACKED_CROSSOVER = ((10, 16_384), (32, 8_192), (100, 1_024), (200, 512))


def _on(table: Tensor, fn: str) -> str:
    if table.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: unsupported device {table.device}")
    return table.device.type


def _head_route(table: Tensor, head_prefix: int, hot_rows: int) -> bool:
    """The JAX package's head-prefix route, by contract only: a scalar table
    with a declared head and a guaranteed prefix."""
    return head_prefix > 0 and hot_rows > 0 and table.shape[1] == 1


def _kernel(name: str, fn, launches: bool, *args):
    """``fn(*args)``, recorded as kernel ``name`` (where ``launches``: the
    card's wrapper counts a launch for these inputs) while a program
    record is taken on this thread (:mod:`fps_tpu_torch.analysis.
    record`)."""
    rec = _record.active()
    if rec is None or rec.depth:
        return fn(*args)
    return rec.kernel(name, lambda: fn(*args), args[:3], launches)


def _gather(table: Tensor, ids: Tensor, hot_rows: int = 0,
            head_prefix: int = 0) -> Tensor:
    cuda = _on(table, "gather_rows") == "cuda"
    B = ids.shape[0]
    if table.shape[1] == 1:
        fn = (kernels.gather_rows_dim1_cuda if cuda
              else kernels.gather_rows_dim1_plain)
        return _kernel("gather_rows_dim1", lambda t, i: fn(
            t, i, head_rows=hot_rows, head_prefix=head_prefix), B > 0,
            table, ids)
    return _kernel("gather_rows", kernels.gather_rows_cuda if cuda
                   else kernels.gather_rows_plain, B * table.shape[1] > 0,
                   table, ids)


def _scatter_(table: Tensor, ids: Tensor, deltas: Tensor,
              hot_rows: int = 0) -> Tensor:
    cuda = _on(table, "scatter_add_") == "cuda"
    R, D = table.shape
    B = ids.shape[0]
    if D == 1:
        return _kernel("scatter_add_dim1", kernels.scatter_add_dim1_cuda_
                       if cuda else kernels.scatter_add_dim1_plain,
                       B * R > 0, table, ids, deltas)
    rows = (kernels.scatter_add_cuda_ if cuda
            else kernels.scatter_add_plain)
    if hot_rows > 0 and R > 0:
        head = (kernels.scatter_add_packed_cuda_ if cuda
                else kernels.scatter_add_packed_plain)
        H = min(hot_rows, R)
        if hot_rows >= R:
            return _kernel("scatter_add_packed", head, B * D * H > 0, table,
                           ids, deltas, R)
        _kernel("scatter_add_packed", head, B * D * H > 0, table, ids,
                deltas, hot_rows)
        in_head = (ids >= 0) & (ids < hot_rows)
        return _kernel("scatter_add", rows, B * D > 0, table,
                       torch.where(in_head, -1, ids), deltas)
    return _kernel("scatter_add", rows, B * D > 0, table, ids, deltas)


def gather_rows(table: Tensor, ids: Tensor, *, hot_rows: int = 0,
                head_prefix: int = 0, exact: bool = False) -> Tensor:
    """``table[ids]``; ids outside ``[0, rows)`` yield zero rows.

    ``head_prefix > 0`` with ``hot_rows = H > 0`` on a scalar table asserts
    that ``ids[:head_prefix]`` lie in ``[0, H) ∪ {-1}`` (the frequency head
    that ``head_sort_slots`` puts first): those ids read from ``table[:H]``,
    so an id ``>= H`` inside the prefix reads zero, the JAX package's
    documented contract. Without that route ``hot_rows`` changes nothing
    for a read.

    Every read is exact on both devices, so ``exact`` (the JAX package's
    escape from its lossy scalar-table route) changes nothing here; it is
    kept so callers read the same in both packages.
    """
    if _head_route(table, head_prefix, hot_rows):
        return _gather(table, ids, hot_rows, head_prefix)
    return _gather(table, ids)


def scatter_add_(table: Tensor, ids: Tensor, deltas: Tensor, *,
                 hot_rows: int = 0, head_prefix: int = 0) -> Tensor:
    """In place: ``table[ids] += deltas``; ids outside ``[0, rows)`` are
    dropped, duplicate ids accumulate. Returns ``table``.

    With the head-prefix route (see :func:`gather_rows`) the leading
    ``head_prefix`` pushes fold into ``table[:H]`` (a push to an id ``>= H``
    there is dropped) and the rest into the whole table. Otherwise
    ``hot_rows = H > 0`` on a table wider than one column takes the hot/cold
    split (K3 for the head, K2 for the tail; K3 alone when ``H >= R``); the
    sums are the same, in another order.
    """
    if _head_route(table, head_prefix, hot_rows):
        _scatter_(table[:hot_rows], ids[:head_prefix], deltas[:head_prefix])
        return _scatter_(table, ids[head_prefix:], deltas[head_prefix:])
    return _scatter_(table, ids, deltas, hot_rows)


def scatter_add(table: Tensor, ids: Tensor, deltas: Tensor, *,
                hot_rows: int = 0, head_prefix: int = 0) -> Tensor:
    """``table.at[ids].add(deltas)`` as in the JAX package: a new table;
    ``table`` itself is left as it was."""
    return scatter_add_(table.clone(), ids, deltas, hot_rows=hot_rows,
                        head_prefix=head_prefix)
