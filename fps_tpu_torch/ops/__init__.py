"""Row gather and duplicate-combining scatter-add: the two local operations
the store's pull and push come down to.

Port of ``fps_tpu/ops/__init__.py`` (``gather_rows``, ``scatter_add``). The
choice of implementation is the device the table lies on and the kernel's
contract, and nothing else: a CUDA table of one column goes to the scalar
kernels (K5 gather, K4 scatter-add), any other CUDA table to the row kernels
(K1, K2), each in :mod:`fps_tpu_torch.ops.kernels`, which raise on what they
do not take; a CPU tensor goes to the kernel's plain PyTorch version. There
are no routing thresholds (the JAX package's were measured on a TPU) and no
fallback from one to the other.

``head_prefix`` is ported: on a scalar table with ``hot_rows = H > 0`` the
leading ``head_prefix`` ids go through the kernel on the head view
``table[:H]`` and the rest through the whole table, as in the JAX package.
The lane-packed hot/cold push split (``hot_rows`` without a prefix route,
kernel K3) is not ported yet and raises.
"""

from __future__ import annotations

import torch

from fps_tpu_torch.ops import kernels

Tensor = torch.Tensor


def _on(table: Tensor, fn: str) -> str:
    if table.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: unsupported device {table.device}")
    return table.device.type


def _head_route(table: Tensor, head_prefix: int, hot_rows: int) -> bool:
    """The JAX package's head-prefix route, by contract only: a scalar table
    with a declared head and a guaranteed prefix."""
    return head_prefix > 0 and hot_rows > 0 and table.shape[1] == 1


def _gather(table: Tensor, ids: Tensor) -> Tensor:
    cuda = _on(table, "gather_rows") == "cuda"
    if table.shape[1] == 1:
        return (kernels.gather_rows_dim1_cuda if cuda
                else kernels.gather_rows_dim1_plain)(table, ids)
    return (kernels.gather_rows_cuda if cuda
            else kernels.gather_rows_plain)(table, ids)


def _scatter_(table: Tensor, ids: Tensor, deltas: Tensor) -> Tensor:
    cuda = _on(table, "scatter_add_") == "cuda"
    if table.shape[1] == 1:
        return (kernels.scatter_add_dim1_cuda_ if cuda
                else kernels.scatter_add_dim1_plain)(table, ids, deltas)
    return (kernels.scatter_add_cuda_ if cuda
            else kernels.scatter_add_plain)(table, ids, deltas)


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
        head = _gather(table[:hot_rows], ids[:head_prefix])
        tail = _gather(table, ids[head_prefix:])
        return torch.cat([head, tail], 0)
    return _gather(table, ids)


def scatter_add_(table: Tensor, ids: Tensor, deltas: Tensor, *,
                 hot_rows: int = 0, head_prefix: int = 0) -> Tensor:
    """In place: ``table[ids] += deltas``; ids outside ``[0, rows)`` are
    dropped, duplicate ids accumulate. Returns ``table``.

    With the head-prefix route (see :func:`gather_rows`) the leading
    ``head_prefix`` pushes fold into ``table[:H]`` (a push to an id ``>= H``
    there is dropped) and the rest into the whole table.

    Raises:
      NotImplementedError: ``hot_rows > 0`` without the head-prefix route,
        the JAX package's hot/cold split through the lane-packed kernel K3.
    """
    if _head_route(table, head_prefix, hot_rows):
        _scatter_(table[:hot_rows], ids[:head_prefix], deltas[:head_prefix])
        return _scatter_(table, ids[head_prefix:], deltas[head_prefix:])
    if hot_rows:
        raise NotImplementedError(
            f"scatter_add_: hot_rows={hot_rows} without a head-prefix route "
            "takes the hot/cold push split through the lane-packed kernel "
            "K3 (scatter_add_packed_pallas), which is not ported yet "
            "(ROADMAP.md Queue 2)")
    return _scatter_(table, ids, deltas)


def scatter_add(table: Tensor, ids: Tensor, deltas: Tensor, *,
                hot_rows: int = 0, head_prefix: int = 0) -> Tensor:
    """``table.at[ids].add(deltas)`` as in the JAX package: a new table;
    ``table`` itself is left as it was."""
    return scatter_add_(table.clone(), ids, deltas, hot_rows=hot_rows,
                        head_prefix=head_prefix)
