"""What the plain references share: precisions, the mean fold, norms.

A reference runs in one of three precisions. ``fp32`` is the one the
configurations state: float32 storage and arithmetic, TF32 off. ``tf32`` and
``bf16`` are the controls one step below it: float32 with the dot products'
matrix multiplications in TF32, and bfloat16 tables and arithmetic.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("fp32", "tf32", "bf16")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.bfloat16 if precision == "bf16" else torch.float32


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 on for ``tf32`` and off otherwise, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(N, K)`` dot products of rows ``a (N, D)`` with ``b (N, K, D)``, as
    a batched matrix product (so TF32, where on, applies)."""
    return torch.bmm(b, a[:, :, None])[..., 0]


def mean_fold(table: torch.Tensor, ids: torch.Tensor,
              deltas: torch.Tensor) -> torch.Tensor:
    """Each row touched by ``ids`` (negative ids dropped) moves by the mean
    of its deltas; other rows stay. In place; returns ``table``."""
    keep = ids >= 0
    ids = ids[keep].to(torch.int64)
    deltas = deltas[keep].to(table.dtype)
    total = torch.zeros_like(table).index_add_(0, ids, deltas)
    count = torch.zeros(table.shape[0], dtype=table.dtype,
                        device=table.device).index_add_(
        0, ids, torch.ones_like(ids, dtype=table.dtype))
    return table.add_(total / torch.clamp(count, min=1.0)[:, None])


def sum_fold(table: torch.Tensor, ids: torch.Tensor,
             deltas: torch.Tensor) -> torch.Tensor:
    """Every delta added to its row (negative ids dropped). In place."""
    keep = ids >= 0
    return table.index_add_(0, ids[keep].to(torch.int64),
                            deltas[keep].to(table.dtype))

