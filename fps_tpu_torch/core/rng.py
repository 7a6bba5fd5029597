"""Seeds and per-id random values for the port.

The JAX package derives every random stream from ``jax.random`` keys
(``fold_in``, ``uniform``, ``randint``). The port does not reproduce those
bits; weights are carried across by :mod:`fps_tpu_torch.convert`. It has two
sources of its own:

* :func:`fold_seed`, the analog of ``jax.random.fold_in`` on integer seeds:
  a seed for a sub-stream (a table, a chunk), for ``torch.Generator``s;
* :func:`uniform_by_id`, a stateless hash of ``(seed, id, column)``, so that
  a table row depends on its id alone: not on the shard count, the number of
  rows drawn, or the device (integer ops and one float multiply-add, each
  exact or correctly rounded, give the same bits on the CPU and the card);
* :func:`counter_bits` and the draws made from it (:func:`uniform_by_counter`,
  :func:`randint_by_counter`), a stateless hash of ``(seed, counter)``: the
  analog of a ``jax.random`` key folded with a step, for draws that must be
  the same on the CPU and the card (``torch.Generator`` streams differ
  between the two). word2vec draws its negatives, keep mask and
  half-windows so.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def _splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def fold_seed(seed: int, data: int) -> int:
    """Seed of the sub-stream ``data`` of ``seed``, in ``[0, 2**63)``."""
    return _splitmix64((_splitmix64(seed & _M64) + data) & _M64) >> 1


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, with no
    intermediate above 2**49 (signed int64 overflow never happens)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply, two rounds)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_by_id(seed: int, ids: torch.Tensor, dim: int, low: float,
                  high: float, dtype=torch.float32) -> torch.Tensor:
    """``(len(ids), dim)`` values in ``[low, high)``; row ``i`` depends only
    on ``(seed, ids[i])``. Computed on ``ids.device``."""
    s = fold_seed(seed, 0) & _M32
    base = _mix32((ids.to(torch.int64) & _M32) ^ s)
    cols = torch.tensor([((d + 1) * 0x9E3779B1) & _M32 for d in range(dim)],
                        dtype=torch.int64, device=ids.device)
    h = _mix32(base[:, None] ^ cols[None, :])
    # 24 random bits -> a float32 in [0, 1) exactly.
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    span = torch.tensor(high - low, dtype=torch.float32, device=ids.device)
    return (u * span + torch.tensor(low, dtype=torch.float32,
                                    device=ids.device)).to(dtype)


def counter_bits(seed: int, counters: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64 in ``[0, 2**32)``) for each of ``counters``
    (int64 in ``[0, 2**32)``) under ``seed``; the same bits on every device.
    Both halves of the seed's 64-bit fold key the hash, so two seeds give
    unrelated streams over the same counters."""
    s = fold_seed(seed, 0)
    return _mix32(_mix32(counters ^ (s & _M32)) ^ ((s >> 31) & _M32))


def uniform_by_counter(seed: int, counters: torch.Tensor) -> torch.Tensor:
    """Float32 in ``[0, 1)``, 24 random bits each, one per counter."""
    return ((counter_bits(seed, counters) >> 8).to(torch.float32)
            * (1.0 / (1 << 24)))


def randint_by_counter(seed: int, counters: torch.Tensor, low: int,
                       high: int) -> torch.Tensor:
    """Int64 in ``[low, high)``, one per counter: the high bits of
    ``bits * (high - low)`` (exact in int64 for ``high - low < 2**31``)."""
    span = high - low
    if not 0 < span < 1 << 31:
        raise ValueError(f"randint_by_counter: empty or too wide range "
                         f"[{low}, {high})")
    return low + ((counter_bits(seed, counters) * span) >> 32)
