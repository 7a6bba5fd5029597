"""Seed folding and counter hashes, frozen for the reference.

These are the draws the program under test documents for its word2vec
path and its epoch plans: a splitmix64 fold of integer seeds, and a 32-bit
xorshift-multiply hash of ``(seed, counter)``. The reference needs the same
draws to know which tokens an epoch keeps, which half-windows it gives and
which negatives a step scores; it computes them here, from the seed alone.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


def splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def fold_seed(seed: int, data: int) -> int:
    """Seed of sub-stream ``data`` of ``seed``, in ``[0, 2**63)``."""
    return splitmix64((splitmix64(seed & M64) + data) & M64) >> 1


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_bits(seed: int, counters: torch.Tensor) -> torch.Tensor:
    """32 bits (int64 in ``[0, 2**32)``) for each int64 counter."""
    s = fold_seed(seed, 0)
    return _mix32(_mix32(counters ^ (s & M32)) ^ ((s >> 31) & M32))


def uniform_by_counter(seed: int, counters: torch.Tensor) -> torch.Tensor:
    """Float32 in ``[0, 1)`` with 24 random bits, one per counter."""
    return ((counter_bits(seed, counters) >> 8).to(torch.float32)
            * (1.0 / (1 << 24)))


def randint_by_counter(seed: int, counters: torch.Tensor, low: int,
                       high: int) -> torch.Tensor:
    """Int64 in ``[low, high)``: the high bits of ``bits * (high - low)``."""
    return low + ((counter_bits(seed, counters) * (high - low)) >> 32)


def epoch_offset_rng(tag: int, seed: int, epoch: int) -> np.random.Generator:
    """The host generator an epoch plan keys by ``(tag, seed, epoch)``."""
    return np.random.default_rng((tag, seed & M64, epoch))
