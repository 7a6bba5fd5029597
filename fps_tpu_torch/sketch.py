"""Streaming sketches: count-min, decayed count-min, tug-of-war
(count-sketch) and Bloom filter.

Port of ``fps_tpu/sketch.py``. Every sketch is plain additive tensor state:
an update is a masked scatter-add, so a sketch can ride a training step
(word2vec's co-occurrence tap), and merging sketches of disjoint substreams
is a sum (Bloom: a saturating max).

* **Hashing** is the JAX package's multiply-shift on uint32 with a
  murmur3-style finalizer, with per-row constants drawn from the spec's
  seed. torch has no full uint32 arithmetic, so the port computes in int64
  on values in ``[0, 2^32)`` and keeps the low 32 bits of every product
  (:func:`_mul32`, split in 16-bit halves so no intermediate passes 2^49).
  Buckets and signs equal the JAX package's bit for bit, for every int32
  id, negative ones included (they wrap as ``astype(uint32)`` does).
* **Float updates** (:func:`cm_update`, :func:`tow_update`,
  :func:`tow_update_rows`) are one scatter-add of the flattened sketch as an
  ``(N, 1)`` table through :func:`fps_tpu_torch.ops.scatter_add_`: kernel
  K4 on the card, which sums in a fixed order (``index_add_`` on CUDA adds
  by atomics, in no fixed order). A Bloom filter's update is a max, which
  does not depend on order (``scatter_reduce_``).

Estimates (standard guarantees): count-min ``query >= true``, overestimate
at most ``2N/width`` with probability ``1 - 2^-depth``; tug-of-war inner
products unbiased, variance ``O(F2(a) F2(b) / width)``, the median over
``depth`` rows tightening the tail; Bloom has no false negatives.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from fps_tpu_torch import ops

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF
_PRIME = 2654435761  # Knuth's multiplicative constant


@functools.lru_cache(maxsize=None)
def _hash_constants(seed: int, depth: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    a = (rng.integers(1, 2**31, depth, dtype=np.int64) * 2 + 1).astype(
        np.uint32)
    b = rng.integers(0, 2**31, depth, dtype=np.int64).astype(np.uint32)
    return a, b


@functools.lru_cache(maxsize=None)
def _constants_on(seed: int, depth: int,
                  device: torch.device) -> tuple[Tensor, Tensor]:
    """The hash constants of ``(seed, depth)`` as int64 tensors on
    ``device``, made once a device."""
    a, b = _hash_constants(seed, depth)
    return (torch.from_numpy(a.astype(np.int64)).to(device),
            torch.from_numpy(b.astype(np.int64)).to(device))


def _mul32(x: Tensor, c) -> Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` and ``c`` (a tensor or an int) in
    ``[0, 2^32)``: the low and high 16 bits of ``x`` multiplied apart."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(h: Tensor) -> Tensor:
    """murmur3's 32-bit finalizer, on int64 values in ``[0, 2^32)``."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _hash(ids: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """``(depth, B)`` 32-bit hashes (int64) of int ids under the rows'
    constants; an id is taken as ``uint32`` (negative ids wrap)."""
    x = _mul32(ids.to(torch.int64) & _M32, _PRIME)[None, :]
    return _mix((_mul32(x, a[:, None]) + b[:, None]) & _M32)


def _bucket(ids: Tensor, a: Tensor, b: Tensor, width: int) -> Tensor:
    """``(depth, B)`` int32 bucket index per hash row."""
    return (_hash(ids, a, b) % width).to(torch.int32)


def _sign(ids: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """``(depth, B)`` float32 ±1 sign per hash row (the hash's top bit)."""
    return (1 - 2 * (_hash(ids, a, b) >> 31)).to(torch.float32)


def _median(x: Tensor, dim: int) -> Tensor:
    """``jnp.median`` along ``dim``: the middle value, or the mean of the
    two middle values (``(lo + hi) * 0.5``) for an even count."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = s.select(dim, (n - 1) // 2)
    hi = s.select(dim, n // 2)
    return (lo + hi) * 0.5


def _values(ids: Tensor, values: Tensor | None, live: Tensor) -> Tensor:
    """Float32 values of live items, 0.0 for the dropped ones."""
    v = (torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
         if values is None else values.to(torch.float32))
    return torch.where(live, v, torch.zeros((), dtype=torch.float32,
                                            device=ids.device))


def _scatter_flat(sketch: Tensor, flat: Tensor, vals: Tensor) -> Tensor:
    """A new sketch: ``sketch.reshape(-1)[flat] += vals`` by one
    scatter-add of the flattened copy as an ``(N, 1)`` table (K4 on the
    card)."""
    out = sketch.to(torch.float32).clone()
    ops.scatter_add_(out.view(-1, 1), flat.reshape(-1).to(torch.int32),
                     vals.reshape(-1, 1).contiguous())
    return out


# ---------------------------------------------------------------------------
# Count-min sketch (point frequency estimates, biased up).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CountMinSpec:
    depth: int = 4
    width: int = 1024
    seed: int = 0

    def constants(self, device=None) -> tuple[Tensor, Tensor]:
        return _constants_on(self.seed, self.depth, torch.device(
            device or "cpu"))


def cm_init(spec: CountMinSpec, device=None) -> Tensor:
    return torch.zeros((spec.depth, spec.width), dtype=torch.float32,
                       device=device)


def cm_update(spec: CountMinSpec, sketch: Tensor, ids: Tensor,
              values: Tensor | None = None) -> Tensor:
    """Add ``values`` (default 1.0) at ``ids``; ids < 0 are dropped."""
    a, b = spec.constants(ids.device)
    cols = _bucket(ids, a, b, spec.width)  # (depth, B)
    v = _values(ids, values, ids >= 0)
    rows = torch.arange(spec.depth, dtype=torch.int32,
                        device=ids.device)[:, None]
    flat = rows * spec.width + cols
    return _scatter_flat(sketch, flat, v[None, :].expand(cols.shape))


def cm_query(spec: CountMinSpec, sketch: Tensor, ids: Tensor) -> Tensor:
    """``(B,)`` frequency estimates: the min over the depth rows."""
    a, b = spec.constants(ids.device)
    cols = _bucket(ids, a, b, spec.width)
    vals = torch.gather(sketch, 1, cols.to(torch.int64))  # (depth, B)
    return vals.min(dim=0).values


# ---------------------------------------------------------------------------
# Decayed count-min (halve-on-schedule). The decayed state is a running
# fold of window sketches (plain cm_update accumulations): every
# ``half_every``-th fold first halves the whole state, then adds the new
# window. Deterministic (the schedule is a tick count), exact in float
# (halving is a power-of-two scale) and linear, so decay commutes with the
# sum that merges sketches.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecayedCountMinSpec:
    depth: int = 4
    width: int = 1024
    seed: int = 0
    half_every: int = 8

    def __post_init__(self):
        if self.half_every < 1:
            raise ValueError(
                f"half_every must be >= 1, got {self.half_every}")

    def cm(self) -> CountMinSpec:
        """The plain count-min spec with this spec's hashing: window
        sketches are built with it."""
        return CountMinSpec(self.depth, self.width, self.seed)


def dcm_init(spec: DecayedCountMinSpec):
    """A fresh decayed state, as a numpy array (the host tracker's)."""
    return np.zeros((spec.depth, spec.width), np.float32)


def dcm_fold(spec: DecayedCountMinSpec, state, window, tick: int):
    """Fold one window sketch into the decayed state at fold index ``tick``
    (0-based, monotone): halve first when the schedule says so, then add.
    Numpy in, numpy out, or tensors in, a tensor out."""
    if tick < 0:
        raise ValueError(f"tick must be >= 0, got {tick}")
    if tick > 0 and tick % spec.half_every == 0:
        state = state * 0.5
    return state + window


def dcm_fold_traced(spec: DecayedCountMinSpec, state: Tensor, window: Tensor,
                    tick: Tensor) -> Tensor:
    """:func:`dcm_fold` with ``tick`` a 0-d int tensor on the state's
    device (no host read): the halving becomes a ``where``. The same bits
    as the host fold."""
    halve = (tick > 0) & (tick % spec.half_every == 0)
    return torch.where(halve, state * 0.5, state) + window


def dcm_query(spec: DecayedCountMinSpec, state, ids: Tensor) -> Tensor:
    """``(B,)`` decayed frequency estimates (min over the depth rows)."""
    return cm_query(spec.cm(), torch.as_tensor(state, device=ids.device),
                    ids)


# ---------------------------------------------------------------------------
# Tug-of-war / count-sketch (unbiased inner products and frequencies).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TugOfWarSpec:
    depth: int = 5
    width: int = 1024
    seed: int = 0

    def constants(self, device=None) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        device = torch.device(device or "cpu")
        return (*_constants_on(self.seed * 2 + 1, self.depth, device),
                *_constants_on(self.seed * 2 + 2, self.depth, device))


def tow_init(spec: TugOfWarSpec, device=None) -> Tensor:
    return torch.zeros((spec.depth, spec.width), dtype=torch.float32,
                       device=device)


def tow_update(spec: TugOfWarSpec, sketch: Tensor, ids: Tensor,
               values: Tensor | None = None) -> Tensor:
    """Add ``values * sign(id)`` into each row's bucket; ids < 0 dropped."""
    a1, b1, a2, b2 = spec.constants(ids.device)
    cols = _bucket(ids, a1, b1, spec.width)
    signs = _sign(ids, a2, b2)
    v = _values(ids, values, ids >= 0)
    rows = torch.arange(spec.depth, dtype=torch.int32,
                        device=ids.device)[:, None]
    return _scatter_flat(sketch, rows * spec.width + cols,
                         signs * v[None, :])


def tow_rows_items(spec: TugOfWarSpec, num_rows: int, rows: Tensor,
                   ids: Tensor, values: Tensor | None = None
                   ) -> tuple[Tensor, Tensor]:
    """What :func:`tow_update_rows` scatters into a ``(num_rows, depth,
    width)`` stack: ``(flat, vals)``, each ``(depth, B)``, the flat int32
    index of each item's bucket in each hash row and its signed value."""
    a1, b1, a2, b2 = spec.constants(ids.device)
    cols = _bucket(ids, a1, b1, spec.width)  # (depth, B)
    signs = _sign(ids, a2, b2)  # (depth, B)
    v = _values(ids, values, (ids >= 0) & (rows >= 0))
    r = torch.clamp(rows, 0, num_rows - 1).to(torch.int32)
    d = torch.arange(spec.depth, dtype=torch.int32,
                     device=ids.device)[:, None]
    flat = (r[None, :] * spec.depth + d) * spec.width + cols  # (depth, B)
    return flat, signs * v[None, :]


def tow_update_rows(spec: TugOfWarSpec, stack: Tensor, rows: Tensor,
                    ids: Tensor, values: Tensor | None = None) -> Tensor:
    """Batched multi-sketch update: add each id's tug-of-war contribution
    into ``stack[rows[b]]`` of a ``(P, depth, width)`` stack in one
    scatter. Items with ``rows < 0`` or ``ids < 0`` are dropped (they add
    0.0 to the clamped row)."""
    return _scatter_flat(stack, *tow_rows_items(spec, stack.shape[0], rows,
                                                ids, values))


def tow_inner(s1: Tensor, s2: Tensor) -> Tensor:
    """Unbiased estimate of the inner product of the two sketched frequency
    vectors (the median over rows): the co-occurrence similarity."""
    return _median(torch.sum(s1 * s2, dim=1), 0)


def tow_query(spec: TugOfWarSpec, sketch: Tensor, ids: Tensor) -> Tensor:
    """``(B,)`` unbiased point-frequency estimates (median over rows)."""
    a1, b1, a2, b2 = spec.constants(ids.device)
    cols = _bucket(ids, a1, b1, spec.width)
    signs = _sign(ids, a2, b2)
    vals = torch.gather(sketch, 1, cols.to(torch.int64)) * signs
    return _median(vals, 0)


# ---------------------------------------------------------------------------
# Bloom filter (set membership, no false negatives).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BloomSpec:
    num_hashes: int = 4
    num_bits: int = 8192
    seed: int = 0

    def constants(self, device=None) -> tuple[Tensor, Tensor]:
        return _constants_on(self.seed + 17, self.num_hashes, torch.device(
            device or "cpu"))


def bloom_init(spec: BloomSpec, device=None) -> Tensor:
    return torch.zeros((spec.num_bits,), dtype=torch.uint8, device=device)


def bloom_add(spec: BloomSpec, bits: Tensor, ids: Tensor) -> Tensor:
    """Set the bits of ``ids``; ids < 0 are dropped (into a spare slot past
    the end, cut off after the max)."""
    a, b = spec.constants(ids.device)
    pos = _bucket(ids, a, b, spec.num_bits).to(torch.int64)  # (k, B)
    pos = torch.where((ids >= 0)[None, :], pos, spec.num_bits).reshape(-1)
    ext = torch.cat([bits, bits.new_zeros(1)])
    ext.scatter_reduce_(0, pos, torch.ones_like(pos, dtype=torch.uint8),
                        "amax")
    return ext[:spec.num_bits]


def bloom_contains(spec: BloomSpec, bits: Tensor, ids: Tensor) -> Tensor:
    """``(B,)`` bool: True may be a false positive; False is definite."""
    a, b = spec.constants(ids.device)
    pos = _bucket(ids, a, b, spec.num_bits).to(torch.int64)  # (k, B)
    return torch.all(bits[pos] > 0, dim=0)


def merge(*sketches: Tensor) -> Tensor:
    """Merge sketches built over disjoint substreams: a sum (count-min,
    tug-of-war), a saturating max for Bloom (uint8)."""
    out = sketches[0]
    for s in sketches[1:]:
        out = torch.maximum(out, s) if out.dtype == torch.uint8 else out + s
    return out
