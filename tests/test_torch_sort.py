"""K2's sort on the CPU: ``radix_sort_plain`` against numpy's stable
argsort, the pass-count helper at the bit boundaries, and the wrapper's
scratch sizes against the CUDA sources.

K2 (``scatter_add_cuda_``) sorts each push's keys (the id for an id in
``[0, R)``, ``R`` for a dropped id) stably with their batch positions,
in a hand-written radix sort on the card (``csrc/radix_sort.cu``).
``radix_sort_plain`` is its plain version: the card's sort is held to it bit
for bit in ``chip_smoke.py`` and ``tests/test_torch_cuda.py``. The JAX
package has no sort here (its scatter-add contracts a one-hot), so the
reference is numpy's ``argsort(kind="stable")`` on the same key mapping.
"""

import os
import re

import numpy as np
import pytest
import torch

from fps_tpu_torch.ops import _build, kernels

# (R, B, seed): the paths' tables (MF items and users, 20-class PA,
# AdaGrad logreg), R = 0 and 1, the radix boundaries, the largest R.
SORT_CASES = [(26_744, 3000, 0), (138_493, 3000, 1), (47_236, 5000, 2),
              (1_000_000, 4097, 3), (0, 50, 4), (1, 300, 5), (255, 1000, 6),
              (256, 1000, 7), (65_536, 2000, 8), (2**31 - 1, 2000, 9),
              (100, 1, 10), (100, 0, 11)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(R, B, seed):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, B) % max(R, 1)).astype(np.int64)
    if R > 2**20:
        ids = rng.integers(0, R, B)
    ids[::7] = -1
    ids[3::11] = R
    ids[5::13] = np.iinfo(np.int32).max
    ids[6::17] = np.iinfo(np.int32).min
    return ids.astype(np.int32)


def _numpy_sort(ids, R):
    keys = np.where((ids >= 0) & (ids < R), ids, R).astype(np.int64)
    order = np.argsort(keys, kind="stable")
    return keys[order], order


@pytest.mark.parametrize("R,B,seed", SORT_CASES)
def test_radix_sort_plain_matches_numpy_stable_argsort(R, B, seed):
    ids = _ids(R, B, seed)
    keys, perm = kernels.radix_sort_plain(torch.from_numpy(ids), R)
    want_keys, want_perm = _numpy_sort(ids, R)
    assert keys.dtype == torch.int32 and perm.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), want_keys)
    np.testing.assert_array_equal(perm.numpy(), want_perm)


def test_dropped_ids_sort_last_in_batch_order():
    R = 40
    ids = np.array([41, 3, -1, 39, 40, 3, 2**31 - 1, 0, -7], np.int32)
    keys, perm = kernels.radix_sort_plain(torch.from_numpy(ids), R)
    np.testing.assert_array_equal(keys.numpy(),
                                  [0, 3, 3, 39, R, R, R, R, R])
    # Equal keys keep their batch order: the two 3s, then every drop.
    np.testing.assert_array_equal(perm.numpy(), [7, 1, 5, 3, 0, 2, 4, 6, 8])


@pytest.mark.parametrize("R,passes", [(0, 1), (1, 1), (255, 1), (256, 2),
                                      (65_535, 2), (2**16, 3),
                                      (2**24 - 1, 3), (2**24, 4),
                                      (2**31 - 1, 4)])
def test_radix_sort_passes_at_the_bit_boundaries(R, passes):
    """Keys lie in ``[0, R]``: ``ceil(log2(R + 1))`` bits, at least one,
    8 a pass."""
    assert kernels.radix_sort_passes(R) == passes
    bits = max(1, int(np.ceil(np.log2(R + 1))))
    assert passes == -(-bits // 8)


def test_radix_sort_passes_of_the_paths():
    """2 passes for the MF items (15 bits) and 20-class PA (16), 3 for the
    MF users (18) and AdaGrad (20)."""
    assert [kernels.radix_sort_passes(R) for R in
            (26_744, 47_236, 138_493, 1_000_000)] == [2, 2, 3, 3]
    with pytest.raises(ValueError):
        kernels.radix_sort_passes(-1)


def _constant(src, name):
    with open(os.path.join(_build.CSRC, src)) as f:
        text = f.read()
    env = {}
    # Products of literals and earlier constants, as the tile sizes are.
    for n, expr in re.findall(r"constexpr int (\w+) = ([\w\s*]+);", text):
        value = 1
        for factor in expr.split("*"):
            factor = factor.strip()
            value *= env[factor] if factor in env else int(factor)
        env[n] = value
    return env[name]


def test_scratch_sizes_match_the_sources():
    """The wrapper sizes the sort's and the sum's scratch from the tile
    sizes of the CUDA sources; the C entry points refuse less."""
    assert kernels.SORT_MAX_TILE == _constant("radix_sort.cu", "kMaxTile")
    assert kernels.SORT_TARGET_TILES == _constant("radix_sort.cu",
                                                  "kTargetTiles")
    assert kernels.SORT_RADIX == _constant("radix_sort.cu", "kRadix")
    assert kernels.SUM_TILE == _constant("scatter_add.cu", "kTile")
    # At most 64 tiles up to 16 warps a tile; 4,096 positions a tile past.
    assert kernels._sort_words(4097) == 4 * 4097 + 256 * 64
    assert kernels._sort_words(1 << 20) == 4 * (1 << 20) + 256 * 256


def test_radix_sort_cuda_refuses_cpu_tensors():
    ids = torch.from_numpy(_ids(30, 20, 0))
    kernels.radix_sort_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.radix_sort_cuda(ids, 30)
    assert kernels.radix_sort_cuda.launches == 0
