"""Compat shim — the profiling helpers live in :mod:`fps_tpu_torch.obs`.

``trace`` and ``Throughput`` are :mod:`fps_tpu_torch.obs.timing`'s, beside
the phase timers, recorder and run journal; this module re-exports them, as
``fps_tpu/utils/profiling.py`` does for the JAX package.
"""

from __future__ import annotations

from fps_tpu_torch.obs.timing import Throughput, trace

__all__ = ["trace", "Throughput"]
