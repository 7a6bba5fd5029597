"""Both packages' serving planes behind one set of test names.

The ``tests/test_torch_serve*.py``, ``test_torch_wire.py`` and
``test_torch_shadow.py`` files import the port's names (``fps_tpu_torch.
serve``, ``fps_tpu_torch.core.snapshot_format``, ``fps_tpu_torch.testing.
faultnet`` ...), as the reference's tests import the JAX package's, and run
every case twice: once with those names, once with :func:`rebind` swapping
each of them for its JAX-package counterpart (same module path under
``fps_tpu``, same attribute name). Constants (strings, numbers, dicts) are
left alone; the cross-package tests hold them equal.
"""

from __future__ import annotations

import importlib
import types

PACKAGES = ("fps_tpu", "fps_tpu_torch")
PORT = "fps_tpu_torch."


def counterpart(obj):
    """The JAX package's object for a port module, class or function
    (``None`` for anything else)."""
    if isinstance(obj, types.ModuleType):
        name = obj.__name__
        if name.startswith(PORT):
            return importlib.import_module("fps_tpu." + name[len(PORT):])
        return None
    mod = getattr(obj, "__module__", None)
    qual = getattr(obj, "__qualname__", None)
    if not (isinstance(mod, str) and mod.startswith(PORT) and qual):
        return None
    if "." in qual:
        return None
    return getattr(importlib.import_module("fps_tpu." + mod[len(PORT):]),
                   qual)


def rebind(namespace: dict, pkg: str, monkeypatch) -> None:
    """Bind ``namespace``'s port names to ``pkg``'s (a no-op for the port
    itself); ``monkeypatch`` restores them after the test."""
    if pkg == "fps_tpu_torch":
        return
    assert pkg == "fps_tpu", pkg
    for name, obj in list(namespace.items()):
        other = counterpart(obj)
        if other is not None:
            monkeypatch.setitem(namespace, name, other)
