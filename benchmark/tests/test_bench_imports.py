"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark import harness

REPO = os.path.dirname(harness.HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "fps_tpu"}


def _modules(prefix: str, skip=("tests",)) -> list[str]:
    out = []
    base = os.path.join(REPO, *prefix.split("."))
    for root, dirs, files in os.walk(base):
        dirs[:] = [d for d in dirs if d not in skip and d != "__pycache__"]
        rel = os.path.relpath(root, REPO).replace(os.sep, ".")
        for f in files:
            if f.endswith(".py"):
                name = f[:-3]
                out.append(rel if name == "__init__" else f"{rel}.{name}")
    return sorted(out)


def _loaded_top_levels(modules: list[str], extra: str = "") -> set[str]:
    """Top-level names of ``sys.modules`` after importing ``modules`` (by
    file, so that names with dots load) in a fresh interpreter."""
    code = (
        "import importlib.util, json, os, sys\n"
        f"for m in {modules!r}:\n"
        "    path = os.path.join(*m.split('.')) + '.py'\n"
        "    if not os.path.exists(path):\n"
        "        path = os.path.join(*m.split('.'), '__init__.py')\n"
        "    spec = importlib.util.spec_from_file_location(m, path)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    sys.modules[m] = mod\n"
        "    spec.loader.exec_module(mod)\n"
        f"{extra}"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    mods = _modules("benchmark")
    assert "benchmark.run" in mods and "benchmark.families.mf" in mods
    # The families build the program's jobs: load the program too.
    loaded = _loaded_top_levels(mods, "import fps_tpu_torch\n")
    assert "fps_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("benchmark.reference")
    assert "benchmark.reference.w2v" in mods
    loaded = _loaded_top_levels(mods)
    assert not {"fps_tpu_torch", "fps_tpu", "jax"} & loaded
    for m in mods:
        path = os.path.join(REPO, *m.split(".")) + ".py"
        if os.path.exists(path):
            with open(path) as f:
                assert "fps_tpu" not in f.read(), path
