"""The port's source-hazard linter (fps_tpu_torch.analysis.lint) against
the JAX package's.

Every seeded source of ``tests/test_lint.py``, with its spelling
retargeted to the port (``jnp.any`` -> ``torch.any``, ``fps_tpu/`` ->
``fps_tpu_torch/``, ``jax.device_get`` -> ``.item()``, ``lax.scan`` ->
``torch.compile``, ...), gives the same rules on the same lines in the
port's linter as the original gives in the JAX package's. Then the port's
own spellings (the ``.any()`` / ``.all()`` and ``bool(...)`` forms of
FPS002, ``torch.load`` in FPS006, the sanctioned seams of FPS011), the
CI gate (``fps_tpu_torch/`` lints clean) and the command line with torch
and jax unimportable.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from fps_tpu.analysis import lint as jlint
from fps_tpu_torch.analysis import lint as tlint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = os.path.join(ROOT, "fps_tpu_torch", "examples", "lint.py")


def J(*parts):
    return os.path.join("fps_tpu", *parts)


def T(*parts):
    return os.path.join("fps_tpu_torch", *parts)


def _builder(body_src, trigger_ref="lax.scan(step, tables, None)",
             trigger_port="torch.compile(step)"):
    return body_src.replace("TRIGGER", trigger_ref), body_src.replace(
        "TRIGGER", trigger_port)


# (id, reference source, port source, reference path, port path): each
# source of tests/test_lint.py and its retargeted spelling.
CASES = [
    ("fps001_lambda", """
    def build(tables):
        fns = []
        for name in tables:
            fns.append(lambda: step(name))
        return fns
    """, None, None, None),
    ("fps001_default_bound", """
    def build(tables):
        fns = []
        for name in tables:
            fns.append(lambda _n=name: step(_n))
        return fns
    """, None, None, None),
    ("fps001_def_in_loop", """
    for epoch in range(3):
        def thunk():
            return source(epoch)
        run(thunk)
    """, None, None, None),
    ("fps001_rebound", """
    for i in range(3):
        def thunk():
            i = 0
            return i
    """, None, None, None),
    ("fps002_if_any", """
    def check(x):
        if jnp.any(jnp.isnan(x)):
            raise ValueError
    """, """
    def check(x):
        if torch.any(torch.isnan(x)):
            raise ValueError
    """, None, None),
    ("fps002_while_assert", """
    def run(x):
        while jnp.all(x > 0):
            x = step(x)
        assert jnp.isfinite(x)
    """, """
    def run(x):
        while torch.all(x > 0):
            x = step(x)
        assert torch.isfinite(x)
    """, None, None),
    ("fps002_np_clean", """
    def check(x):
        if np.any(np.isnan(x)):
            raise ValueError
    """, None, None, None),
    ("fps003_items_in_builder", *_builder("""
    def build_fn(tables):
        def step(carry, batch):
            out = {n: f(t) for n, t in tables.items()}
            return carry, out
        return TRIGGER
    """), None, None),
    ("fps003_sorted_clean", *_builder("""
    def build_fn(tables):
        def step(carry, batch):
            out = {n: f(t) for n, t in sorted(tables.items())}
            return carry, out
        return TRIGGER
    """), None, None),
    ("fps003_for_statement", *_builder("""
    def build_fn(tables):
        acc = []
        for n, t in tables.items():
            acc.append(t)
        return TRIGGER
    """, "lax.scan(make_step(acc), tables, None)",
        "torch.cuda.make_graphed_callables(make_step(acc), (tables,))"),
     None, None),
    ("fps003_outside_builder", """
    def summarize(metrics):
        return {k: sum(v) for k, v in metrics.items()}
    """, None, None, None),
    ("fps004_unsynchronized", """
    class Worker:
        def start(self):
            self.t = threading.Thread(target=self.run)
            self.t.start()
    """, None, None, None),
    ("fps004_lock", """
    class Worker:
        def __init__(self):
            self.lock = threading.Lock()
        def start(self):
            self.t = threading.Thread(target=self.run)
    """, None, None, None),
    ("fps004_docstring", '''
    class Worker:
        """Background dumper.

        thread-safety: the worker owns all state after start().
        """
        def start(self):
            self.t = threading.Thread(target=self.run)
    ''', None, None, None),
    ("fps005_from", "from fps_tpu.utils.profiling import trace",
     "from fps_tpu_torch.utils.profiling import trace", None, None),
    ("fps005_import", "import fps_tpu.utils.profiling",
     "import fps_tpu_torch.utils.profiling", None, None),
    ("fps005_from_pkg", "from fps_tpu.utils import profiling",
     "from fps_tpu_torch.utils import profiling", None, None),
    ("fps005_obs_clean", "from fps_tpu.obs import trace",
     "from fps_tpu_torch.obs import trace", None, None),
    ("fps005_shim_exempt", "import fps_tpu.utils.profiling",
     "import fps_tpu_torch.utils.profiling", J("utils", "profiling.py"),
     T("utils", "profiling.py")),
    ("fps006_np_load", "z = np.load(ckpt_path)", None, None, None),
    ("fps006_open", "f = open(snapshot_file, 'rb')", None, None, None),
    ("fps006_numpy_load", "z = numpy.load(run.ckpt_dir)", None, None, None),
    ("fps006_literal", "z = np.load('out/ckpt_000000000001.npz')", None,
     None, None),
    ("fps006_generic", "z = np.load(path)", None, None, None),
    ("fps006_write", "f = open(out_file, 'wb')", None, None, None),
    ("fps006_remove", "os.remove(ckpt_path)", None, None, None),
    ("fps006_reader_checkpoint", "z = np.load(snapshot_path)", None,
     J("core", "checkpoint.py"), T("core", "checkpoint.py")),
    ("fps006_reader_format", "z = np.load(snapshot_path)", None,
     J("core", "snapshot_format.py"), T("core", "snapshot_format.py")),
    ("fps006_reader_serve", "z = np.load(snapshot_path)", None,
     J("serve", "snapshot.py"), T("serve", "snapshot.py")),
    ("fps006_chaos", "z = np.load(snapshot_path)", None,
     J("testing", "chaos.py"), T("testing", "chaos.py")),
    ("fps007_clock_in_builder", *_builder("""
    import time

    def build():
        def step(c, x):
            t = time.perf_counter()
            return c, t
        return TRIGGER
    """, "lax.scan(step, 0, None)", "torch.compile(step)"), None, None),
    *[(f"fps007_{call.replace('.', '_').strip('()')}", *_builder(f"""
        from time import perf_counter
        import time

        def build():
            def step(c, x):
                return c, {call}
            return TRIGGER
        """, "lax.scan(step, 0, None)", "torch.cuda.graph(g)"), None, None)
      for call in ("time.time()", "time.monotonic()", "perf_counter()",
                   "time()")],
    ("fps007_outside_builder", """
    import time

    def phase():
        t0 = time.perf_counter()
        return time.perf_counter() - t0
    """, None, None, None),
    ("fps007_sleep_in_builder", *_builder("""
    import time

    def build():
        def step(c, x):
            return c, x
        time.sleep(0)
        return TRIGGER
    """, "lax.scan(step, 0, None)", "torch.compile(step)"), None, None),
    ("fps007_noqa", *_builder("""
    import time

    def build():
        t = time.time()  # noqa: FPS007
        return TRIGGER
    """, "lax.scan(lambda c, x: (c, x), 0, None)",
        "torch.compile(lambda c, x: (c, x))"), None, None),
    ("fps008_socket", "s = socket.socket()", None, None, None),
    ("fps008_create", "s = socket.create_connection((h, p))", None, None,
     None),
    ("fps008_bare", "from socket import create_connection\n"
     "s = create_connection((h, p))", None, None, None),
    ("fps008_wire", "s = socket.create_connection((h, p))", None,
     J("serve", "wire.py"), T("serve", "wire.py")),
    ("fps008_net", "s = socket.create_connection((h, p))", None,
     J("serve", "net.py"), T("serve", "net.py")),
    ("fps008_driver", "s = socket.create_connection((h, p))", None,
     J("core", "driver.py"), T("core", "driver.py")),
    ("fps008_constants", "fam = socket.AF_INET", None, None, None),
    ("fps008_hostname", "name = socket.gethostname()", None, None, None),
    ("fps008_noqa", "s = socket.socket()  # noqa: FPS008", None, None,
     None),
    ("fps009_join", 'p = os.path.join(root, "tenants", name, "ckpt")',
     None, None, None),
    ("fps009_open", 'f = open(d + "/tenants/a/tenant.json")', None, None,
     None),
    ("fps009_makedirs", 'os.makedirs(f"{root}/tenants/{n}/obs")', None,
     None, None),
    ("fps009_nested", 'hits = glob.glob(os.path.join(r, "tenants", "*"))',
     None, None, None),
    ("fps009_helper", 'p = os.path.join(root, "tenants", name)', None,
     J("tenancy", "paths.py"), T("tenancy", "paths.py")),
    ("fps009_fleet", 'p = os.path.join(root, "tenants", name)', None,
     J("obs", "fleet.py"), T("obs", "fleet.py")),
    ("fps009_constant", 'TENANTS_DIRNAME = "tenants"\n'
     "p = os.path.join(root, TENANTS_DIRNAME)", None, None, None),
    ("fps009_generic", 'p = os.path.join(root, "ckpt", name)', None, None,
     None),
    ("fps009_message", 'msg = "tenants must not collide"', None, None,
     None),
    ("fps009_noqa", 'p = os.path.join(r, "tenants")  # noqa: FPS009',
     None, None, None),
    ("fps010_asarray", 'q = np.asarray(snap.table("items"))', None,
     J("serve", "hot.py"), T("serve", "hot.py")),
    ("fps010_array", 'q = np.array(snap.tables["w"])', None,
     J("serve", "hot.py"), T("serve", "hot.py")),
    ("fps010_contiguous", 'q = np.ascontiguousarray(view.base)', None,
     J("serve", "hot.py"), T("serve", "hot.py")),
    ("fps010_copy", 'q = snap.tables["w"].copy()', None,
     J("serve", "hot.py"), T("serve", "hot.py")),
    ("fps010_alias", """
    t = snap.table(name)
    u = t
    dense = np.asarray(u)
    """, None, J("serve", "hot.py"), T("serve", "hot.py")),
    ("fps010_gather", """
    t = snap.table(name)
    rows = np.ascontiguousarray(t[ids])
    """, None, J("serve", "hot.py"), T("serve", "hot.py")),
    ("fps010_seams", """
    def materialize(table):
        return np.asarray(snap.table(name))

    class DeltaView:
        def __array__(self, dtype=None):
            return self.base.copy()
    """, None, J("serve", "hot.py"), T("serve", "hot.py")),
    ("fps010_outside_serve", 'q = np.asarray(snap.table("items"))', None,
     None, None),
    ("fps010_noqa", 'q = np.asarray(snap.table("i"))  # noqa: FPS010', None,
     J("serve", "hot.py"), T("serve", "hot.py")),
    ("noqa_exact", "from fps_tpu.utils.profiling import trace  # noqa: FPS005",
     "from fps_tpu_torch.utils.profiling import trace  # noqa: FPS005",
     None, None),
    ("noqa_other", "from fps_tpu.utils.profiling import trace  # noqa: FPS001",
     "from fps_tpu_torch.utils.profiling import trace  # noqa: FPS001",
     None, None),
    ("syntax_error", "def broken(:\n", None, None, None),
    *[(f"fps011_{tag}_{where}", ref, port, J("core", f), T("core", f))
      for where, f in (("driver", "driver.py"), ("megastep", "megastep.py"))
      for tag, ref, port in (
          ("sleep", "time.sleep(0.1)", None),
          ("fsync", "os.fsync(fd)", None),
          ("device_get", "x = jax.device_get(t)", "x = t.item()"),
          ("block", "out.block_until_ready()", "torch.cuda.synchronize()"))],
    ("fps011_bare_sleep", "sleep(0.1)", None, J("core", "driver.py"),
     T("core", "driver.py")),
    ("fps011_bare_fsync", "fsync(fd)", None, J("core", "driver.py"),
     T("core", "driver.py")),
    ("fps011_bare_block", "jax.block_until_ready(out)", "ev.synchronize()",
     J("core", "driver.py"), T("core", "driver.py")),
    *[(f"fps011_scope_{i}", "time.sleep(0.1)", None, J(*p), T(*p))
      for i, p in enumerate((("core", "checkpoint.py"), ("core", "autok.py"),
                             ("tiering", "retier.py")))],
    ("fps011_writer_seams", """
    def _writer_loop(self):
        time.sleep(backoff)
        os.fsync(fd)

    def _run_capture(collect):
        jax.device_get(collect())

    def _sidecar_retry_loop(self):
        time.sleep(d)
    """, """
    def _writer_loop(self):
        time.sleep(backoff)
        os.fsync(fd)

    def _run_capture(collect):
        collect().cpu()

    def _sidecar_retry_loop(self):
        time.sleep(d)
    """, J("core", "driver.py"), T("core", "driver.py")),
    ("fps011_non_seam", """
    def fit_stream(self):
        time.sleep(0.1)
    """, None, J("core", "driver.py"), T("core", "driver.py")),
    ("fps011_dispatch", """
    def _dispatch(self):
        out.block_until_ready()
    """, """
    def _dispatch(self):
        out.tolist()
    """, J("core", "driver.py"), T("core", "driver.py")),
    ("fps011_noqa", "time.sleep(0.1)  # noqa: FPS011", None,
     J("core", "driver.py"), T("core", "driver.py")),
    ("fps011_self_sleep", "self.sleep(0.1)", None, J("core", "driver.py"),
     T("core", "driver.py")),
    ("fps011_monotonic", "clock.monotonic()", None, J("core", "driver.py"),
     T("core", "driver.py")),
]


def _found(lint, src, path):
    src = textwrap.dedent(src)
    return [(f.rule, f.line) for f in (lint.lint_source(src, path)
                                       if path else lint.lint_source(src))]


@pytest.mark.parametrize("ref,port,ref_path,port_path",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_same_findings_as_the_reference(ref, port, ref_path, port_path):
    want = _found(jlint, ref, ref_path)
    got = _found(tlint, port if port is not None else ref,
                 port_path if port_path is not None else ref_path)
    assert got == want


def test_every_reference_rule_is_exercised_firing():
    fired = set()
    for _, ref, _, ref_path, _ in CASES:
        fired |= {r for r, _ in _found(jlint, ref, ref_path)}
    assert fired >= set(jlint.RULES)
    assert set(tlint.RULES) == set(jlint.RULES)


# -- the port's own spellings -------------------------------------------------

PORT_CASES = [
    ("method_all", "import torch\nif (a == b).all():\n    pass\n",
     None, [("FPS002", 2)]),
    ("method_any_while", "import torch\nwhile t.any():\n    t = f(t)\n",
     None, [("FPS002", 2)]),
    ("bool_call", "import torch\nx = bool(torch.any(t))\n", None,
     [("FPS002", 2)]),
    ("bool_in_if", "import torch\nif bool(torch.isfinite(t).all()):\n"
     "    pass\n", None, [("FPS002", 2)]),
    ("numpy_module", "import numpy as np\nif (a == b).all():\n    pass\n",
     None, []),
    ("numpy_rooted", "import torch\nif np.isfinite(v).all():\n    pass\n",
     None, []),
    ("torch_load", "z = torch.load(ckpt_path)", None, [("FPS006", 1)]),
    ("vote_seam", """
    def group_votes(trainer, tables):
        return [not b for b in bad[0].tolist()]
    """, T("core", "megastep.py"), []),
    ("as_numpy_seam", """
    def _to_host(metrics):
        return metrics.cpu().numpy()
    """, T("core", "driver.py"), []),
    ("capture_seam", """
    def save(self):
        def collect():
            ready.synchronize()
        return collect
    """, T("core", "driver.py"), []),
    ("cpu_off_seam", "x = t.cpu()", T("core", "driver.py"),
     [("FPS011", 1)]),
    ("cuda_sync", "torch.cuda.synchronize()", T("core", "megastep.py"),
     [("FPS011", 1)]),
]


@pytest.mark.parametrize("src,path,want", [c[1:] for c in PORT_CASES],
                         ids=[c[0] for c in PORT_CASES])
def test_port_spellings(src, path, want):
    assert _found(tlint, src, path) == want


def test_package_lints_clean():
    """The CI gate: zero findings over the whole fps_tpu_torch package."""
    findings = tlint.lint_paths([os.path.join(ROOT, "fps_tpu_torch")])
    assert findings == [], "\n".join(
        [""] + [f"{f}  [{tlint.RULES.get(f.rule, '?')}]" for f in findings])


def test_sanctioned_seams_each_cover_a_finding():
    """Every seam in FPS011's allow-set that the port's training files use
    covers a blocking call there: without the set, exactly those seams'
    calls are found."""
    files = [os.path.join(ROOT, T("core", "driver.py")),
             os.path.join(ROOT, T("core", "megastep.py"))]
    allow = set(tlint._FPS011_ALLOW_FUNCS)
    try:
        tlint._FPS011_ALLOW_FUNCS.clear()
        found = tlint.lint_paths(files, select={"FPS011"})
    finally:
        tlint._FPS011_ALLOW_FUNCS.update(allow)
    assert len(found) == 4
    assert {os.path.basename(f.path) for f in found} == {"driver.py",
                                                         "megastep.py"}


def _cli(args, tmp_path):
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['torch'] = None\n"
            f"sys.argv = ['lint.py'] + {args!r}\n"
            f"runpy.run_path({CLI!r}, run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(tmp_path))


def test_cli_json_exit_codes_and_explain(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import fps_tpu_torch.utils.profiling\n")
    r = _cli([str(tmp_path), "--json"], tmp_path)
    assert r.returncode == 1, r.stderr
    doc = json.loads(r.stdout)
    assert doc["count"] == 1 and doc["findings"][0]["rule"] == "FPS005"
    r = _cli([str(tmp_path), "--select", "FPS002"], tmp_path)
    assert r.returncode == 0, r.stderr
    bad.write_text("x = 1\n")
    assert _cli([str(tmp_path)], tmp_path).returncode == 0
    r = _cli(["--explain"], tmp_path)
    assert r.returncode == 0
    for rule in tlint.RULES:
        assert rule in r.stdout
    r = _cli([], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
