"""The port's planner and staleness command lines against ``tools/plan.py``
and ``tools/staleness_sweep.py``.

* ``fps_tpu_torch/examples/plan.py --no-lower --json`` prints what the
  reference prints, for two table sets, with torch and jax unimportable.
  With lowering on the CPU, ``untiered_baseline`` is the census of the
  probe program's record for the same specs on the reference's ``(2, 4)``
  mesh, and ``predicted`` is a plan's record whose hot tier brings the
  reconcile's exchanges.
* ``fps_tpu_torch/examples/staleness_sweep.py``: the grid rows ``(None,
  0)`` and ``(4, 4)`` give the reference's ``mf_run`` RMSE and
  ``logreg_run`` accuracy from the same initial tables, within float32
  rounding; run as a command with ``--rows``, word2vec's partner recovery
  is far above chance on both rows.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fps_tpu.core import driver as jdriver
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh

from fps_tpu_torch import analysis as tanalysis
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax
from fps_tpu_torch.core import driver as tdriver
from fps_tpu_torch.core.store import TableSpec
from fps_tpu_torch.examples import plan as tplan
from fps_tpu_torch.examples import staleness_sweep as tstale
from fps_tpu_torch.parallel.mesh import make_ps_mesh
from fps_tpu_torch.tiering import lowered_plan_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN = os.path.join(ROOT, "fps_tpu_torch", "examples", "plan.py")
REF_PLAN = os.path.join(ROOT, "tools", "plan.py")

# Run a script by path with torch and jax unimportable.
_NO_TORCH = ("import runpy, sys; sys.modules['torch'] = None; "
             "sys.modules['jax'] = None; sys.argv = sys.argv[1:]; "
             "runpy.run_path(sys.argv[0], run_name='__main__')")

TABLE_SETS = {
    # ML-20M's two MF tables at rank 10: both fully replicated.
    "ml20m": ["--table", "item_factors:26744:10",
              "--table", "user_factors:138493:10"],
    # The reference's usage line, a 1 MB budget and measured-like skew:
    # partial heads with their cold lanes.
    "partial": ["--table", "item_factors:4096:16",
                "--table", "users:100000:16", "--alpha", "1.05",
                "--replica-budget-mb", "1", "--batch-rows", "512"],
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(path):
    spec = importlib.util.spec_from_file_location(
        "_ref_" + os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tables", sorted(TABLE_SETS))
def test_plan_no_lower_json_equals_the_reference(tables):
    argv = TABLE_SETS[tables] + ["--no-lower", "--json"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, REF_PLAN] + argv, env=env,
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    port = subprocess.run([sys.executable, "-c", _NO_TORCH, PLAN] + argv,
                          capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr
    assert port.stdout == ref.stdout
    out = json.loads(port.stdout)
    assert set(out) == {"plan", "hot_sync_every"}
    if tables == "partial":
        assert any(0 < p["hot_tier"] for p in out["plan"].values())


def _plan_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = tplan.main(argv)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _census(text):
    prof = tanalysis.collective_profile(text)
    return {"collectives": len(prof),
            "bytes": sum(c.payload_bytes for c in prof)}


@pytest.mark.parametrize("tables", sorted(TABLE_SETS))
def test_plan_lowered_on_the_cpu_is_the_records_census(tables):
    out = _plan_main(TABLE_SETS[tables] + ["--json", "--device", "cpu"])
    assert set(out) == {"plan", "hot_sync_every", "predicted",
                        "untiered_baseline", "mesh"}
    assert out["mesh"] == {"data": 2, "shard": 4}
    mesh = make_ps_mesh(num_shards=4, num_data=2, device="cpu")
    args = tplan._build_parser().parse_args(TABLE_SETS[tables])
    specs = {n: TableSpec(n, r, d) for n, r, d in args.table}
    base = lowered_plan_text(mesh, specs, {}, hot_sync_every=1)
    assert out["untiered_baseline"] == _census(base)
    assert out["untiered_baseline"]["collectives"] > 0
    # The plan's record: its hot tier's reconcile is there (the replica
    # consistency pass finds it), and the untiered record has none.
    planner = tplan._planner()
    plans = {n: planner.TierPlan(**p)
             for n, p in out["plan"].items()}
    text = lowered_plan_text(mesh, specs, plans,
                             hot_sync_every=out["hot_sync_every"])
    assert out["predicted"] == _census(text)
    needs = tanalysis.ProgramContract(require_shard_psum=True,
                                      shard_group_size=4,
                                      donated_tables=False)
    assert tanalysis.certify(text, needs).ok
    assert not tanalysis.certify(base, needs).ok


def test_plan_without_cuda_or_device_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        assert tplan.main(TABLE_SETS["ml20m"] + ["--json"]) == 2
    assert "CUDA is not available" in err.getvalue()


# ---------------------------------------------------------------------------
# The staleness sweep.
# ---------------------------------------------------------------------------

ROWS = {"sync": 0, "s4_d4": 3}


@pytest.fixture(scope="module")
def jstale():
    return _ref(os.path.join(ROOT, "tools", "staleness_sweep.py"))


@pytest.fixture(scope="module")
def data():
    return tstale.sweep_data()


@pytest.fixture
def jax_init(monkeypatch):
    """The port's trainers start from the tables and local state the JAX
    package's last ``init_state`` made (``jax.random`` and the port's
    counter hash draw different initial factors)."""
    made = []
    jinit = jdriver.Trainer.init_state

    def record(self, key):
        # Host copies: the JAX trainer donates its buffers to the run.
        tables, local = jinit(self, key)
        made.append(({k: np.asarray(v) for k, v in tables.items()},
                     local if isinstance(local, tuple)
                     else np.asarray(local)))
        return tables, local

    def from_jax(self, seed):
        jtb, jls = made[-1]
        tables = tables_from_jax(self.store, jtb)
        # Logistic regression keeps no local state: ``()`` in both.
        local = (jls if isinstance(jls, tuple) else local_state_from_jax(
            self.logic, jls, mesh=self.mesh))
        return tables, local

    monkeypatch.setattr(jdriver.Trainer, "init_state", record)
    monkeypatch.setattr(tdriver.Trainer, "init_state", from_jax)


@pytest.mark.parametrize("row", sorted(ROWS))
def test_staleness_rows_match_the_reference(jstale, data, jax_init, row,
                                            devices8):
    s, d, lrm, epm = tstale.GRID[ROWS[row]]
    assert (s, d, lrm, epm) == {"sync": (None, 0, 1.0, 1),
                                "s4_d4": (4, 4, 0.5, 2)}[row]
    (mf_train, mf_test), (lg_train, lg_test), _ = data
    jmesh = jmake_ps_mesh(num_shards=8, num_data=1)
    tmesh = make_ps_mesh(num_shards=8, device="cpu")
    kw = dict(s=s, d=d, lr=tstale.MF_LR0 * lrm, epochs=tstale.MF_EP0 * epm)
    want = jstale.mf_run(jmesh, mf_train, mf_test, tstale.NU, tstale.NI,
                         **kw)
    got = tstale.mf_run(tmesh, mf_train, mf_test, tstale.NU, tstale.NI,
                        **kw)
    # The same factors after each step but for float32 rounding (about
    # 1e-7 relative a step, tests/test_torch_mf.py): RMSE within 1e-5.
    assert abs(got - want) <= 1e-5, (got, want)
    assert got < 0.42
    kw = dict(s=s, d=d, lr=tstale.LG_LR0 * lrm, epochs=tstale.LG_EP0 * epm)
    want = jstale.logreg_run(jmesh, lg_train, lg_test, tstale.NF, **kw)
    got = tstale.logreg_run(tmesh, lg_train, lg_test, tstale.NF, **kw)
    # Accuracy over 1,600 held-out examples: a weight that differs by
    # float32 rounding flips at most an example on the boundary.
    assert abs(got - want) <= 1 / 1600 + 1e-12, (got, want)
    assert got > 0.7


def test_staleness_cli_rows_and_w2v_quality():
    """``--rows 0,3`` on the CPU through the command: the reference's row
    lines and table, and w2v's partner recovery@5 (chance 5 / (2 V2) =
    0.025) above ten times chance on both rows."""
    r = subprocess.run([sys.executable, "-m",
                        "fps_tpu_torch.examples.staleness_sweep", "--device",
                        "cpu", "--rows", "0,3"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    table = [ln for ln in r.stdout.splitlines() if ln.startswith("| ")]
    assert table[0] == ("| reads | push delay | lr scale | epochs scale | "
                        "MF test RMSE | logreg test acc | w2v partner-rec@5 |")
    rows = [ln.strip("| ").split(" | ") for ln in table[1:]]
    assert [row[:4] for row in rows] == [["sync", "0", "x1", "x1"],
                                        ["s=4", "4", "x0.5", "x2"]]
    chance = 5 / (2 * tstale.V2)
    for row in rows:
        assert float(row[4]) < 0.42 and float(row[5]) > 0.7
        assert float(row[6]) > 10 * chance, rows
    bad = subprocess.run([sys.executable, "-m",
                          "fps_tpu_torch.examples.staleness_sweep",
                          "--device", "cpu", "--rows", "8"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "--rows" in bad.stderr
