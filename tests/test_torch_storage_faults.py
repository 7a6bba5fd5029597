"""Storage faults against the port's checkpoints and sidecar
(``fps_tpu_torch.core.retry``, ``fps_tpu_torch.testing.faultfs``), with the
oracles of ``tests/test_storage_faults.py``.

Each package has its own injector: a schedule installed into the port's
seams leaves the JAX package's untouched and the other way round, and the
``FPS_TPU_FAULTFS`` variable loads the port's FaultFS in the port even in a
process that has loaded both. Under the same schedule (errno, delay, torn
rename, stale read) both packages' checkpointers end with the same files
and the same counts: a retried publish is the unfaulted bytes, a blackout
past the retry budget degrades (skips) on the async writer and resets a
delta chain to a full, a fatal errno surfaces once with the first error
kept, a stale or torn read never quarantines a valid snapshot, and the
sidecar's write degrades off the training thread.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from fps_tpu.core import checkpoint as jck
from fps_tpu.core import retry as jretry
from fps_tpu.models.logistic_regression import LogRegConfig as JLogRegConfig
from fps_tpu.models.logistic_regression import (
    logistic_regression as jlogistic_regression,
)
from fps_tpu.parallel import mesh as jmesh
from fps_tpu.testing import faultfs as jfaultfs

from fps_tpu_torch import LogRegConfig, logistic_regression, obs
from fps_tpu_torch.convert import tables_from_jax
from fps_tpu_torch.core import checkpoint as tck
from fps_tpu_torch.core import retry as tretry
from fps_tpu_torch.core import snapshot_format as tfmt
from fps_tpu_torch.obs import events as obs_events
from fps_tpu_torch.parallel import mesh as tmesh
from fps_tpu_torch.testing import faultfs as tfaultfs
from fps_tpu_torch.testing.faultfs import FaultRule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF = 32


@pytest.fixture(autouse=True)
def _clean_injectors():
    """Every test leaves both packages' injectors uninstalled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tfaultfs.uninstall()
    jfaultfs.uninstall()
    torch.set_num_threads(n)


def _stores(seed=0):
    """Logistic regression's store in both packages, the same weights."""
    jtr, jst = jlogistic_regression(
        jmesh.make_ps_mesh(num_shards=1, num_data=1,
                           devices=jax.devices()[:1]),
        JLogRegConfig(num_features=NF, learning_rate=0.5))
    jtr.init_state(jax.random.key(seed))
    ttr, tst = logistic_regression(tmesh.make_ps_mesh(1, 1, device="cpu"),
                                   LogRegConfig(num_features=NF,
                                                learning_rate=0.5))
    ttr.init_state(0)
    tst.tables = tables_from_jax(tst, {k: np.asarray(v)
                                       for k, v in jst.tables.items()})
    return jst, tst


def _files(d):
    out = {}
    for f in sorted(os.listdir(d)):
        if f.endswith(".npz"):
            with np.load(os.path.join(d, f)) as z:
                out[f] = {k: z[k] for k in z.files}
    return out


def _same_dirs(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for f in fa:
        assert sorted(fa[f]) == sorted(fb[f]), f
        for k in fa[f]:
            np.testing.assert_array_equal(fa[f][k], fb[f][k], f"{f}: {k}")


def test_the_two_packages_injectors_are_apart():
    """A schedule installed in one package's seams faults that package
    only; the env variable's name and the path classes are shared."""
    assert tfaultfs.FAULTFS_ENV == tretry.FAULTFS_ENV == jretry.FAULTFS_ENV
    fs = tfaultfs.install([FaultRule("snapshot", "write", "errno",
                                     errno_name="EIO", count=None)])
    assert tretry.get_injector() is fs and jretry.get_injector() is None
    with pytest.raises(OSError):
        tretry.fault_check("write", "/d/ckpt_000000000001.npz")
    assert jretry.fault_check("write", "/d/ckpt_000000000001.npz") is None
    tfaultfs.uninstall()
    jfs = jfaultfs.install([jfaultfs.FaultRule("snapshot", "write",
                                               "errno", count=None)])
    assert tretry.get_injector() is None and jretry.get_injector() is jfs
    for path in ("/d/ckpt_000000000001.npz", "/d/tiering-00000003.npz",
                 "/d/pod_fence.json", "/d/delta_000000000002_000000000001"
                 ".npz"):
        assert tretry.classify_path(path) == jretry.classify_path(path)


def test_env_schedule_loads_the_ports_faultfs(tmp_path):
    """A process that has loaded both packages and starts with
    ``FPS_TPU_FAULTFS`` set installs the port's FaultFS in the port's
    seams (and the JAX package's in its own)."""
    spec = json.dumps({"rules": [{"path_class": "snapshot", "op": "write",
                                  "fault": "errno", "count": None}]})
    code = ("import fps_tpu.testing.faultfs, fps_tpu.core.retry as j\n"
            "import fps_tpu_torch.testing.faultfs as tf\n"
            "import fps_tpu_torch.core.retry as t\n"
            "inj = t.get_injector()\n"
            "assert type(inj) is tf.FaultFS, type(inj)\n"
            "assert type(j.get_injector()).__module__ == "
            "'fps_tpu.testing.faultfs'\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, FPS_TPU_FAULTFS=spec,
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


@pytest.fixture
def journal():
    """A process-default recorder over a memory sink for the test: the
    trail and metrics as a run's journal gets them."""
    sink = obs.MemorySink()
    rec = obs.Recorder(sinks=[sink])
    with obs_events.default_recorder(rec):
        yield rec, sink


def _both(tmp_path, rules, save, *, async_=True, ck_kw=None):
    """Run ``save(checkpointer, store)`` in each package under the same
    schedule, each installed in its own package's seams."""
    jst, tst = _stores()
    out = {}
    for pkg, ck, faultfs, st in (("jax", jck, jfaultfs, jst),
                                 ("port", tck, tfaultfs, tst)):
        d = str(tmp_path / pkg)
        cls = ck.AsyncCheckpointer if async_ else ck.Checkpointer
        rule_cls = (jfaultfs.FaultRule if faultfs is jfaultfs
                    else FaultRule)
        faultfs.install([rule_cls(**r) for r in rules])
        c = cls(d, keep=10, **(ck_kw(ck) if ck_kw else {}))
        try:
            save(c, st, ck)
            c.flush()
        finally:
            faultfs.uninstall()
        out[pkg] = (d, c)
    return out


def test_a_retried_publish_is_the_unfaulted_bytes(tmp_path, journal):
    """EIO twice, then the publish lands: the same file as an unfaulted
    publish and as the JAX package's under the same schedule; nothing
    degraded."""
    runs = _both(tmp_path, [dict(path_class="snapshot", op="write",
                                 fault="errno", errno_name="EIO", count=2)],
                 lambda c, st, ck: c.save(1, st, None))
    _same_dirs(runs["jax"][0], runs["port"][0])
    clean = tck.Checkpointer(str(tmp_path / "clean"))
    clean.save(1, _stores()[1], None)
    _same_dirs(str(tmp_path / "clean"), runs["port"][0])
    assert runs["port"][1].degraded_publishes == 0
    assert journal[0].counter_value("storage.retries",
                                    plane="checkpoint") == 2


def test_a_blackout_degrades_and_a_delta_chain_resets_to_a_full(tmp_path,
                                                                 journal):
    """A write blackout past the retry budget: the async writer skips the
    publish (degraded, the backlog rises), the training side never sees an
    error, the next landed publish is a full (no delta chains from the
    skipped step) and drains the backlog, in both packages alike; a slow
    fsync only delays."""
    rules = [dict(path_class="snapshot", op="write", fault="errno",
                  errno_name="ENOSPC", start=1, count=4),
             dict(path_class="snapshot", op="fsync", fault="delay",
                  delay_s=0.05, count=None)]

    def save(c, st, ck):
        c.save(1, st, None)
        c.flush()
        ck.load_rows(st, "weights", np.arange(2),
                     np.ones((2, 1), np.float32))
        c.save(2, st, None)  # planned as a delta of 1; degrades
        c.flush()
        assert c.degraded_publishes == 1 and c._publish_backlog == 1
        ck.load_rows(st, "weights", np.arange(2, 4),
                     np.ones((2, 1), np.float32))
        c.save(3, st, None)

    runs = _both(tmp_path, rules, save,
                 ck_kw=lambda ck: dict(delta=ck.DeltaPolicy(full_every=10)))
    _same_dirs(runs["jax"][0], runs["port"][0])
    d, c = runs["port"]
    pubs = tfmt.publications(d)
    assert sorted(pubs) == [1, 3] and pubs[3].kind == "full"
    assert c._publish_backlog == 0
    rec, sink = journal
    assert rec.counter_value("storage.degraded_publishes") == 1
    assert [e["step"] for e in sink.events("checkpoint_backlog_drained")
            ] == [3]


def test_a_fatal_errno_surfaces_once_and_keeps_the_first_error(tmp_path):
    """EROFS (fatal) then EIO (retried): the caller's next save raises,
    from the EROFS, once; the writer goes on and lands the save after."""
    tfaultfs.install([
        FaultRule("snapshot", "write", "errno", errno_name="EROFS",
                  start=0, count=1),
        FaultRule("snapshot", "write", "errno", errno_name="EIO", start=1,
                  count=1)])
    _, st = _stores()
    c = tck.AsyncCheckpointer(str(tmp_path), keep=5)
    c.save(1, st, None)
    with c._cv:
        while c._queued is not None or c._writing:
            c._cv.wait(0.05)
    with pytest.raises(RuntimeError, match="background checkpoint") as e:
        c.save(2, st, None)
    assert e.value.__cause__.errno == errno.EROFS
    c.save(3, st, None)
    c.flush()
    assert c.steps() == [3]
    c.close()


@pytest.mark.parametrize("fault", ["stale", "torn"])
def test_a_stale_or_torn_read_never_quarantines_a_valid_snapshot(
        tmp_path, fault):
    """A stale read (pre-rename content) of the newest snapshot, or a torn
    rename of a later publish: the restore re-reads before it
    quarantines, so the valid newest snapshot is kept and read; the torn
    publish never lands, in both packages alike."""
    jst, tst = _stores()
    for pkg, ck, faultfs, st, rule_cls in (
            ("jax", jck, jfaultfs, jst, jfaultfs.FaultRule),
            ("port", tck, tfaultfs, tst, FaultRule)):
        d = str(tmp_path / pkg)
        c = ck.Checkpointer(d, keep=5)
        c.save(1, st, None)
        if fault == "stale":
            # The injector sees the replace of step 2 and serves its
            # pre-rename content (absent: a transient ENOENT) once.
            faultfs.install([rule_cls("snapshot", "read", "stale",
                                      count=1)])
            c.save(2, st, None)
            step = ck.Checkpointer(d).read_snapshot()[0]
            assert step == 2, pkg
        else:
            faultfs.install([rule_cls("snapshot", "replace", "torn",
                                      count=None)])
            with pytest.raises(OSError):
                ck.Checkpointer(d, retry=tretry.RetryPolicy(retries=0)
                                if ck is tck else jretry.RetryPolicy(
                                    retries=0)).save(2, st, None)
            faultfs.uninstall()
            step = ck.Checkpointer(d).read_snapshot()[0]
            assert step == 1, pkg
        faultfs.uninstall()
        assert not [f for f in os.listdir(d) if f.endswith(".corrupt")
                    and "000000000001" in f], pkg
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.listdir(tmp_path / "port"))


def test_the_sidecar_write_degrades_off_the_training_thread(tmp_path,
                                                            caplog, journal):
    """A sidecar write that fails through its retry budget is skipped (the
    sidecar is advisory), its backoff on the background retrier, never on
    the caller; once the storage recovers the next one lands, in the JAX
    package's format (its ``Retierer.restore`` reads it)."""
    from fps_tpu.tiering.retier import Retierer as JRetierer

    from fps_tpu_torch.tiering import Retierer

    rt = Retierer(state_dir=str(tmp_path / "sc"), keep=2)
    rt.tick = 1
    rt.hot_ids = {"t": np.arange(4, dtype=np.int64)}
    tfaultfs.install([FaultRule("sidecar", "write", "errno",
                                errno_name="EIO", count=8)])
    with caplog.at_level(logging.WARNING, logger="fps_tpu_torch.tiering"):
        t0 = time.perf_counter()
        rt._save_sidecar(3, {})
        inline_s = time.perf_counter() - t0
        rt.sidecar_flush(timeout=30.0)
    assert inline_s < 0.1
    assert "DEGRADED" in caplog.text
    assert journal[0].counter_value("storage.sidecar_skips") == 1
    assert not os.listdir(rt.state_dir)
    tfaultfs.uninstall()
    rt._save_sidecar(4, {"t": np.ones((2, 8), np.float32)})
    assert os.listdir(rt.state_dir) == ["tiering-00000004.npz"]
    jrt = JRetierer(state_dir=rt.state_dir)
    assert jrt.restore(4) and jrt.tick == 1
    np.testing.assert_array_equal(jrt.hot_ids["t"], np.arange(4))
    np.testing.assert_array_equal(jrt._restored_windows["t"],
                                  np.ones((2, 8), np.float32))
