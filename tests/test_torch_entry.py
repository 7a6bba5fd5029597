"""The port's driver entry points (``fps_tpu_torch.entry``) against the JAX
package's (``__graft_entry__``), on the CPU.

Both sides start from the JAX package's state, carried across with
``fps_tpu_torch.convert``, and run the same numpy chunks. MF here draws no
random numbers, so the seeds (a key on one side, a host int on the other)
do not enter. Tables and user factors are O(0.1); the two frameworks part
by the order of float32 sums, so they are held within 1e-6, the bound of
``tests/test_torch_mf.py`` for these chunks. The JAX mesh is the test
process's 8 virtual CPU devices; the port's positions all lie on the CPU.
"""

import contextlib
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from fps_tpu.core import device_ingest as jdi
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.parallel import mesh as jmesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import entry as te
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax
from fps_tpu_torch.parallel import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6
MESHES = [(2, 4), (1, 8)]  # (data, shard)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(trainer, jtables, jlocal):
    """The JAX package's state as the port's blocks on ``trainer``'s mesh."""
    tables = tables_from_jax(trainer.store, {k: np.asarray(v)
                                             for k, v in jtables.items()})
    local = local_state_from_jax(trainer.logic, np.asarray(jlocal),
                                 mesh=trainer.mesh)
    return tables, local


def _close(tout, jout):
    """Metrics, tables and user factors of one call on both sides."""
    (tt, tl, tm), (jt, jl, jm) = tout, jout
    np.testing.assert_array_equal(tm["n"].numpy(), np.asarray(jm["n"]))
    np.testing.assert_allclose(tm["se"].numpy(), np.asarray(jm["se"]),
                               rtol=1e-5)
    assert set(tt) == set(jt)
    for name in tt:
        np.testing.assert_allclose(tt[name].numpy(), np.asarray(jt[name]),
                                   rtol=0, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


def test_entry_matches_the_reference_entry():
    """``entry(device="cpu")``'s chunk against ``__graft_entry__.entry()``'s
    jitted chunk function: the same chunk, the same carried state."""
    jfn, (jt, jl, jb, jkey) = graft.entry()
    tfn, (tt, tl, tb, seed) = te.entry(device="cpu")
    assert isinstance(seed, int)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    tt, tl = _carried(tfn.__self__, jt, jl)
    _close(tfn(tt, tl, tb, seed), jfn(jt, jl, jb, jkey))


def test_entry_fn_twice_keeps_its_arguments_and_its_bits():
    """The harness may call ``fn`` again and again on the same arguments:
    they keep their values (``donate=False``), and the outputs repeat bit
    for bit."""
    fn, args = te.entry(device="cpu")
    tables, local, batches, seed = args
    before = ({k: v.numpy().copy() for k, v in tables.items()},
              local.numpy().copy(),
              {k: v.numpy().copy() for k, v in batches.items()})
    outs = [fn(*args) for _ in range(2)]
    for k, v in tables.items():
        np.testing.assert_array_equal(v.numpy(), before[0][k])
    np.testing.assert_array_equal(local.numpy(), before[1])
    for k, v in batches.items():
        np.testing.assert_array_equal(v.numpy(), before[2][k])
    (t0, l0, m0), (t1, l1, m1) = outs
    for k in t0:
        np.testing.assert_array_equal(t0[k].numpy(), t1[k].numpy())
        assert not np.array_equal(t0[k].numpy(), before[0][k])
    np.testing.assert_array_equal(l0.numpy(), l1.numpy())
    for k in m0:
        np.testing.assert_array_equal(m0[k].numpy(), m1[k].numpy())


@pytest.mark.parametrize("sync_every", [None, 2])
@pytest.mark.parametrize("D,S", MESHES)
def test_mf_chunk_of_build_matches_the_reference(D, S, sync_every):
    """``_build``'s job and chunk on a ``(D, S)`` mesh on both sides."""
    jm = jmesh.make_ps_mesh(num_shards=S, num_data=D,
                            devices=jax.devices()[:D * S])
    ttr, _, _, tchunk = te._build(tmesh.make_ps_mesh(S, D, device="cpu"),
                                  sync_every)
    jtr, jt, jl, jchunk = graft._build(jm, sync_every)
    assert sorted(tchunk) == sorted(jchunk)
    for k in jchunk:
        np.testing.assert_array_equal(tchunk[k], jchunk[k])
    tt, tl = _carried(ttr, jt, jl)
    _close(ttr.run_chunk(tt, tl, tchunk, 2),
           jtr.run_chunk(jt, jl, jchunk, jax.random.key(2)))


@pytest.mark.parametrize("sync_every", [None, 2])
@pytest.mark.parametrize("D,S", MESHES)
def test_mf_indexed_matches_the_reference(D, S, sync_every):
    """The dry run's device-resident MF (calls of 2 steps) on both sides:
    the epoch's metrics and state, and every example processed."""
    W = D * S
    jm = jmesh.make_ps_mesh(num_shards=S, num_data=D,
                            devices=jax.devices()[:W])
    jtr, _ = jonline_mf(jm, JMFConfig(num_users=64, num_items=48, rank=4),
                        sync_every=sync_every, max_steps_per_call=2)
    jt, jl = jtr.init_state(jax.random.key(0))
    jplan = jdi.DeviceEpochPlan(
        jdi.DeviceDataset(jm, jdatasets.synthetic_ratings(64, 48, 64 * W,
                                                          seed=0)),
        num_workers=W, local_batch=8, route_key="user",
        sync_every=sync_every)
    ttr, _, _, tplan = te._mf_indexed(tmesh.make_ps_mesh(S, D, device="cpu"),
                                      sync_every)
    tt, tl = _carried(ttr, jt, jl)
    tt, tl, tms = ttr.run_indexed(tt, tl, tplan, 3)
    jt, jl, jms = jtr.run_indexed(jt, jl, jplan, jax.random.key(3))
    assert float(np.sum(tms[0]["n"])) == 64 * W
    tm = {k: torch.from_numpy(np.asarray(v)) for k, v in tms[0].items()}
    _close((tt, tl, tm), (jt, jl, jms[0]))


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip_runs_every_family_on_the_cpu(n):
    """Every family over the ``default_mesh_shape(n)`` mesh, the summary
    line printed, the w2v push routed through K3 (counted by the program
    record on the CPU) and both hot tiers serving rows."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = te.dryrun_multichip(n, device="cpu")
    D, S = tmesh.default_mesh_shape(n)
    assert out["mesh"] == (D, S) == jmesh.default_mesh_shape(n)
    assert buf.getvalue().startswith(f"dryrun_multichip OK on {D}x{S} mesh: ")
    assert out["k3_calls"] > 0
    assert min(out["examples"].values()) > 0
    assert out["examples"]["mf_indexed_sync"] == 64 * n
    assert out["hot_rows"]["mf"] > 0 and out["hot_rows"]["w2v"] > 0
    assert "launches" not in out  # the plain versions launch nothing


def test_entry_points_need_a_device_without_cuda():
    """No CUDA and no device: the entry points raise and the module's
    command exits non-zero; with ``--device cpu`` it prints ``entry OK``."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.dryrun_multichip(4)
    bare = subprocess.run([sys.executable, "-m", "fps_tpu_torch.entry"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert bare.returncode != 0 and "entry OK" not in bare.stdout
    ok = subprocess.run([sys.executable, "-m", "fps_tpu_torch.entry",
                         "--device", "cpu"], cwd=ROOT, capture_output=True,
                        text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert ok.stdout.strip() == "entry OK"
