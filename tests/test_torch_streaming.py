"""The port's unbounded-stream MF example (``fps_tpu_torch.examples.
streaming_mf``) end to end on the CPU, and its source against the JAX
package's.

``streaming_rating_batches`` must give the JAX package's batches array for
array; the example must stop when the source dries up (``--max-records``)
and, on an unbounded source, as soon as a chunk's train RMSE falls below
``--target-rmse``.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch.examples import streaming_mf
from fps_tpu_torch.utils import datasets as tdatasets


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = streaming_mf.main(["--device", "cpu"] + argv)
    return rc, [json.loads(line) for line in buf.getvalue().splitlines()]


def test_source_equals_jax():
    kw = dict(rank=4, seed=3, batch=700, max_records=2500)
    got = list(tdatasets.streaming_rating_batches(50, 40, **kw))
    want = list(jdatasets.streaming_rating_batches(50, 40, **kw))
    assert [len(b["user"]) for b in got] == [700, 700, 700, 400]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("sync_every", [None, 4])
def test_stops_when_the_stream_dries_up(sync_every):
    argv = ["--max-records", "60000", "--local-batch", "1024",
            "--steps-per-chunk", "8", "--source-batch", "1000"]
    if sync_every:
        argv += ["--sync-every", str(sync_every)]
    rc, events = _run(argv)
    assert rc == 0
    chunks = [e for e in events if e["event"] == "chunk"]
    # 60,000 records in chunks of 8,192: seven full ones and a padded
    # eighth.
    assert len(chunks) == 8
    assert chunks[-1]["records_seen"] == 60000.0
    assert chunks[-1]["train_rmse"] < chunks[0]["train_rmse"]
    assert events[-1] == {"event": "done", "stopped_by": "stream_exhausted",
                          "records_seen": 60000.0}


def test_stops_on_the_target_rmse():
    rc, events = _run(["--max-records", "0", "--target-rmse", "0.32",
                       "--local-batch", "256", "--steps-per-chunk", "4"])
    assert rc == 0
    chunks = [e for e in events if e["event"] == "chunk"]
    assert chunks[-1]["train_rmse"] < 0.32
    assert all(c["train_rmse"] >= 0.32 for c in chunks[:-1])
    done = events[-1]
    assert done["event"] == "done" and done["stopped_by"] == "target_rmse"
    assert done["records_seen"] == chunks[-1]["records_seen"]


def test_unbounded_source_needs_a_target():
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        with pytest.raises(SystemExit):
            streaming_mf.main(["--device", "cpu", "--max-records", "0"])
