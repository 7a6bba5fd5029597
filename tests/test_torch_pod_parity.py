"""The two packages' pod coordinators side by side, and their trace readers.

The reference's ``tools/supervise.py`` and the port's CLI
(``fps_tpu_torch/examples/supervise.py``), both in pod mode with torch and
jax unimportable, run the same stub pods (``tests/_torch_supervised_stub.py``
as every member's child): a clean run, a wedged member, a quarantine
broadcast, and an elastic eviction with re-admission. They must give equal
``pod`` sections of the member digests (times, ids and which host leads
aside), equal ``pod_state.json`` fields and equal sets of decision events
in ``journal-pod.jsonl``. Then the trace reader: ``tools/trace_export.py``
and the port's copy give equal spans, equal Chrome documents and equal
coordinated-restart trees over the same pod dir.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_pod import (
    clear_fault_at_world2,
    collect,
    launch,
    pod_events,
    read_json,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STUB = os.path.join(_ROOT, "tests", "_torch_supervised_stub.py")
_CLIS = {"ref": os.path.join(_ROOT, "tools", "supervise.py"),
         "port": os.path.join(_ROOT, "fps_tpu_torch", "examples",
                              "supervise.py")}
_TRACE = {"ref": os.path.join(_ROOT, "tools", "trace_export.py"),
          "port": os.path.join(_ROOT, "fps_tpu_torch", "examples",
                               "trace_export.py")}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Stub pods whose every decision the stub fixes: (pod flags, child args,
# whether the fault clears at world 2).
_PODS = {
    "clean": ((), ("--chunks", "6", "--chunk-s", "0.05"), False),
    "wedged": ((), ("--chunks", "6", "--chunk-s", "0.05", "--wedge-at",
                    "3", "--wedge-mode", "sigstop", "--misbehave-host",
                    "h1"), False),
    "quarantine": ((), ("--chunks", "8", "--chunk-s", "0.05", "--crash-at",
                        "5", "--misbehave-host", "h1"), False),
    "elastic": (("--elastic", "--evict-after", "2", "--rejoin-delay-s",
                 "0.5"), ("--chunks", "10", "--chunk-s", "0.15",
                          "--misbehave-host", "h2"), True),
}
# The leader's decisions (and the evidence it journals for them); lease
# churn is timing, not a decision.
_DECISIONS = ("pod_start", "pod_launch", "pod_restart", "member_failed",
              "fence_written", "pod_quarantine", "pod_quarantine_evicted",
              "member_evicted", "member_readmitted", "member_synced",
              "readmit_deferred", "pod_shutdown", "pod_give_up")


def _run_pod(name, pod_dir, scenario):
    flags, child, clears = _PODS[scenario]
    if clears:
        fixed = str(pod_dir) + ".fixed"
        child = child + ("--crash-until-file", fixed)
    procs = launch(pod_dir, *flags, child=child, cli=_CLIS[name],
                   stub=_STUB)
    saw_world2 = clear_fault_at_world2(pod_dir, fixed) if clears else None
    res = collect(procs)
    assert all(rc is not None and d is not None
               for rc, d, _ in res.values()), res
    state = read_json(os.path.join(str(pod_dir), "pod_state.json"))
    return {
        "rc": {h: rc for h, (rc, _, _) in res.items()},
        "digest": {h: {k: d[k] for k in ("success", "host", "action",
                                         "epoch", "pod")}
                   for h, (_, d, _) in res.items()},
        "leader_terms": sum(d["leader_terms"] for _, d, _ in res.values()),
        "state": {"epoch": state["epoch"],
                  "quarantined": state["quarantined"],
                  "restarts": state["restarts"],
                  "readmissions": state["readmissions"],
                  "evicted": state["evicted"],
                  "roster": len(state["roster"]),
                  "plan": len(state["plan"]),
                  "attempts": [{k: a[k] for k in ("epoch", "reason",
                                                  "failed", "world")}
                               for a in state["attempts"]]},
        "decisions": sorted({e["event"] for e in pod_events(pod_dir)
                             if e["event"] in _DECISIONS}),
        "saw_world2": saw_world2,
    }


@pytest.mark.parametrize("scenario", sorted(_PODS))
def test_port_pod_matches_the_reference_over_a_stub(tmp_path, scenario):
    ref = _run_pod("ref", tmp_path / "ref" / "pod", scenario)
    port = _run_pod("port", tmp_path / "port" / "pod", scenario)
    assert port == ref
    assert ref["leader_terms"] == 1
    assert all(d["success"] for d in ref["digest"].values())


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trace_readers_agree(pod_dir):
    """Both trace readers over ``pod_dir``: equal spans, Chrome documents
    and coordinated-restart trees. Returns the trees."""
    ref = _load(_TRACE["ref"], "_ref_trace_export")
    port = _load(_TRACE["port"], "_port_trace_export")
    spans = ref.collect_spans([str(pod_dir)])
    assert port.collect_spans([str(pod_dir)]) == spans
    assert port.export_chrome(spans) == ref.export_chrome(spans)
    trees = ref.coordinated_restart_trees(spans)
    assert port.coordinated_restart_trees(spans) == trees
    return trees


def test_trace_readers_agree_over_a_stub_pod(tmp_path):
    """A wedged member's pod dir (the pod journal and every member's
    supervisor journal): one restart tree whose attempt children, one a
    host, carry its epoch, read alike by both readers; the port's CLI
    writes the same file as the reference's."""
    pod_dir = tmp_path / "pod"
    _run_pod("port", pod_dir, "wedged")
    trees = trace_readers_agree(pod_dir)
    assert len(trees) == 1
    attempts = [c for c in trees[0]["children"] if c["cat"] == "attempt"]
    assert sorted(c["host"] for c in attempts) == ["h0", "h1", "h2"]
    assert all(c["attrs"]["pod_epoch"] == trees[0]["epoch"]
               for c in attempts)
    out = {}
    for name, path in _TRACE.items():
        target = tmp_path / f"{name}.json"
        r = subprocess.run([sys.executable, path, str(pod_dir), "-o",
                            str(target)], capture_output=True, text=True,
                           timeout=60, cwd=_ROOT)
        assert r.returncode == 0, r.stderr
        out[name] = (json.loads(target.read_text()), r.stdout)
    assert out["port"] == out["ref"]
