"""One run of one cell: set-up, the timed window, the traced stretch, the
reference and the result line.

Everything specific to a cell, a configuration or a metric is found by name:
``workloads/<cell>.json`` (the traffic's parameters, the limits of the
comparison), ``configs/<config>.json`` (the sizes, the family),
``families/<family>.py`` (data, weights, the program's job, the
reference) and ``metrics/<metric>.py`` (a reader a metric). Which metrics a
cell reports, and their units, come from ``BENCHMARK.json`` beside this
folder.

A run, on one device:

1. makes the data and the initial weights from the seed, builds the
   program's job through its public entry points and puts the weights in;
2. drives the job's ``Trainer.run_indexed`` through the first three steps of
   epoch 0 (stretches of the job's own plan, so the same call and feed as
   the window) and keeps the state after steps 1 and 3 on the host;
3. warms up with one whole epoch, then times epochs from epoch 1 until the
   first epoch boundary after ``seconds``, ending in a synchronise;
4. with ``trace``, profiles one ``run_indexed`` call over the first
   ``trace_steps`` steps of the next epoch;
5. reads the peak memory, frees the program, runs the plain reference over
   the same three steps and compares (:mod:`benchmark.checks`).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import tempfile
import time

import torch

from benchmark import checks
from benchmark import trace as trace_mod
from benchmark.reference.rng import fold_seed

HERE = os.path.dirname(os.path.abspath(__file__))
BENCHMARK_JSON = os.path.join(os.path.dirname(HERE), "BENCHMARK.json")

# The check's calls: (seed index, first step, steps). Each runs
# ``run_indexed`` over that stretch of epoch 0 with ``start_epoch`` = the seed
# index, so the two calls draw from different seeds.
CHECK_CALLS = ((0, 0, 1), (1, 1, 2))


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def load_cell(name: str) -> tuple[dict, dict]:
    """The cell's parameters and its configuration's, by the cell's name."""
    cell = load("workloads", name)
    cell["name"] = name
    return cell, load("configs", cell["config"])


def _module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of this folder, loaded from its file
    (a name may hold dots and dashes)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}." + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(name: str):
    """A configuration family's module: ``families/<name>.py``."""
    return _module("families", name)


def reader(metric: str):
    """A metric's reader: ``metrics/<metric>.py``."""
    return _module("metrics", metric)


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def step_seeds(seed: int, epoch_seed: int, steps: int) -> list[int]:
    """The seeds ``run_indexed`` hands the one worker's steps of its first
    call of epoch ``epoch_seed``."""
    worker = fold_seed(fold_seed(fold_seed(seed, epoch_seed), 0), 0)
    return [fold_seed(worker, i) for i in range(steps)]


def check_step_seeds(seed: int) -> list[int]:
    return [s for j, _, n in CHECK_CALLS for s in step_seeds(seed, j, n)]


class Stretch:
    """Steps ``[start, start + steps)`` of one epoch of ``plan`` as a plan
    of their own, over that epoch's ``args``: ``run_indexed`` then runs
    exactly those steps through the plan's own batches."""

    def __init__(self, plan, start: int, steps: int, args: dict):
        self.plan, self.start, self.args = plan, start, args
        self.steps_per_epoch = steps
        self.sync_every = plan.sync_every

    def epoch_args(self, epoch: int) -> dict:
        return self.args

    def call_batches(self, args: dict, start: int, steps: int) -> dict:
        return self.plan.call_batches(args, self.start + start, steps)


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: dict
    config: dict
    peaks: dict
    setup_s: float
    window: dict
    trace: dict | None = None
    work: dict | None = None
    notes: dict = dataclasses.field(default_factory=dict)

    def roofline(self, key: str, ranges) -> float | None:
        """``work[key]`` bytes over the device seconds launched inside
        ``ranges``, as a share of the peak bandwidth (%)."""
        if self.trace is None or self.work is None:
            return None
        t = sum(self.trace["by_range"].get(r, 0.0) for r in ranges)
        b = self.work.get(key, 0)
        if t <= 0 or b <= 0:
            return None
        return 100.0 * b / (self.peaks["hbm_bytes_per_s"] * t)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(leaves: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in leaves.items()}


def first_steps(fam, cfg: dict, cell: dict, seed: int, device):
    """Steps 1-2 of a run: data, weights and the program's job, then the
    first three steps of epoch 0 through ``run_indexed``. Returns ``(job,
    data, weights0, prog)``: the initial weights and the program's losses
    and states after steps 1 and 3 on the host."""
    data = fam.make_data(cfg, seed, device)
    weights0 = fam.make_weights(cfg, seed, device)
    job = fam.Job(cfg, cell, data, seed, device)
    with torch.no_grad():
        for k, v in job.leaves().items():
            v.copy_(weights0[k])
    args0 = job.plan.epoch_args(0)
    metrics, states = [], []
    for j, start, n in CHECK_CALLS:
        job.tables, job.local_state, m = job.trainer.run_indexed(
            job.tables, job.local_state, Stretch(job.plan, start, n, args0),
            seed, start_epoch=j, as_numpy=False)
        metrics += m
        states.append(_host(job.leaves()))
    prog = {"losses": job.step_losses(metrics), "states": states,
            "states_at": (1, 3)}
    return job, data, _host(weights0), prog


def run(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, bench: dict | None = None,
        log=lambda msg: None) -> tuple[dict, dict]:
    """One run; returns ``(result, checks)``: the result line's keys but
    ``checks``, and each compared number with its limit."""
    device = torch.device(device)
    if bench is None:
        with open(BENCHMARK_JSON) as f:
            bench = json.load(f)
    with open(os.path.join(HERE, "peaks.json")) as f:
        peaks = json.load(f)
    fam = family(cfg["family"])

    job, data, weights0, prog = first_steps(fam, cfg, cell, seed, device)
    log(f"built and checked: {time.perf_counter() - t_start:.3f} s")

    # 3. Warm-up (epoch 0 whole), then the window from epoch 1.
    job.tables, job.local_state, _ = job.trainer.run_indexed(
        job.tables, job.local_state, job.plan, seed, start_epoch=0,
        as_numpy=False)
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    log(f"set-up: {setup_s:.3f} s")
    epoch, values, marks = 1, [], [t0]
    while True:
        job.tables, job.local_state, m = job.trainer.run_indexed(
            job.tables, job.local_state, job.plan, seed, start_epoch=epoch,
            as_numpy=False)
        values.append(job.step_values(m))
        epoch += 1
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    # The host's seconds an epoch (enqueue, not synchronised).
    log("epochs (host s): " + " ".join(
        f"{b - a:.4f}" for a, b in zip(marks, marks[1:])))
    epochs = epoch - 1
    values = torch.cat(values)
    window = {"seconds": elapsed, "epochs": epochs,
              "steps": epochs * job.plan.steps_per_epoch,
              "examples": epochs * job.examples_per_epoch}
    failed = int((~torch.isfinite(values)).sum())
    log(f"window: {json.dumps(window)}")

    # 4. The traced stretch.
    summary, trace_seeds = None, None
    if trace:
        T = cell["trace_steps"]
        args = job.plan.epoch_args(epoch)
        _sync(device)
        summary = _traced(job, Stretch(job.plan, 0, T, args), seed, epoch,
                          device)
        trace_seeds = step_seeds(seed, epoch, T)
        del args

    # 5. Peak memory, then the reference once the program is gone.
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    seeds3 = check_step_seeds(seed)
    ref = fam.reference(cfg, cell, data, seed,
                        {k: v.to(device) for k, v in weights0.items()},
                        seeds3)
    values_cmp = checks.readings(prog, ref, weights0)
    limits = cell["limits"]
    correct = checks.judge(values_cmp, limits) and failed == 0
    work = (fam.work(cfg, cell, data, seed, epoch, trace_seeds)
            if trace else None)

    ctx = Context(cell=cell, config=cfg, peaks=peaks, setup_s=setup_s,
                  window=window, trace=summary, work=work)
    kind = "per_layer" if trace else "end_to_end"
    out_metrics = {}
    for entry in cell_metrics(bench, cell["name"], kind):
        value = reader(entry["name"]).read(ctx)
        if value is not None and math.isfinite(value):
            out_metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(values.numel()),
              "failed": failed, "metrics": out_metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops_top"],
                               "idle_gaps": summary["idle_gaps_top"]}
    if ctx.notes:
        result["notes"] = ctx.notes
    compared = {k: {"value": values_cmp[k], "limit": limits[k]}
                for k in checks.compared(limits)}
    return result, compared


def _traced(job, stretch: Stretch, seed: int, epoch: int, device) -> dict:
    """Profile one ``run_indexed`` call over ``stretch`` and summarise it;
    the trace is written under ``TMPDIR`` and removed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=acts) as prof:
            with record_function("bench.stretch"):
                with record_function("bench.call"):
                    job.tables, job.local_state, _ = (
                        job.trainer.run_indexed(
                            job.tables, job.local_state, stretch, seed,
                            start_epoch=epoch, as_numpy=False))
                with record_function("bench.sync"):
                    _sync(device)
        prof.export_chrome_trace(path)
        return trace_mod.summarize(trace_mod.load(path))
