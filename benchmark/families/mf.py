"""Online matrix factorization: the ratings, the weights, the program's job
and its reference.

The ratings follow a planted low-rank model (``assumed`` in the
configuration's file): uniform users, Zipf item popularity with the most
popular item at id 0, ratings ``<p_u, q_i>`` plus Gaussian noise. They are
drawn on the device with a ``torch.Generator`` from the seed, then handed to
the program's ``DeviceDataset`` (which takes host columns) and kept on the
device for the reference.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import mf as ref
from benchmark.reference.rng import fold_seed


def make_data(cfg, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, 11))
    U, I, N, k = (cfg["num_users"], cfg["num_items"], cfg["num_ratings"],
                  cfg["assumed"]["planted_rank"])
    a = cfg["assumed"]
    p = torch.randn((U, k), generator=gen, device=device) / math.sqrt(k)
    q = torch.randn((I, k), generator=gen, device=device) / math.sqrt(k)
    users = torch.randint(0, U, (N,), generator=gen, device=device)
    pop = torch.arange(1, I + 1, dtype=torch.float64,
                       device=device) ** -a["item_zipf"]
    cdf = torch.cumsum(pop, 0) / pop.sum()
    draw = torch.rand(N, generator=gen, device=device, dtype=torch.float64)
    items = torch.clamp(torch.searchsorted(cdf, draw, right=True), max=I - 1)
    noise = torch.randn(N, generator=gen, device=device) * a["noise"]
    ratings = (p[users] * q[items]).sum(-1) + noise
    return {"user": users.to(torch.int32), "item": items.to(torch.int32),
            "rating": ratings.to(torch.float32)}


def make_weights(cfg, seed: int, device) -> dict:
    """The initial user and item tables, uniform in ``[init_min,
    init_max)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, 12))
    lo, hi = cfg["init_min"], cfg["init_max"]
    return {name: torch.rand((rows, cfg["rank"]), generator=gen,
                             device=device) * (hi - lo) + lo
            for name, rows in (("user", cfg["num_users"]),
                               ("item", cfg["num_items"]))}


class Job:
    """The program's trainer, plan and state for one cell."""

    def __init__(self, cfg, cell, data, seed: int, device):
        import fps_tpu_torch as fps

        mesh = fps.make_ps_mesh(device=device)
        mcfg = fps.MFConfig(
            num_users=cfg["num_users"], num_items=cfg["num_items"],
            rank=cfg["rank"], learning_rate=cfg["learning_rate"],
            reg=cfg["reg"], init_min=cfg["init_min"],
            init_max=cfg["init_max"], hot_items=cell.get("hot_items", 0))
        self.trainer, _ = fps.online_mf(
            mesh, mcfg, combine=cfg["combine"],
            max_steps_per_call=cell.get("max_steps_per_call"))
        host = {k: v.cpu().numpy() for k, v in data.items()}
        dataset = fps.DeviceDataset(mesh, host)
        self.plan = fps.DeviceEpochPlan(
            dataset, num_workers=1, local_batch=cell["local_batch"],
            route_key="user", seed=seed)
        self.tables, self.local_state = self.trainer.init_state(seed)
        self.examples_per_epoch = cfg["num_ratings"]

    def leaves(self) -> dict:
        return {"user": self.local_state[0],
                "item": self.tables["item_factors"][0]}

    @staticmethod
    def step_losses(metrics) -> list[float]:
        return [float(s) / max(float(n), 1.0)
                for m in metrics for s, n in zip(m["se"], m["n"])]

    @staticmethod
    def step_values(metrics) -> torch.Tensor:
        return torch.cat([m["se"] for m in metrics])


def reference(cfg, cell, data, seed: int, weights0: dict, step_seeds,
              precision: str = "fp32", fault: str | None = None) -> dict:
    return ref.follow(data, cfg, cell, weights0, seed, len(step_seeds),
                      precision, fault)


def work(cfg, cell, data, seed: int, epoch: int, step_seeds) -> dict:
    return ref.work(data, cfg, cell, seed, epoch, len(step_seeds))
