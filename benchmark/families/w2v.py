"""word2vec SGNS: the corpus, the weights, the program's job and its
reference.

The corpus follows the configuration's ``assumed`` model: Zipf unigrams
over the vocabulary, each of a few topics reweighting them by Gamma draws,
and a topic chain that may switch at every segment of fixed length. The
topics' weights are part of the model, drawn on the host from the
configuration's ``topic_seed``, so every seed trains the same vocabulary
distribution and about the same kept tokens an epoch; the stream (the
topic chain and the tokens) is drawn on the device from the run's seed with
a ``torch.Generator``. The program takes the stream and its unigram
counts as host arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import w2v as ref
from benchmark.reference.rng import fold_seed


def make_data(cfg, seed: int, device) -> dict:
    a = cfg["assumed"]
    V, N = cfg["vocab_size"], cfg["num_tokens"]
    topics, seg = a["topics"], a["segment_tokens"]
    rng = np.random.default_rng(a["topic_seed"])
    freq = 1.0 / np.arange(1, V + 1) ** a["unigram_zipf"]
    freq /= freq.sum()
    dist = freq * rng.gamma(a["topic_boost_shape"], 1.0, (topics, V))
    dist /= dist.sum(axis=1, keepdims=True)
    cdf = torch.from_numpy(np.cumsum(dist, axis=1)).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, 22))
    nseg = -(-N // seg)
    switch = torch.rand(nseg, generator=gen, device=device) < a["topic_switch"]
    fresh = torch.randint(0, topics, (nseg,), generator=gen, device=device)
    at = torch.arange(nseg, device=device)
    last = torch.cummax(torch.where(switch, at, -1), 0).values
    topic = torch.where(last >= 0, fresh[last.clamp(min=0)], 0)
    topic = topic.repeat_interleave(seg)[:N]
    draw = torch.rand(N, generator=gen, device=device, dtype=torch.float64)
    tokens = torch.empty(N, dtype=torch.int64, device=device)
    for k in range(topics):
        m = topic == k
        tokens[m] = torch.searchsorted(cdf[k], draw[m], right=True)
    tokens = torch.clamp(tokens, max=V - 1).to(torch.int32)
    counts = torch.bincount(tokens, minlength=V)
    return {"tokens": tokens, "tokens_host": tokens.cpu().numpy(),
            "counts_host": counts.cpu().numpy().astype(np.int64)}


def make_weights(cfg, seed: int, device) -> dict:
    """word2vec.c's start: IN uniform in ``[-0.5 / dim, 0.5 / dim)``, OUT
    zeros."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed, 23))
    V, D = cfg["vocab_size"], cfg["dim"]
    half = 0.5 / D
    return {"in": torch.rand((V, D), generator=gen, device=device)
            * (2 * half) - half,
            "out": torch.zeros((V, D), device=device)}


class Job:
    """The program's trainer, plan and state for one cell."""

    def __init__(self, cfg, cell, data, seed: int, device):
        import fps_tpu_torch as fps

        mesh = fps.make_ps_mesh(device=device)
        wcfg = fps.W2VConfig(
            vocab_size=cfg["vocab_size"], dim=cfg["dim"],
            window=cfg["window"], negatives=cfg["negatives"],
            learning_rate=cfg["learning_rate"],
            subsample_t=cfg["subsample_t"], neg_power=cfg["neg_power"],
            neg_group_size=cell.get("neg_group_size", 1))
        counts = data["counts_host"]
        cap = cell.get("max_steps_per_call")
        L = cell["block_len"]
        if cell["mode"] == "pairs":
            self.trainer, _ = fps.word2vec(
                mesh, wcfg, counts, max_steps_per_call=cap)
        else:
            self.trainer, _ = fps.word2vec_block(
                mesh, wcfg, counts, L, max_steps_per_call=cap)
        self.plan = fps.Word2VecDevicePlan(
            data["tokens_host"], counts, wcfg, mesh, num_workers=1,
            block_len=L, seed=seed, mode=cell["mode"])
        self.tables, self.local_state = self.trainer.init_state(seed)
        self.examples_per_epoch = cfg["num_tokens"]

    def leaves(self) -> dict:
        return {"in": self.tables["in_embeddings"][0],
                "out": self.tables["out_embeddings"][0]}

    @staticmethod
    def step_losses(metrics) -> list[float]:
        return [float(s) / max(float(n), 1.0)
                for m in metrics for s, n in zip(m["loss"], m["n"])]

    @staticmethod
    def step_values(metrics) -> torch.Tensor:
        return torch.cat([m["loss"] for m in metrics])


def _corpus(cfg, cell, data, seed: int) -> ref.Corpus:
    return ref.Corpus(data, cfg, cell, plan_seed=seed)


def reference(cfg, cell, data, seed: int, weights0: dict, step_seeds,
              precision: str = "fp32", fault: str | None = None) -> dict:
    return ref.follow(_corpus(cfg, cell, data, seed), weights0,
                      list(step_seeds), precision, fault)


def work(cfg, cell, data, seed: int, epoch: int, step_seeds) -> dict:
    return ref.work(_corpus(cfg, cell, data, seed), epoch, list(step_seeds))
