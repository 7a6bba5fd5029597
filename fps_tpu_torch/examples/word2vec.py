"""word2vec SGNS on the PyTorch port (text8-style token stream).

Port of ``fps_tpu/examples/word2vec.py`` with the flags the port supports:
any mesh (``--num-shards`` / ``--num-data``; every position a worker with a
block of its own each step), sync or SSP, ``--ingest device`` (the token stream resident on
the device, batches built there by ``Word2VecDevicePlan``, trained through
``run_indexed``; ``--mode block`` by default, or ``pairs``) or ``--ingest
host`` (pair chunks built in numpy by ``skipgram_chunks`` and copied over,
through ``fit_stream``; pairs only). Prints one JSON line per event:
``start``, a ``chunk`` per epoch (device) or chunk (host) with the SGNS loss
a pair, ``done`` with words/s and pairs/s, with ``--sketch-words P`` the
``cooccurrence_similarity`` of the P most frequent words (a tug-of-war
sketch riding the training loop as a step tap, on both workers), then the
nearest neighbours of a few frequent words.

    python -m fps_tpu_torch.examples.word2vec --local-batch 81920
    python -m fps_tpu_torch.examples.word2vec --device cpu --num-tokens 200000 --dim 32
    python -m fps_tpu_torch.examples.word2vec --device cpu --num-shards 4 --num-tokens 200000 --dim 32 --local-batch 20480

``--local-batch`` is the pairs a worker a step: the device plan's block is
``local_batch / (2 * window)`` tokens (81,920 pairs: blocks of 8,192).
"""

from __future__ import annotations

import time

import numpy as np

from fps_tpu_torch.examples.common import (
    apply_host_pipeline,
    base_parser,
    emit,
    make_mesh,
    profiler,
)


def main(argv=None) -> int:
    ap = base_parser("word2vec SGNS on the PyTorch parameter server")
    ap.add_argument("--input", default=None,
                    help="text8 file (default: a synthetic Zipfian stream)")
    ap.add_argument("--vocab-size", type=int, default=50_000)
    ap.add_argument("--num-tokens", type=int, default=None,
                    help="truncate the corpus to this many tokens; sizes "
                         "the synthetic stream when no --input is given "
                         "(default: whole file / 2M synthetic)")
    ap.add_argument("--dim", type=int, default=100)
    ap.add_argument("--window", type=int, default=5)
    ap.add_argument("--negatives", type=int, default=5)
    ap.add_argument("--learning-rate", type=float, default=0.025)
    ap.add_argument("--mode", default=None, choices=["block", "pairs"],
                    help="the worker: 'block' (one row a block position; "
                         "device ingest only, its default) or 'pairs' (the "
                         "host ingest's)")
    ap.add_argument("--sketch-words", type=int, default=0,
                    help="track the P most frequent words' co-occurrence "
                         "similarity with a tug-of-war sketch riding the "
                         "training loop (both workers; 0 = off)")
    args = ap.parse_args(argv)
    mode = args.mode or ("block" if args.ingest == "device" else "pairs")
    if args.ingest == "host" and mode == "block":
        ap.error("--mode block needs --ingest device (the block worker "
                 "reads the device plan's raw blocks)")

    from fps_tpu_torch.models.word2vec import (
        W2VConfig,
        Word2VecDevicePlan,
        accumulate_sketch_taps,
        cooccurrence_sketch_tap,
        nearest_neighbors,
        sketch_similarity,
        skipgram_chunks,
        word2vec,
        word2vec_block,
    )
    from fps_tpu_torch.parallel.mesh import num_workers_of
    from fps_tpu_torch.utils.datasets import load_text8

    tokens, vocab, uni = load_text8(args.input, args.vocab_size,
                                    args.num_tokens, seed=args.seed)
    mesh = make_mesh(args)
    W = num_workers_of(mesh)
    emit({"event": "start", "workload": "word2vec", "mode": mode,
          "ingest": args.ingest, "vocab_size": vocab, "tokens": len(tokens),
          "mesh": dict(mesh.shape), "device": str(mesh.device)})

    cfg = W2VConfig(vocab_size=vocab, dim=args.dim, window=args.window,
                    negatives=args.negatives,
                    learning_rate=args.learning_rate)
    sketch_probe = step_tap = None
    if args.sketch_words > 0:
        from fps_tpu_torch.sketch import TugOfWarSpec

        sketch_probe = np.argsort(-uni)[:args.sketch_words].astype(np.int32)
        step_tap = cooccurrence_sketch_tap(
            TugOfWarSpec(depth=5, width=1024, seed=args.seed), sketch_probe)
    block_len = max(64, args.local_batch // (2 * cfg.window))
    if mode == "block":
        trainer, store = word2vec_block(mesh, cfg, uni, block_len,
                                        sync_every=args.sync_every,
                                        max_steps_per_call=256,
                                        step_tap=step_tap)
    else:
        trainer, store = word2vec(mesh, cfg, uni, sync_every=args.sync_every,
                                  max_steps_per_call=256, step_tap=step_tap)
    apply_host_pipeline(args, trainer)
    tables, local_state = trainer.init_state(args.seed)

    prof, prof_step = profiler(args, mesh.device)
    total_pairs = 0.0
    sketch_sum = None
    t0 = time.perf_counter()

    def report(i, m):
        nonlocal total_pairs, sketch_sum
        n = max(1.0, float(np.sum(m["n"])))
        total_pairs += n
        if "tap" in m:
            part = accumulate_sketch_taps([m])
            sketch_sum = part if sketch_sum is None else sketch_sum + part
        dt = max(time.perf_counter() - t0, 1e-9)
        emit({"event": "chunk", "i": i, "sgns_loss": float(np.sum(m["loss"]))
              / n, "pairs": n, "pairs_per_sec": total_pairs / dt,
              "seconds": dt})
        prof_step()

    with prof:
        if args.ingest == "device":
            # Tokens resident on the device; subsampling, compaction and
            # pair generation there, each epoch in calls of 256 steps.
            plan = Word2VecDevicePlan(
                tokens, uni, cfg, mesh, num_workers=W, block_len=block_len,
                seed=args.seed, sync_every=args.sync_every, mode=mode)
            tables, local_state, _ = trainer.run_indexed(
                tables, local_state, plan, args.seed, epochs=args.epochs,
                on_epoch=report)
        else:
            def all_epochs():
                for epoch in range(args.epochs):
                    yield from skipgram_chunks(
                        tokens, uni, cfg, num_workers=W,
                        local_batch=args.local_batch,
                        steps_per_chunk=args.steps_per_chunk,
                        sync_every=args.sync_every, seed=args.seed + epoch)

            tables, local_state, _ = trainer.fit_stream(
                tables, local_state, all_epochs(), args.seed,
                on_chunk=report)
    dt = time.perf_counter() - t0
    emit({"event": "done", "pairs_per_sec": total_pairs / max(dt, 1e-9),
          "words_per_sec": args.epochs * len(tokens) / max(dt, 1e-9),
          "seconds": dt})

    if sketch_sum is not None:
        emit({"event": "cooccurrence_similarity",
              "probe_words": sketch_probe.tolist(),
              "inner_products": np.round(sketch_similarity(sketch_sum),
                                         1).tolist()})

    # Qualitative: neighbours of a few frequent words (ids 1..4; 0 may be
    # UNK).
    probes = np.arange(1, 5)
    nn_ids, nn_sims = nearest_neighbors(store, probes, k=5)
    for p, row_i, row_s in zip(probes, nn_ids, nn_sims):
        emit({"event": "neighbors", "word": int(p),
              "nearest": row_i.tolist(),
              "sims": np.round(row_s, 3).tolist()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
