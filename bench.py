"""Benchmark driver. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}}

Headline metric: connected-digit decode throughput in audio-seconds per
second per GPU — the workload of the reference's ``main.py`` (7-slot x
11-digit sausage over 5-state 4-mix GMM-HMMs, 39-dim features), from
features to word sequences (emission GEMM + graph Viterbi + backtrace +
device words-out), at batch 512 x 500 frames.

Extra diagnostics go to stderr; stdout carries exactly the JSON line.
Exits non-zero when JAX finds no GPU.  Run ``python bench.py --help``
for sub-benchmarks.
"""

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _bank(n_models=11, n_states=5, n_mix=4, dim=39, seed=0):
    import jax.numpy as jnp

    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    rng = np.random.default_rng(seed)
    ms = []
    for _ in range(n_models):
        p = random_gmm_hmm(rng, n_states=n_states, n_mix=n_mix, dim=dim, sep=3.0)
        ms.append(
            GMMHMM(
                means=jnp.asarray(p["means"], jnp.float32),
                log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
                log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
                trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
            )
        )
    return HMMBank.stack(ms)


def _timeit(fn, warmup=2, iters=5):
    """Wall seconds per call of ``fn``, each call fenced by
    ``jax.block_until_ready`` (includes the per-dispatch host cost; use
    :func:`_timeit_device` for steady-state device time)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / iters


#: timing regime of the last _timeit_device call: "slope" (clean
#: steady-state device time) or "upper-bound" (noise-dominated; the
#: number includes dispatch overhead and UNDERSELLS the kernel).  The
#: headline JSON carries this so a degraded artifact is self-labeling.
LAST_REGIME = "unmeasured"


def _timeit_device(body, n_lo=2, n_hi=12, reps=3, args=()):
    """Steady-state device time per iteration of ``body``.

    ``body(dep_scalar, *args) -> scalar`` must thread the dependence
    scalar into its inputs (e.g. ``nf = where(isnan(dep), nf + 1,
    nf)``) so iterations chain and can't be elided.  Runs ``n`` chained
    iterations inside ONE jit (lax.fori_loop) for two values of n; the
    slope removes both the per-dispatch host round trip and the fixed
    jit entry cost.

    Large device arrays should ride ``args`` (forwarded to ``body``),
    not the closure: closed-over arrays embed as HLO constants.

    Sets :data:`LAST_REGIME` to "slope" or "upper-bound"."""
    global LAST_REGIME
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(n, *xs):  # dynamic trip count: ONE compile serves every n
        def step(_, acc):
            return acc + body(acc, *xs) * jnp.float32(1e-30)
        return jax.lax.fori_loop(0, n, step, jnp.float32(0.0))

    jax.block_until_ready(run(jnp.int32(1), *args))  # compile + warm

    def t(n):
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(run(jnp.int32(n), *args))
        return (time.perf_counter() - t0) / reps

    # grow n_hi until the delta clears dispatch noise
    while True:
        tlo, thi = t(n_lo), t(n_hi)
        if thi - tlo >= 0.05 or n_hi >= 2048:
            break
        n_hi *= 4
    if thi - tlo <= 0:
        # noise-dominated even at the n_hi cap: report the conservative
        # upper bound (total time / iterations, overhead included)
        # rather than a garbage slope — and SAY SO in the artifact
        log(f"WARNING: device-time slope noise-dominated at n={n_hi}; "
            f"reporting upper bound {thi / n_hi * 1e3:.3f} ms/iter")
        LAST_REGIME = "upper-bound"
        return thi / n_hi
    LAST_REGIME = "slope"
    return (thi - tlo) / (n_hi - n_lo)


def bench_connected_decode(batch=64, frames=500, n_slots=7, frame_step_s=0.01):
    """Headline: audio-seconds/s of sausage-graph connected decode
    (emission GEMM + banded Viterbi + backtrace), steady-state device
    time via chained iterations (see _timeit_device)."""
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.decode.connected import _decode_banded_batch
    from speech_recognition_jax.decode.connected import connected_graph_arrays
    from speech_recognition_jax.ops.viterbi_banded import banded_arrays

    bank = _bank()
    graph = connected_graph_arrays(bank, n_slots)
    bg = banded_arrays(graph)
    log(f"graph: {graph.n_states} emitting states ({bg.n_words} word arcs), "
        f"eps_depth {graph.eps_depth}")

    rng = np.random.default_rng(1)
    feats = jnp.asarray(rng.standard_normal((batch, frames, 39)), jnp.float32)
    n_frames = jnp.full((batch,), frames, jnp.int32)

    from speech_recognition_jax.decode.connected import states_to_words_device

    slot_arr = jnp.asarray(np.asarray(graph.slot, np.int32))
    label_arr = jnp.asarray(np.asarray(graph.slot_label[graph.slot], np.int32))
    counts = np.bincount(np.asarray(graph.slot))
    max_words = min(frames, frames // max(1, int(counts[counts > 0].min())) + 1)

    def body(dep):
        # PRODUCTION path: the full feature-side chain to word ids on
        # device (emission GEMM + banded Viterbi + backtrace + the
        # states_to_words_device compaction); only [B, W] ids would
        # cross the host boundary
        nf = jnp.where(jnp.isnan(dep), n_frames + 1, n_frames)
        states, eps_flags, costs = _decode_banded_batch(
            bank, feats, nf, bg, eps_depth=graph.eps_depth
        )
        words, n_words = states_to_words_device(
            slot_arr, label_arr, states, eps_flags, nf, max_words=max_words)
        return jnp.sum(costs) + jnp.sum(words[:, 0].astype(jnp.float32))

    dt = _timeit_device(body)
    audio_s = batch * frames * frame_step_s
    thr = audio_s / dt
    log(f"connected decode (production, wav->word-ids on device): "
        f"{batch}x{frames} frames in "
        f"{dt*1e3:.2f} ms device-time ({LAST_REGIME}) -> {thr:.0f} audio-s/s")

    return thr


def bench_frontend(batch=64, samples=80000):
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.config import FrontendConfig
    from speech_recognition_jax.ops.frontend import mfcc39_batch, padded_length

    cfg = FrontendConfig()
    L = padded_length(cfg, samples)
    rng = np.random.default_rng(0)
    sig = jnp.asarray(rng.standard_normal((batch, L)), jnp.float32)
    lens = jnp.full((batch,), samples, jnp.int32)

    def body(dep):
        l2 = jnp.where(jnp.isnan(dep), lens - 1, lens)
        return jnp.sum(mfcc39_batch(sig, l2, cfg)[0])

    dt = _timeit_device(body)
    audio_s = batch * samples / cfg.sample_rate
    log(f"frontend: {audio_s:.0f} audio-s in {dt*1e3:.2f} ms device-time "
        f"-> {audio_s/dt:.0f} audio-s/s")
    return audio_s / dt


def bench_embedded_train(batch=32, frames=300):
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.models.graph import build_word_graph, pad_graphs
    from speech_recognition_jax.train.embedded_step import embedded_step

    bank = _bank()
    trans_np = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
    rng = np.random.default_rng(3)
    labels = [[int(rng.integers(0, 11)) for _ in range(5)] for _ in range(batch)]
    graphs = [build_word_graph(trans_np, [[l] for l in ls]) for ls in labels]
    gb, eps_depth = pad_graphs(graphs)
    g = {k: jnp.asarray(gb[k]) for k in ("trans", "eps_trans", "init_cost", "end_states", "bank_state")}
    feats = jnp.asarray(rng.standard_normal((batch, frames, 39)), jnp.float32)
    nf = jnp.full((batch,), frames, jnp.int32)

    def body(dep):
        nf2 = jnp.where(jnp.isnan(dep), nf + 1, nf)
        return embedded_step(bank, feats, nf2, g, eps_depth=eps_depth)[1].total_cost

    dt = _timeit_device(body)
    log(f"embedded step: {batch} utts in {dt*1e3:.2f} ms device-time "
        f"-> {batch/dt:.0f} utts/s")
    return batch / dt


def bench_pipeline(batch=256, samples=80000, n_slots=7):
    """Device-resident wav -> words: one jit for MFCC + emissions +
    banded Viterbi + backtrace, via the production batched decode."""
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.config import FrontendConfig
    from speech_recognition_jax.decode.connected import (
        _decode_banded_batch,
        connected_graph_arrays,
    )
    from speech_recognition_jax.ops.frontend import mfcc39_batch, padded_length
    from speech_recognition_jax.ops.viterbi_banded import banded_arrays

    cfg = FrontendConfig()
    bank = _bank()
    graph = connected_graph_arrays(bank, n_slots)
    bg = banded_arrays(graph)
    L = padded_length(cfg, samples)
    rng = np.random.default_rng(0)
    sig = jnp.asarray(rng.standard_normal((batch, L)) * 3000, jnp.float32)
    lens = jnp.full((batch,), samples, jnp.int32)

    def body(dep):
        l2 = jnp.where(jnp.isnan(dep), lens - 1, lens)
        feats, nf = mfcc39_batch(sig, l2, cfg)
        states, _, costs = _decode_banded_batch(bank, feats, nf, bg,
                                                eps_depth=graph.eps_depth)
        return jnp.sum(costs) + jnp.sum(states[:, 0].astype(jnp.float32))

    dt = _timeit_device(body)
    audio_s = batch * samples / cfg.sample_rate
    log(f"pipeline: {audio_s:.0f} audio-s in {dt*1e3:.2f} ms device-time "
        f"-> {audio_s/dt:.0f} audio-s/s")
    return audio_s / dt


def bench_lex_pipeline(batch=128, samples=80000, n_words=1000):
    """Device-resident wav -> words over the 1,000-word trie: one jit
    for MFCC + unit-bank emissions + banded lex Viterbi + backtrace —
    the big-vocabulary serving pipeline."""
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.config import FrontendConfig
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank, bank_nll
    from speech_recognition_jax.models.lexgraph import build_lex_graph
    from speech_recognition_jax.ops.frontend import mfcc39_batch, padded_length
    from speech_recognition_jax.ops.viterbi_banded import (
        banded_backtrace_tb,
        viterbi_banded_tb,
    )
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    cfg = FrontendConfig()
    units = list("abcdefgh")
    unit_ids = {ch: i for i, ch in enumerate(units)}
    rng = np.random.default_rng(7)
    models, unit_trans = [], []
    for _ in units:
        p = random_gmm_hmm(rng, n_states=3, n_mix=4, dim=39, sep=4.0)
        models.append(GMMHMM(
            means=jnp.asarray(p["means"], jnp.float32),
            log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
            log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
            trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
        ))
        unit_trans.append(p["trans"])
    bank = HMMBank.stack(models)
    vocab = set()
    while len(vocab) < n_words:
        n = int(rng.integers(3, 9))
        vocab.add("".join(rng.choice(units, n)))
    lexg = build_lex_graph(sorted(vocab), unit_trans, unit_ids,
                           word_insertion_cost=0.5)
    bg = lexg.banded

    L = padded_length(cfg, samples)
    sig = jnp.asarray(rng.standard_normal((batch, L)) * 3000, jnp.float32)
    lens = jnp.full((batch,), samples, jnp.int32)

    @jax.jit
    def decode(feats, nf):
        t = feats.shape[1]
        nll = jax.vmap(lambda x, n: bank_nll(bank, x, jnp.arange(t) < n))(
            feats, nf)
        nll_tb = jnp.transpose(nll, (1, 2, 0))[:, bg.bank_state, :]
        final, bp8, eps_u = viterbi_banded_tb(nll_tb, bg, nf)
        end_costs = final[bg.end_states, :] + bg.end_bonus[:, None]
        best = jnp.argmin(end_costs, axis=0)
        states, flags = banded_backtrace_tb(bp8, eps_u, bg,
                                            bg.end_states[best], nf)
        return jnp.take_along_axis(end_costs, best[None], 0), states, flags

    def body(dep):
        l2 = jnp.where(jnp.isnan(dep), lens - 1, lens)
        feats, nf = mfcc39_batch(sig, l2, cfg)
        costs, states, _ = decode(feats, nf)
        return jnp.sum(costs) + jnp.sum(states[0].astype(jnp.float32))

    dt = _timeit_device(body)
    audio_s = batch * samples / cfg.sample_rate
    log(f"lex pipeline ({n_words} words): {audio_s:.0f} audio-s in "
        f"{dt*1e3:.2f} ms device-time ({LAST_REGIME}) "
        f"-> {audio_s/dt:.0f} audio-s/s")

    # words-out tail the serving API pays: fetch the [B, T] paths and
    # run the vectorized host word recovery
    from speech_recognition_jax.models.lexgraph import lex_words_from_path_batch

    feats, nf = mfcc39_batch(sig, lens, cfg)
    _, states, flags = decode(feats, nf)
    jax.block_until_ready(states)
    t0 = time.perf_counter()
    s_np = np.asarray(states).T  # [B, T] fetch
    f_np = np.asarray(flags).T
    words = lex_words_from_path_batch(lexg, s_np, np.asarray(nf), f_np)
    t_words = time.perf_counter() - t0
    n_w = sum(len(w) for w in words)
    log(f"  + words-out: {n_w} words for {batch} streams in "
        f"{t_words*1e3:.0f} ms wall (fetch {s_np.nbytes + f_np.nbytes:,} B "
        f"+ vectorized host recovery) -> full serving "
        f"{audio_s/(dt + t_words):.0f} audio-s/s")
    return audio_s / dt


def bench_lextree(batch=64, frames=500, n_words=1000, frame_step_s=0.01,
                  beam_k=0, unroll=4, dict1=False):
    """Big-vocabulary lextree decode: 1,000-word trie over 8 unit
    models (~9.6k states), full exact kernel or the token beam.
    ``dict1=True`` swaps in the reference's own 6,250-word dictionary
    (/root/reference/tests/test_data/dict1.txt, 31 units, ~83k
    states)."""
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.models.lexgraph import build_lex_graph
    from speech_recognition_jax.ops.viterbi_banded import (
        banded_backtrace_tb,
        viterbi_banded_tb,
    )

    rng = np.random.default_rng(7)
    if dict1:
        raw = [line.strip() for line in
               open("/root/reference/tests/test_data/dict1.txt")][1:]
        seen, words = set(), []
        for w in raw:
            if w and w not in seen:
                seen.add(w)
                words.append(w)
        units = sorted(set("".join(words)))
    else:
        units = list("abcdefgh")
    unit_ids = {ch: i for i, ch in enumerate(units)}
    su = 3
    trans = []
    for _ in units:
        t = np.full((su, su), np.inf)
        for i in range(su):
            t[i, i] = rng.uniform(0.1, 1)
            if i + 1 < su:
                t[i + 1, i] = rng.uniform(0.1, 1)
        trans.append(t)
    if not dict1:
        vocab = set()
        while len(vocab) < n_words:
            n = int(rng.integers(3, 9))
            vocab.add("".join(rng.choice(units, n)))
        words = sorted(vocab)
    lexg = build_lex_graph(words, trans, unit_ids, word_insertion_cost=0.5)
    bg = lexg.banded
    log(f"lextree: {lexg.n_words} words, {lexg.n_arcs} arcs, "
        f"{lexg.n_states} states "
        f"(loop graph would be {sum(len(w) for w in words) * su})")

    e = jnp.asarray(rng.uniform(0, 5, (batch, frames, len(units) * su)),
                    jnp.float32)
    nf = jnp.full((batch,), frames, jnp.int32)

    if beam_k:
        from speech_recognition_jax.ops.beam import (
            beam_backtrace,
            beam_search,
            beam_tables,
        )

        tables = beam_tables(bg, leaf_word=lexg.leaf_word)

        def body(dep):
            nf2 = jnp.where(jnp.isnan(dep), nf + 1, nf)

            def one(nll_b, n_b):
                fst, fco, _, _, tok_p, tok_w = beam_search(
                    nll_b, tables, n_b, beam_k)
                cost, words_rev = beam_backtrace(fst, fco, tok_p, tok_w,
                                                 tables, n_b)
                return cost + jnp.sum(words_rev[:2].astype(jnp.float32))

            return jnp.sum(jax.vmap(one)(e, nf2))
    else:
        bank_state = bg.bank_state

        def body(dep):
            nf2 = jnp.where(jnp.isnan(dep), nf + 1, nf)
            nll_tb = jnp.transpose(e, (1, 2, 0))[:, bank_state, :]
            final, bp8, eps_u = viterbi_banded_tb(nll_tb, bg, nf2,
                                                  unroll=unroll)
            end_costs = final[bg.end_states, :] + bg.end_bonus[:, None]
            best = jnp.argmin(end_costs, axis=0)
            states, _ = banded_backtrace_tb(bp8, eps_u, bg,
                                            bg.end_states[best], nf2)
            return (jnp.sum(jnp.take_along_axis(end_costs, best[None], 0))
                    + jnp.sum(states[0].astype(jnp.float32)))

    dt = _timeit_device(body)
    audio_s = batch * frames * frame_step_s
    tag = f"beam k={beam_k}" if beam_k else "exact"
    log(f"lextree {tag}: {batch}x{frames} in {dt*1e3:.2f} ms device-time "
        f"({LAST_REGIME}) -> {audio_s/dt:.0f} audio-s/s")
    return audio_s / dt


def bench_lextree_dict1_bigram(batch=16, frames=500, frame_step_s=0.01):
    """Bigram LM x the reference's 6,250-word dictionary on the
    production path: the XLA lattice scan (entry-time carry) + the
    [B, L] backoff rescorer, timed as one chained device body."""
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.langmodel.bigram import fit_bigram
    from speech_recognition_jax.models.lexgraph import build_lex_graph
    from speech_recognition_jax.ops.lattice import (
        lattice_rescore,
        rescore_backoff,
        rescore_backoff_sliced,
        viterbi_lattice_tb,
    )

    rng = np.random.default_rng(7)
    raw = [line.strip() for line in
           open("/root/reference/tests/test_data/dict1.txt")][1:]
    seen, words = set(), []
    for w in raw:
        if w and w not in seen:
            seen.add(w)
            words.append(w)
    units = sorted(set("".join(words)))
    unit_ids = {ch: i for i, ch in enumerate(units)}
    su = 3
    trans = []
    for _ in units:
        t = np.full((su, su), np.inf)
        for i in range(su):
            t[i, i] = rng.uniform(0.1, 1)
            if i + 1 < su:
                t[i + 1, i] = rng.uniform(0.1, 1)
        trans.append(t)
    lexg = build_lex_graph(words, trans, unit_ids, word_insertion_cost=0.5)
    g = lexg.banded
    v = len(words)
    lm = fit_bigram([[int(x) for x in rng.integers(0, v, 20)]
                     for _ in range(400)], v)
    sliced = rescore_backoff_sliced(lm, lexg.leaf_word)
    if sliced is not None:
        bo, bo_counts = sliced
        nnz = sum(bo_counts)
        log(f"dict1 bigram: {v} words, {lexg.n_states} states, sliced "
            f"backoff recombination ({nnz} pairs, counts {bo_counts})")
    else:
        bo, bo_counts = rescore_backoff(lm, lexg.leaf_word), None
        log(f"dict1 bigram: {v} words, {lexg.n_states} states, "
            f"{'backoff K=' + str(int(bo[1].shape[1])) if bo else 'dense'} "
            f"recombination")
    lw = jnp.asarray(lexg.leaf_word)
    cost_d = jnp.asarray(np.asarray(lm.cost, np.float32))
    start_d = jnp.asarray(np.asarray(lm.start_cost, np.float32))
    end_d = jnp.asarray(np.asarray(lm.end_cost, np.float32))
    eb = jnp.asarray(rng.uniform(0, 5, (frames, len(units) * su, batch)),
                     jnp.float32)
    nfb = jnp.full((batch,), frames, jnp.int32)

    def body(dep, eb, nfb):
        nf2 = jnp.where(jnp.isnan(dep), nfb + 1, nfb)
        _, ec, et = viterbi_lattice_tb(eb[:, g.bank_state, :], g, nf2)
        r = lattice_rescore(ec, et, lw, cost_d, start_d, end_d, nf2,
                            backoff=bo, backoff_counts=bo_counts)
        return jnp.sum(r.cost) + jnp.sum(r.pred_w[-1].astype(jnp.float32))

    dt = _timeit_device(body, args=(eb, nfb))
    audio_s = batch * frames * frame_step_s
    log(f"dict1 bigram decode (lattice scan + rescore): {batch}x{frames} "
        f"in {dt*1e3:.2f} ms device-time ({LAST_REGIME}) "
        f"-> {audio_s/dt:.0f} audio-s/s")
    return audio_s / dt


def bench_lextree_bigram(batch=128, frames=500, n_words=1000,
                         frame_step_s=0.01):
    """Exact-bigram-over-lattice decode on a 1,000-word deep trie:
    lattice scan (tau carry) + bigram rescoring scan, one jit."""
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.langmodel.bigram import fit_bigram
    from speech_recognition_jax.models.lexgraph import build_lex_graph
    from speech_recognition_jax.ops.lattice import (
        lattice_rescore,
        rescore_backoff,
        viterbi_lattice_tb,
    )

    units = list("abcdefgh")
    unit_ids = {ch: i for i, ch in enumerate(units)}
    su = 3
    rng = np.random.default_rng(7)
    trans = []
    for _ in units:
        t = np.full((su, su), np.inf)
        for i in range(su):
            t[i, i] = rng.uniform(0.1, 1)
            if i + 1 < su:
                t[i + 1, i] = rng.uniform(0.1, 1)
        trans.append(t)
    vocab = set()
    while len(vocab) < n_words:
        n = int(rng.integers(3, 9))
        vocab.add("".join(rng.choice(units, n)))
    words = sorted(vocab)
    lexg = build_lex_graph(words, trans, unit_ids, word_insertion_cost=0.5)
    lm = fit_bigram([[int(x) for x in rng.integers(0, n_words, 12)]
                     for _ in range(200)], n_words)
    big = jnp.asarray(lm.cost)
    start_c = jnp.asarray(lm.start_cost)
    end_c = jnp.asarray(lm.end_cost)
    leaf_word = jnp.asarray(lexg.leaf_word)
    bo = rescore_backoff(lm, lexg.leaf_word)  # add-k LM: always present

    e = jnp.asarray(rng.uniform(0, 5, (frames, len(units) * su, batch)),
                    jnp.float32)
    nf = jnp.full((batch,), frames, jnp.int32)

    def body(dep):
        nf2 = jnp.where(jnp.isnan(dep), nf + 1, nf)
        nll_tb = e[:, np.asarray(lexg.banded.bank_state), :]
        _, ends_cost, ends_tau = viterbi_lattice_tb(nll_tb, lexg.banded, nf2)
        res = lattice_rescore(ends_cost, ends_tau, leaf_word, big, start_c,
                              end_c, nf2, backoff=bo)
        return jnp.sum(res.cost) + jnp.sum(res.best_leaf.astype(jnp.float32))

    dt = _timeit_device(body)
    audio_s = batch * frames * frame_step_s
    log(f"lextree bigram ({n_words} words): {batch}x{frames} in "
        f"{dt*1e3:.2f} ms device-time ({LAST_REGIME}) "
        f"-> {audio_s/dt:.0f} audio-s/s")
    return audio_s / dt


def bench_soft_em(batch=32, frames=300, banded="auto"):
    """Baum-Welch (sum-product) embedded step, device time.  The
    production form picks the forward-backward pass by graph size
    (``pad_graphs_auto``): dense [S, S] for transcript-scale graphs
    (S ~ 30), banded O(3S)/frame past the crossover.
    ``banded=True/False`` force a pass for comparison."""
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.models.graph import (
        build_word_graph, pad_graphs, pad_graphs_auto, pad_graphs_banded)
    from speech_recognition_jax.train.embedded_step import embedded_step_soft

    bank = _bank()
    trans_np = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
    rng = np.random.default_rng(3)
    labels = [[int(rng.integers(0, 11)) for _ in range(5)] for _ in range(batch)]
    graphs = [build_word_graph(trans_np, [[l] for l in ls]) for ls in labels]
    if banded == "auto":
        gb, eps_depth = pad_graphs_auto(graphs)
        banded = "band" in gb
    elif banded:
        gb, eps_depth = pad_graphs_banded(graphs)
    else:
        gb, eps_depth = pad_graphs(graphs)
    if "band" in gb:
        g = {k: jnp.asarray(v) for k, v in gb.items()}
    else:
        g = {k: jnp.asarray(gb[k]) for k in ("trans", "eps_trans", "init_cost",
                                             "end_scores", "bank_state")}
    feats = jnp.asarray(rng.standard_normal((batch, frames, 39)), jnp.float32)
    nf = jnp.full((batch,), frames, jnp.int32)

    def body(dep):
        nf2 = jnp.where(jnp.isnan(dep), nf + 1, nf)
        return embedded_step_soft(bank, feats, nf2, g,
                                  eps_depth=eps_depth)[1].total_cost

    dt = _timeit_device(body)
    form = "banded" if "band" in gb else "dense"
    log(f"soft-EM step ({form} FB): {batch} utts in {dt*1e3:.2f} ms "
        f"device-time ({LAST_REGIME}) -> {batch/dt:.0f} utts/s")
    return batch / dt


def bench_streaming(batch=64, chunk=256, n_chunks=20, frame_step_s=0.01):
    """Long-audio streaming decoder: per-chunk device time of the
    carried-frontier step, plus a real multi-chunk push + one-call
    device backtrace (finish) timed end-to-end (host transfers labeled
    separately)."""
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.decode.connected import connected_graph_arrays
    from speech_recognition_jax.decode.streaming import StreamingDecoder, _chunk_step

    bank = _bank()
    graph = connected_graph_arrays(bank, 7)
    dec = StreamingDecoder(bank, graph, chunk_frames=chunk, batch=batch)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((batch, chunk, 39)), jnp.float32)
    nv = jnp.full((batch,), chunk, jnp.int32)
    fr = dec._frontier

    def body(dep):
        nv2 = jnp.where(jnp.isnan(dep), nv + 1, nv)
        f2, bp8, eps_u = jax.vmap(
            lambda f, xx, n: _chunk_step(bank, dec.bg, f, xx, n,
                                         eps_depth=graph.eps_depth,
                                         first_chunk=False))(fr, x, nv2)
        return jnp.sum(f2) + jnp.sum(bp8[0, 0].astype(jnp.float32))

    dt = _timeit_device(body)
    audio_s = batch * chunk * frame_step_s
    log(f"streaming chunk step: {batch}x{chunk} frames in {dt*1e3:.2f} ms "
        f"device-time ({LAST_REGIME}) -> {audio_s/dt:.0f} audio-s/s")

    # real end-to-end long-audio decode through the push API.
    # (a) device-resident chunks (the serving shape: the on-chip MFCC
    # frontend feeds the decoder, so features never cross the host) —
    # bp planes stay on device, finish() fetches only the [B, T] paths
    chunks_dev = [
        jax.block_until_ready(jnp.asarray(
            rng.standard_normal((batch, chunk, 39)), jnp.float32))
        for _ in range(n_chunks)]
    total_audio = batch * chunk * n_chunks * frame_step_s
    for trial in range(2):  # second run reuses compiled programs
        dec.reset()
        t0 = time.perf_counter()
        for x_dev in chunks_dev:
            dec.push(x_dev)
        words = dec.finish()
        wall = time.perf_counter() - t0
    log(f"streaming e2e (device chunks): {n_chunks} chunks x {batch} "
        f"streams ({total_audio:.0f} audio-s) in {wall:.2f} s wall -> "
        f"{total_audio/wall:.0f} audio-s/s through the push API")
    e2e = total_audio / wall

    # (b) host numpy chunks: adds the feature upload
    dec.reset()
    chunks_np = [np.asarray(c) for c in chunks_dev]
    t0 = time.perf_counter()
    for x_np in chunks_np:
        dec.push(x_np)
    words = dec.finish()
    wall = time.perf_counter() - t0
    log(f"streaming e2e (host chunks): {total_audio:.0f} audio-s in "
        f"{wall:.2f} s wall incl. feature upload -> "
        f"{total_audio/wall:.0f} audio-s/s")

    # (c) incremental emission: unbounded-audio mode — words emitted
    # mid-stream via path-immortality flushes, plane memory O(window).
    # Two requirements for stabilization: speech-like input (pure noise
    # keeps every hypothesis competitive) and an unbounded-audio graph
    # (the LOOP graph; a fixed-slot sausage keeps lagging slot-1 tokens
    # alive forever, so no boundary is ever shared — and it cannot
    # model unbounded audio in the first place).
    from speech_recognition_jax.decode.streaming import StreamingDecoder as SD
    from speech_recognition_jax.models.graph import build_loop_graph

    loop_g = build_loop_graph(
        [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)])

    means = np.asarray(bank.means)  # [N, S, M, D]
    n_models, n_states = means.shape[0], means.shape[1]
    t_total = chunk * n_chunks
    sig_feats = np.zeros((batch, t_total, means.shape[-1]), np.float32)
    for bi in range(batch):
        t = 0
        while t < t_total:
            w = int(rng.integers(0, n_models))
            for st in range(n_states):
                for _ in range(int(rng.integers(2, 5))):
                    if t >= t_total:
                        break
                    sig_feats[bi, t] = (means[w, st, 0]
                                        + 0.5 * rng.standard_normal(
                                            means.shape[-1]))
                    t += 1
    chunks_sp = [
        jax.block_until_ready(jnp.asarray(
            sig_feats[:, i * chunk : (i + 1) * chunk], jnp.float32))
        for i in range(n_chunks)]

    for fe in (2, 4):
        dec_i = SD(bank, loop_g, chunk_frames=chunk, batch=batch,
                   emit_incremental=True, window_chunks=8, flush_every=fe)
        n_early = 0
        max_buf = 0
        for trial in range(2):
            dec_i.reset()
            n_early = 0
            t0 = time.perf_counter()
            for x_dev in chunks_sp:
                new = dec_i.push(x_dev)
                n_early += sum(len(w) for w in new)
                max_buf = max(max_buf, len(dec_i._bp_chunks))
            res = dec_i.finish()
            wall_i = time.perf_counter() - t0
        n_total = sum(len(r[0]) for r in res)
        log(f"streaming e2e (incremental, window 8, flush_every {fe}): "
            f"{total_audio:.0f} audio-s in {wall_i:.2f} s wall -> "
            f"{total_audio/wall_i:.0f} audio-s/s; "
            f"{n_early}/{n_total} words emitted mid-stream, plane buffer "
            f"peak {max_buf} chunks (memory O(window) for unbounded audio)")

    # (d) incremental over a LEXGRAPH (big-vocabulary unbounded-audio
    # serving): 1,000-word trie, speech-like audio spelling random
    # words, bounded-memory word emission mid-stream
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.models.lexgraph import build_lex_graph
    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    nprng = np.random.default_rng(3)
    units = list("abcdefgh")
    unit_ids = {ch: i for i, ch in enumerate(units)}
    vocab = set()
    while len(vocab) < 1000:
        vocab.add("".join(nprng.choice(units, int(nprng.integers(3, 8)))))
    words_v = sorted(vocab)
    su, dim = 3, 10
    models, unit_trans, umeans = [], [], []
    for _ in units:
        p = random_gmm_hmm(nprng, n_states=su, n_mix=1, dim=dim, sep=4.0)
        models.append(GMMHMM(
            means=jnp.asarray(p["means"], jnp.float32),
            log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
            log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
            trans_cost=jnp.asarray(to_cost_matrix(p["trans"])),
        ))
        unit_trans.append(p["trans"])
        umeans.append(p["means"][:, 0, :])
    lbank = HMMBank.stack(models)
    lexg = build_lex_graph(words_v, unit_trans, unit_ids,
                           word_insertion_cost=0.5)
    bl, n_ch = 16, 8
    t_tot = chunk * n_ch
    lf = np.zeros((bl, t_tot, dim), np.float32)
    for bi in range(bl):
        t = 0
        while t < t_tot:
            w = words_v[int(nprng.integers(0, len(words_v)))]
            for ch in w:
                for j in range(su):
                    for _ in range(3):
                        if t < t_tot:
                            lf[bi, t] = (umeans[unit_ids[ch]][j]
                                         + 0.4 * nprng.standard_normal(dim))
                            t += 1
    chunks_lex = [jax.block_until_ready(jnp.asarray(
        lf[:, i * chunk:(i + 1) * chunk], jnp.float32))
        for i in range(n_ch)]
    dec_l = SD(lbank, lexg, chunk_frames=chunk, batch=bl,
               emit_incremental=True, window_chunks=4, flush_every=2)
    lex_audio = bl * t_tot * frame_step_s
    for trial in range(2):
        dec_l.reset()
        n_early = 0
        t0 = time.perf_counter()
        for x_dev in chunks_lex:
            new = dec_l.push(x_dev)
            n_early += sum(len(w) for w in new)
        res = dec_l.finish()
        wall_l = time.perf_counter() - t0
    n_total = sum(len(r[0]) for r in res)
    log(f"streaming e2e (incremental LEXGRAPH, 1k words): "
        f"{lex_audio:.0f} audio-s in {wall_l:.2f} s wall -> "
        f"{lex_audio/wall_l:.0f} audio-s/s; {n_early}/{n_total} words "
        f"emitted mid-stream")
    return e2e


def bench_spellcheck():
    """Reference workload: text Viterbi of the misspelled tale against
    the 6,250-word dict1 trie (27.5k nodes) — device chars/s of the
    column scan (``/root/reference/tests/lextree_tests.py:7-51`` runs
    this exact workload with a per-cell Python loop and no asserts)."""
    import re

    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.langmodel.lextree import lextree_from_words
    from speech_recognition_jax.langmodel.spellcheck import _text_viterbi_device

    words = [ln.strip() for ln in
             open("/root/reference/tests/test_data/dict1.txt")][1:]
    words = list(dict.fromkeys(w for w in words if w))
    tree = lextree_from_words(words)
    src = open("/root/reference/tests/lextree_tests.py").read()
    tale = re.search(r"typos = '''(.*?)'''", src, re.S).group(1).strip()
    tale = " ".join(tale.split())

    # a 512-char slice keeps one dispatch long enough that plain
    # repeated wall timing (fenced by the host fetch in run()) is honest
    n_chars = min(len(tale), 512)
    codes = jnp.asarray([ord("*")] + [ord(c) for c in tale[: n_chars]],
                        jnp.int32)
    val = jnp.asarray(tree.val.astype(np.int32))
    parent = jnp.asarray(tree.parent)
    is_root_child = jnp.asarray(tree.parent == 0)
    is_word_end = jnp.asarray(tree.prop == 2)
    md = tree.max_depth

    def run():
        costs, _, _ = _text_viterbi_device(
            codes, val, parent, is_root_child, is_word_end, max_depth=md)
        return float(jnp.sum(jnp.where(costs[-1] < 1e29, costs[-1], 0.0)))

    run()  # compile + warm
    t0 = time.perf_counter()
    reps = 2
    for _ in range(reps):
        run()
    dt = (time.perf_counter() - t0) / reps
    global LAST_REGIME
    LAST_REGIME = "single-dispatch"
    log(f"spellcheck (per-string reference-DP kernel): {n_chars} chars "
        f"over {tree.n_nodes} trie nodes in {dt*1e3:.0f} ms -> "
        f"{n_chars/dt:.0f} chars/s (gather-bound)")

    # production kernel: depth-level sweep, batch on lanes ([N, B])
    from speech_recognition_jax.langmodel.spellcheck import (
        _LevelPlan, _text_viterbi_levels)

    plan = _LevelPlan(tree)
    b = 128
    c = 257
    chunks = [(tale + tale)[7 * i : 7 * i + c - 1] for i in range(b)]
    codes_b = np.full((c, b), ord("*"), np.int32)
    for i, txt in enumerate(chunks):
        codes_b[1 : 1 + len(txt), i] = np.frombuffer(
            txt.encode("latin-1"), np.uint8)
    codes_b = jnp.asarray(codes_b)
    dev_args = plan.device_args()

    def run_b():
        ends_min = _text_viterbi_levels(codes_b, *dev_args, off=plan.off,
                                        need_bp=False)
        return float(jnp.sum(jnp.where(ends_min[-1] < 1e29,
                                       ends_min[-1], 0.0)))

    run_b()
    t0 = time.perf_counter()
    for _ in range(reps):
        run_b()
    dt_b = (time.perf_counter() - t0) / reps
    total = b * (c - 1)
    log(f"spellcheck (level-sweep kernel, batch {b}): {total} chars in "
        f"{dt_b*1e3:.0f} ms -> {total/dt_b:.0f} chars/s")
    return total / dt_b


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--what", default="headline",
                    choices=["headline", "frontend", "train", "soft_em",
                             "decode", "pipeline", "lextree", "lex_pipeline",
                             "lextree_dict1", "lextree_bigram",
                             "lextree_dict1_bigram",
                             "streaming", "spellcheck"])
    ap.add_argument("--batch", type=int, default=0,
                    help="0 = per-benchmark default (headline and decode: 512)")
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--beam-k", type=int, default=0,
                    help="lextree only: token-beam width (0 = exact kernel)")
    args = ap.parse_args()

    import jax

    from speech_recognition_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX reports {dev.platform}); "
                 "the benchmark measures the GPU only")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"devices: {jax.devices()}")

    def emit(metric, value, unit):
        print(json.dumps({"metric": metric, "value": round(value, 1),
                          "unit": unit, "regime": LAST_REGIME,
                          "device": device}))

    simple = {
        "frontend": (bench_frontend, "mfcc-frontend", "audio-seconds/s", 64),
        "pipeline": (bench_pipeline, "wav-to-words-pipeline",
                     "audio-seconds/s", 256),
        "train": (bench_embedded_train, "embedded-EM", "utterances/s", 32),
        "soft_em": (bench_soft_em, "embedded-EM-baum-welch",
                    "utterances/s", 32),
        "streaming": (bench_streaming, "streaming-decode",
                      "audio-seconds/s", 64),
        "lex_pipeline": (bench_lex_pipeline, "lex-wav-to-words-pipeline",
                         "audio-seconds/s", 128),
    }
    if args.what == "spellcheck":
        emit("spellcheck-tale-dict1", bench_spellcheck(), "chars/s")
    elif args.what in simple:
        fn, metric, unit, default_b = simple[args.what]
        emit(metric, fn(args.batch or default_b), unit)
    elif args.what == "lextree":
        emit("lextree-1k-word-decode",
             bench_lextree(args.batch or 64, args.frames, beam_k=args.beam_k),
             "audio-seconds/s")
    elif args.what == "lextree_bigram":
        emit("lextree-bigram-rescored-decode",
             bench_lextree_bigram(args.batch or 128, args.frames),
             "audio-seconds/s")
    elif args.what == "lextree_dict1":
        emit("lextree-dict1-6250-word-decode",
             bench_lextree(args.batch or 32, args.frames, dict1=True),
             "audio-seconds/s")
    elif args.what == "lextree_dict1_bigram":
        emit("lextree-dict1-bigram-decode",
             bench_lextree_dict1_bigram(args.batch or 16, args.frames),
             "audio-seconds/s")
    else:  # headline and decode: the pinned 512 x 500 shape, in-process
        emit("connected-digit-decode",
             bench_connected_decode(args.batch or 512, args.frames),
             "audio-seconds/s")


if __name__ == "__main__":
    main()
