"""Smoke run of the digit recogniser on the GPU.

Drives the main path once, through the entry points a user calls, at the
full width of the digit deployment (11 word models x 5 states x 4
mixtures, 39-dim features; weights random from a seed), and compares
every phase with the repo's plain reference in the same process:

  frontend   ``mfcc39_batch`` at 256 x 5 s vs the float64 psf oracle
             (``tests/oracles/frontend_ref.py``)
  decode     wav -> word ids on device over the 7-slot x 11-word graph
             (385 states) at 512 x 500 frames, vs the same function on
             the CPU and vs the float64 DP oracle
             (``tests/oracles/dp_ref.py``) on a few short utterances
  lextree    ``decode_lextree_bigram`` on the 1,000-word trie at
             128 x 500 frames vs the CPU
  streaming  ``StreamingDecoder`` (chunked, and incremental) vs the
             monolithic decode
  em         the CLI end to end: synth -> isolated_train ->
             continuous_train (hard and soft) -> connected_test ->
             stream --incremental; iteration costs non-increasing and
             equal to the same CLI run on the CPU

``--four-cards`` runs only the multi-device paths of ``parallel/`` on
four GPUs (sharded embedded EM on a 2x2 mesh, the state-sharded lexgraph
decode, the data-sharded lattice-bigram decode), each compared with the
same computation on one card.

Every line before the last carries the card's name and power limit;
the last line is one JSON object.  Exits non-zero, and prints no result,
when JAX finds no GPU or any phase fails.

Run:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# Tolerances of every comparison, with the reason for each.
TOLERANCES = {
    # Standardized 39-dim features are O(1); the float32 chain (HIGHEST
    # GEMMs) against the float64 oracle is held to the same absolute
    # bound the CPU suite holds the float32 frontend to
    # (tests/test_frontend.py::test_float32_precision_bounded).
    "frontend_atol": 5e-2,
    # Path costs are sums of ~500 float32 emission costs of O(100); GPU
    # and CPU GEMMs reduce in different orders, which moves a sum by
    # ~1e-7 relative.  1e-5 leaves two orders of margin.
    "cost_rtol": 1e-5,
    # Where two decoders return different words, their best costs must
    # agree within cost_rtol (two paths tied within rounding).  Such
    # ties are rare on continuous-valued emissions: a larger share means
    # the word read-out, not the scores, disagrees.
    "max_tie_share": 0.02,
    # Hard EM re-aligns on argmin decisions, so a near-tie resolved
    # differently moves a frame to another state and perturbs the next
    # iteration's statistics; 1e-3 of the total cost bounds a handful
    # of such frames.
    "em_cost_rtol": 1e-3,
    # EM never raises its objective; the slack absorbs float32 rounding
    # of the total once the iterations have nearly converged.
    "em_monotone_rtol": 1e-5,
    # Sharded and one-card runs add the same float32 terms; only the
    # emission GEMM's reduction order can differ with the shard shape.
    "sharded_rtol": 1e-5,
    # Re-estimated GMM parameters are ratios of sums that the mesh
    # reduces in another order than one card does, and a near-tie
    # aligned differently moves one frame's weight (~1/n of a state's
    # statistics); relative L2 distance over the whole bank.
    "sharded_param_rel_l2": 1e-3,
}

SAMPLE_RATE = 16000
FRAME_STEP = 160


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of every phase.  The defaults are the deployment's; the
    CPU tests pass smaller ones."""

    frontend_batch: int = 256
    frontend_seconds: float = 5.0
    frontend_oracle_utts: int = 8
    decode_batch: int = 512
    decode_frames: int = 500
    dp_oracle_utts: int = 2
    # the shortest path through 7 slots of 5-state words is 35 frames
    dp_oracle_frames: int = 40
    lex_words: int = 1000
    lex_batch: int = 128
    lex_frames: int = 500
    stream_batch: int = 64
    stream_frames: int = 500
    stream_chunk: int = 64
    incremental_streams: int = 4
    # cli synth: --n-train, --n-test, --n-continuous
    em_corpus: tuple = (4, 2, 24)
    em_iterations: int = 3
    multi_em_batch: int = 128
    multi_em_frames: int = 300
    sharded_utts: int = 4
    sharded_frames: int = 500
    bigram_batch: int = 128


FULL = Sizes()


class PhaseFailure(AssertionError):
    """A comparison exceeded its tolerance."""


@dataclasses.dataclass
class Ctx:
    sizes: Sizes
    tag: str
    ref_device: object  # jax.Device the reference runs on (the CPU)
    out: object = None  # None: the current sys.stdout

    def say(self, phase: str, msg: str) -> None:
        print(f"[{self.tag}] {phase}: {msg}", file=self.out, flush=True)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def assert_close(what, got, want, rtol=0.0, atol=0.0):
    """Elementwise ``|got - want| <= atol + rtol * |want|`` on finite
    values of equal shape.  Returns ``(max abs err, max rel err)``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise PhaseFailure(f"{what}: shape {got.shape} != {want.shape}")
    if not np.all(np.isfinite(got)):
        raise PhaseFailure(f"{what}: {int(np.sum(~np.isfinite(got)))} "
                           "non-finite values")
    err = np.abs(got - want)
    rel = err / np.maximum(np.abs(want), 1e-30)
    bad = err > atol + rtol * np.abs(want)
    if np.any(bad):
        raise PhaseFailure(
            f"{what}: {int(bad.sum())}/{bad.size} values outside "
            f"atol={atol:g} rtol={rtol:g} (max abs err {err.max():.3g}, "
            f"max rel err {rel.max():.3g})")
    return float(err.max(initial=0.0)), float(rel.max(initial=0.0))


def compare_decodes(what, words, costs, ref_words, ref_costs,
                    rtol=TOLERANCES["cost_rtol"],
                    max_tie_share=TOLERANCES["max_tie_share"]):
    """Word sequences must be identical except on ties; costs must agree
    within ``rtol``.  A tie is an utterance whose words differ while its
    best costs agree.  Returns ``(n_ties, max rel cost err)``."""
    if len(words) != len(ref_words):
        raise PhaseFailure(f"{what}: {len(words)} vs {len(ref_words)} "
                           "utterances")
    _, rel = assert_close(f"{what} costs", costs, ref_costs, rtol=rtol)
    ties = sum(list(a) != list(b) for a, b in zip(words, ref_words))
    if ties > max_tie_share * len(words):
        raise PhaseFailure(
            f"{what}: words differ on {ties}/{len(words)} utterances, more "
            f"than the {max_tie_share:.0%} tie share")
    return ties, rel


def card_tag() -> str:
    """``name, power limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def require_gpu(n_cards: int):
    """The GPU devices, or SystemExit when JAX finds fewer than asked."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n_cards:
        raise SystemExit(
            f"chip_smoke: needs {n_cards} GPU(s); JAX found "
            f"{len(devs)} {devs[0].platform} device(s)")
    return devs


def last_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def oracle(name):
    """``tests/oracles/<name>.py`` of this checkout, loaded by path: an
    installed package named ``tests`` would shadow the repo's."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "oracles", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_oracle_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wall(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _peak(ctx, phase):
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    ctx.say(phase, "peak_bytes_in_use "
            + (f"{peak:,}" if peak is not None else "not reported"))


def _on(device, tree):
    import jax

    return jax.device_put(tree, device)


# ---------------------------------------------------------------------------
# shared inputs, all made from seeds
# ---------------------------------------------------------------------------


def digit_bank(n_models=11, seed=0):
    """The digit deployment's widths: 5-state, 4-mixture, 39-dim
    GMM-HMMs with random weights from ``seed``."""
    import jax.numpy as jnp

    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    rng = np.random.default_rng(seed)
    models = []
    for _ in range(n_models):
        p = random_gmm_hmm(rng, n_states=5, n_mix=4, dim=39, sep=3.0)
        models.append(GMMHMM(
            means=jnp.asarray(p["means"], jnp.float32),
            log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
            log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
            trans_cost=jnp.asarray(to_cost_matrix(p["trans"]))))
    return HMMBank.stack(models)


def digit_audio(batch, n_samples, seed=0):
    """``[B, n_samples]`` float32 connected-digit audio (seeded synthetic
    corpus, each row filled with consecutive digit strings)."""
    from speech_recognition_jax.data.synthetic import SyntheticDigits

    gen = SyntheticDigits(seed=seed)
    out = np.zeros((batch, n_samples), np.float32)
    k = 0
    for i in range(batch):
        pos = 0
        while pos < n_samples:
            u = gen.continuous_corpus(1, tag=f"smoke{k}")[0].samples
            k += 1
            n = min(len(u), n_samples - pos)
            out[i, pos:pos + n] = u[:n]
            pos += n
    return out


def lex_case(n_words, seed=7):
    """The 1,000-word trie of ``bench.py --what lextree_bigram``: 8
    3-state units, words of 3-8 units, word-insertion cost 0.5; a
    4-mixture 39-dim unit bank and a bigram fitted on seeded text."""
    import jax.numpy as jnp

    from speech_recognition_jax.data.synthetic import random_gmm_hmm
    from speech_recognition_jax.langmodel.bigram import fit_bigram
    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.models.lexgraph import build_lex_graph
    from speech_recognition_jax.utils.numerics import to_cost_matrix

    rng = np.random.default_rng(seed)
    units = list("abcdefgh")
    unit_ids = {ch: i for i, ch in enumerate(units)}
    models, trans, means = [], [], []
    for _ in units:
        p = random_gmm_hmm(rng, n_states=3, n_mix=4, dim=39, sep=4.0)
        models.append(GMMHMM(
            means=jnp.asarray(p["means"], jnp.float32),
            log_vars=jnp.log(jnp.asarray(p["variances"], jnp.float32)),
            log_weights=jnp.log(jnp.asarray(p["weights"], jnp.float32)),
            trans_cost=jnp.asarray(to_cost_matrix(p["trans"]))))
        trans.append(p["trans"])
        means.append(p["means"][:, 0, :])
    vocab = set()
    while len(vocab) < n_words:
        vocab.add("".join(rng.choice(units, int(rng.integers(3, 9)))))
    words = sorted(vocab)
    lexg = build_lex_graph(words, trans, unit_ids, word_insertion_cost=0.5)
    lm = fit_bigram([[int(x) for x in rng.integers(0, n_words, 12)]
                     for _ in range(200)], n_words)
    return HMMBank.stack(models), lexg, lm, words, unit_ids, means


def lex_features(words, unit_ids, means, batch, frames, seed=11):
    """Features spelling random words: 2-4 frames per unit state at the
    state's first mixture mean plus noise."""
    rng = np.random.default_rng(seed)
    dim = means[0].shape[-1]
    out = np.zeros((batch, frames, dim), np.float32)
    for b in range(batch):
        t = 0
        while t < frames:
            for ch in words[int(rng.integers(0, len(words)))]:
                for mu in means[unit_ids[ch]]:
                    for _ in range(int(rng.integers(2, 5))):
                        if t < frames:
                            out[b, t] = mu + 0.5 * rng.standard_normal(dim)
                            t += 1
    return out


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_frontend(ctx: Ctx):
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.config import FrontendConfig
    from speech_recognition_jax.ops.frontend import mfcc39_batch, padded_length
    load_wav_as_mfcc_oracle = oracle("frontend_ref").load_wav_as_mfcc_oracle

    s = ctx.sizes
    cfg = FrontendConfig()
    n = int(s.frontend_seconds * SAMPLE_RATE)
    sig = digit_audio(s.frontend_batch, padded_length(cfg, n), seed=1)
    lens = np.full((s.frontend_batch,), n, np.int32)
    # the oracle sees exactly the samples the device sees
    sig[:, n:] = 0.0

    fe = jax.jit(lambda x, l: mfcc39_batch(x, l, cfg))
    args = (jnp.asarray(sig), jnp.asarray(lens))
    t0 = time.perf_counter()
    compiled = fe.lower(*args).compile()
    ctx.say("frontend", f"compile {time.perf_counter() - t0:.2f} s (set-up)")
    compiled(*args)[0].block_until_ready()
    (feats, nf), dt = _wall(lambda: compiled(*args))
    ctx.say("frontend", f"{s.frontend_batch} x {s.frontend_seconds:g} s "
            f"in {dt * 1e3:.2f} ms wall")
    feats, nf = np.asarray(feats), np.asarray(nf)
    worst = 0.0
    for i in range(s.frontend_oracle_utts):
        ref = load_wav_as_mfcc_oracle(sig[i, :n].astype(np.float64))
        if int(nf[i]) != ref.shape[0]:
            raise PhaseFailure(f"frontend: utt {i} has {int(nf[i])} frames, "
                               f"oracle {ref.shape[0]}")
        err, _ = assert_close(f"frontend utt {i}", feats[i, :ref.shape[0]],
                              ref, atol=TOLERANCES["frontend_atol"])
        worst = max(worst, err)
    ctx.say("frontend", f"vs float64 oracle on {s.frontend_oracle_utts} "
            f"utterances: max abs err {worst:.3g} "
            f"(tolerance {TOLERANCES['frontend_atol']:g})")
    _peak(ctx, "frontend")


def nes_reference(model_trans, n_slots):
    """The reference's explicit-NES layout of an ``n_slots``-slot sausage
    over every model (``main.py``'s graph): transitions with inf where
    absent, NES flags, the emitting-state map into our graph order, and
    the end points."""
    n_words = len(model_trans)
    s = model_trans[0].shape[0]
    n_ref = 1 + n_slots * (n_words * s + 1)
    trans = np.full((n_ref, n_ref), np.inf)
    is_nes = np.zeros(n_ref, bool)
    is_nes[0] = True
    idx, nes, starts, ends, emit = 1, [0], [], [], []
    for layer in range(n_slots):
        for w in range(n_words):
            starts.append((layer, idx))
            ends.append((layer, idx + s - 1))
            trans[idx:idx + s, idx:idx + s] = model_trans[w]
            emit += list(range(idx, idx + s))
            idx += s
        is_nes[idx] = True
        nes.append(idx)
        idx += 1
    for layer, st in starts:
        trans[st, nes[layer]] = 0.0
    for layer, e in ends:
        trans[nes[layer + 1], e] = 0.0
    end_points = [[e, -1] for layer, e in ends if layer == n_slots - 1]
    return trans, is_nes, np.asarray(emit), end_points


def dp_oracle_words(graph, model_trans, n_slots, emis_graph):
    """Best cost and word sequence of the float64 DP oracle for one
    utterance's graph-state emissions ``[T, S]``."""
    decode_hmm_states_oracle = oracle("dp_ref").decode_hmm_states_oracle

    trans, is_nes, emit, end_points = nes_reference(model_trans, n_slots)
    emis = np.zeros((emis_graph.shape[0], trans.shape[0]))
    emis[:, emit] = emis_graph
    costs, path, best = decode_hmm_states_oracle(emis, trans, is_nes,
                                                 end_points)
    pos = {int(r): i for i, r in enumerate(emit)}
    slots = [int(graph.slot[pos[int(p[0])]]) for p in reversed(path.tolist())
             if not is_nes[int(p[0])]]
    end = min(end_points, key=lambda e: costs[e[0], -1])
    slots.append(int(graph.slot[pos[end[0]]]))
    words = [int(graph.slot_label[sl]) for i, sl in enumerate(slots)
             if i == 0 or sl != slots[i - 1]]
    return best, words


def phase_decode(ctx: Ctx):
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.config import FrontendConfig
    from speech_recognition_jax.decode.connected import (
        _decode_banded_batch,
        connected_graph_arrays,
        decode_connected,
        states_to_words_device,
    )
    from speech_recognition_jax.models.hmm import bank_nll
    from speech_recognition_jax.ops.frontend import mfcc39_batch, padded_length
    from speech_recognition_jax.ops.viterbi_banded import (
        banded_arrays,
        banded_backtrace_tb,
        viterbi_banded_tb,
    )
    from speech_recognition_jax.utils.numerics import POS_INF

    s = ctx.sizes
    n_slots = 7
    cfg = FrontendConfig()
    bank = digit_bank()
    graph = connected_graph_arrays(bank, n_slots)
    bg = banded_arrays(graph)
    t = s.decode_frames
    n = (t - 1) * FRAME_STEP + cfg.frame_len
    sig = digit_audio(s.decode_batch, padded_length(cfg, n), seed=2)
    lens = np.full((s.decode_batch,), n, np.int32)
    slot = jnp.asarray(np.asarray(graph.slot, np.int32))
    label = jnp.asarray(np.asarray(graph.slot_label[graph.slot], np.int32))
    counts = np.bincount(np.asarray(graph.slot))
    max_words = min(t, t // int(counts[counts > 0].min()) + 1)
    ctx.say("decode", f"graph {graph.n_states} states, batch "
            f"{s.decode_batch} x {t} frames")

    @jax.jit
    def decode(bank, bg, signals, lengths):
        # production wav -> word ids: mfcc39_batch -> bank_nll ->
        # viterbi_banded_tb -> banded_backtrace_tb -> states_to_words_device
        feats, nf = mfcc39_batch(signals, lengths, cfg)
        states, eps, costs = _decode_banded_batch(bank, feats, nf, bg,
                                                  eps_depth=graph.eps_depth)
        words, n_words = states_to_words_device(slot, label, states, eps, nf,
                                                max_words=max_words)
        return words, n_words, costs

    args = (bank, bg, jnp.asarray(sig), jnp.asarray(lens))
    t0 = time.perf_counter()
    compiled = decode.lower(*args).compile()
    ctx.say("decode", f"compile {time.perf_counter() - t0:.2f} s (set-up)")
    mem = compiled.memory_analysis()
    ctx.say("decode", "memory_analysis " + (", ".join(
        f"{k} {getattr(mem, k):,}" for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(mem, k)) if mem is not None else "not reported"))
    compiled(*args)[2].block_until_ready()
    walls = []
    for _ in range(3):
        out, dt = _wall(lambda: compiled(*args))
        walls.append(dt)
    words, n_words, costs = (np.asarray(x) for x in out)
    audio_s = s.decode_batch * t * 0.01
    ctx.say("decode", f"wav -> word ids {np.median(walls) * 1e3:.2f} ms "
            f"wall (median of 3) = {audio_s / np.median(walls):.0f} "
            "audio-s/s")
    seqs = [words[i, :n_words[i]].tolist() for i in range(len(words))]
    if np.any(costs >= POS_INF / 2):
        raise PhaseFailure("decode: an utterance found no path")

    # the same function on the CPU
    cpu = ctx.ref_device
    with jax.default_device(cpu):
        ref = decode(*_on(cpu, args))
    r_words, r_n, r_costs = (np.asarray(x) for x in ref)
    r_seqs = [r_words[i, :r_n[i]].tolist() for i in range(len(r_words))]
    ties, rel = compare_decodes("decode vs CPU", seqs, costs, r_seqs, r_costs)
    ctx.say("decode", f"vs CPU: words identical on "
            f"{len(seqs) - ties}/{len(seqs)}, {ties} ties; max rel cost "
            f"err {rel:.3g} (tolerance {TOLERANCES['cost_rtol']:g})")

    # per-frame readings of the two scans at the full shape
    feats, nf = jax.jit(lambda x, l: mfcc39_batch(x, l, cfg))(
        args[2], args[3])
    nll = jax.jit(jax.vmap(lambda x, m: bank_nll(bank, x, jnp.arange(t) < m)))(
        feats, nf)
    nll_tb = jnp.transpose(nll, (1, 2, 0))[:, bg.bank_state, :]
    fwd = lambda: viterbi_banded_tb(nll_tb, bg, nf, eps_depth=graph.eps_depth)
    final, bp8, eps_u = jax.block_until_ready(fwd())
    end_costs = final[bg.end_states, :] + bg.end_bonus[:, None]
    ends = bg.end_states[jnp.argmin(end_costs, axis=0)]
    back = lambda: banded_backtrace_tb(bp8, eps_u, bg, ends, nf,
                                       eps_depth=graph.eps_depth)
    jax.block_until_ready(back())
    for name, fn in (("forward scan", fwd), ("backtrace scan", back)):
        ts = [_wall(fn)[1] for _ in range(5)]
        ctx.say("decode", f"{name}: {np.median(ts) / t * 1e6:.2f} us/frame "
                f"at {graph.n_states} x {s.decode_batch} x {t} "
                f"(median of 5, {np.median(ts) * 1e3:.2f} ms)")

    # the user entry point on the same features gives the same words
    seqs_api, costs_api = decode_connected(bank, graph, feats, nf)
    ties_api, _ = compare_decodes("decode_connected vs fused chain",
                                  seqs_api, costs_api, seqs, costs)
    ctx.say("decode", f"decode_connected entry point agrees ({ties_api} ties)")

    # float64 DP oracle on short utterances
    k, to = s.dp_oracle_utts, s.dp_oracle_frames
    sub_f = feats[:k, :to]
    sub_n = jnp.full((k,), to, jnp.int32)
    o_seqs, o_costs = decode_connected(bank, graph, sub_f, sub_n)
    emis = np.asarray(jax.vmap(lambda x: bank_nll(bank, x))(sub_f),
                      np.float64)[:, :, np.asarray(graph.bank_state)]
    model_trans = [np.where(np.asarray(bank.trans_cost[i]) >= POS_INF / 2,
                            np.inf, np.asarray(bank.trans_cost[i], np.float64))
                   for i in range(bank.n_models)]
    best, owords = zip(*(dp_oracle_words(graph, model_trans, n_slots, emis[i])
                         for i in range(k)))
    ties_o, rel_o = compare_decodes("decode vs float64 DP oracle", o_seqs,
                                    o_costs, list(owords), best,
                                    max_tie_share=1.0 / k)
    ctx.say("decode", f"vs float64 DP oracle on {k} x {to} frames: "
            f"{ties_o} ties, max rel cost err {rel_o:.3g}")
    _peak(ctx, "decode")


def phase_lextree(ctx: Ctx):
    import jax

    from speech_recognition_jax.ops.lattice import decode_lextree_bigram

    s = ctx.sizes
    bank, lexg, lm, words, unit_ids, means = lex_case(s.lex_words)
    feats = lex_features(words, unit_ids, means, s.lex_batch, s.lex_frames)
    nf = np.full((s.lex_batch,), s.lex_frames, np.int32)
    ctx.say("lextree", f"{lexg.n_words} words, {lexg.n_states} states, "
            f"batch {s.lex_batch} x {s.lex_frames} frames")
    t0 = time.perf_counter()
    decode_lextree_bigram(bank, lexg, lm, feats, nf)
    ctx.say("lextree", f"first call {time.perf_counter() - t0:.2f} s "
            "(set-up: compile + run)")
    t0 = time.perf_counter()
    seqs, costs = decode_lextree_bigram(bank, lexg, lm, feats, nf)
    ctx.say("lextree", f"decode_lextree_bigram {time.perf_counter() - t0:.3f}"
            " s wall (words on host)")
    cpu = ctx.ref_device
    with jax.default_device(cpu):
        r_seqs, r_costs = decode_lextree_bigram(_on(cpu, bank), lexg, lm,
                                                feats, nf)
    ties, rel = compare_decodes("lextree vs CPU", seqs, costs, r_seqs, r_costs)
    ctx.say("lextree", f"vs CPU: {len(seqs) - ties}/{len(seqs)} identical, "
            f"{ties} ties, max rel cost err {rel:.3g}")
    _peak(ctx, "lextree")


def phase_streaming(ctx: Ctx):
    import jax.numpy as jnp

    from speech_recognition_jax.config import FrontendConfig
    from speech_recognition_jax.decode.connected import decode_connected
    from speech_recognition_jax.decode.streaming import StreamingDecoder
    from speech_recognition_jax.models.graph import build_loop_graph
    from speech_recognition_jax.ops.frontend import mfcc39_batch, padded_length

    s = ctx.sizes
    cfg = FrontendConfig()
    bank = digit_bank()
    graph = build_loop_graph(
        [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)],
        word_insertion_cost=0.5)
    t = s.stream_frames
    n = (t - 1) * FRAME_STEP + cfg.frame_len
    sig = digit_audio(s.stream_batch, padded_length(cfg, n), seed=3)
    feats, nf = mfcc39_batch(jnp.asarray(sig),
                             jnp.full((s.stream_batch,), n, jnp.int32), cfg)
    feats = np.asarray(feats)
    # ragged lengths: every stream ends somewhere in its last chunks
    nf = np.asarray(nf) - np.arange(s.stream_batch) % min(2 * s.stream_chunk,
                                                          t // 2)
    mono_seqs, mono_costs = decode_connected(bank, graph, feats, nf)

    c = s.stream_chunk
    t0 = time.perf_counter()
    dec = StreamingDecoder(bank, graph, chunk_frames=c, batch=s.stream_batch)
    for start in range(0, t, c):
        buf = np.zeros((s.stream_batch, c, feats.shape[2]), np.float32)
        w = min(c, t - start)
        buf[:, :w] = feats[:, start:start + w]
        dec.push(buf, n_valid=np.clip(nf - start, 0, c).astype(np.int32))
    res = dec.finish()
    ctx.say("streaming", f"{s.stream_batch} streams x {t} frames in "
            f"{c}-frame chunks: {time.perf_counter() - t0:.2f} s wall "
            "(first run: includes compiles)")
    ties, rel = compare_decodes("chunked vs monolithic", [r[0] for r in res],
                                [r[2] for r in res], mono_seqs, mono_costs)
    ctx.say("streaming", f"chunked == monolithic: {ties} ties, max rel cost "
            f"err {rel:.3g}")

    inc_words, inc_costs, early = [], [], 0
    for i in range(s.incremental_streams):
        dec = StreamingDecoder(bank, graph, chunk_frames=c,
                               emit_incremental=True, window_chunks=4)
        pos, length = 0, int(nf[i])
        while pos < length:
            w = min(c, length - pos)
            buf = np.zeros((c, feats.shape[2]), np.float32)
            buf[:w] = feats[i, pos:pos + w]
            early += len(dec.push(buf, n_valid=w)[0])
            pos += w
        words, _, cost = dec.finish()
        inc_words.append(words)
        inc_costs.append(cost)
    k = s.incremental_streams
    ties_i, rel_i = compare_decodes("incremental vs monolithic", inc_words,
                                    inc_costs, mono_seqs[:k], mono_costs[:k],
                                    max_tie_share=1.0 / k)
    ctx.say("streaming", f"incremental == monolithic on {k} streams "
            f"({early} words emitted mid-stream): {ties_i} ties")
    _peak(ctx, "streaming")


def _cli(argv):
    """Run one CLI action; return its standard output."""
    from speech_recognition_jax.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _iteration_costs(ckpt_dir):
    from speech_recognition_jax.utils.checkpoint import load_bank

    return [float(load_bank(p)[1]["cost"])
            for p in sorted(glob.glob(os.path.join(ckpt_dir, "bank_*.npz")))]


def phase_em(ctx: Ctx):
    import jax

    s = ctx.sizes
    n_train, n_test, n_cont = s.em_corpus
    cpu = ctx.ref_device
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as d:
        def p(*parts):
            return os.path.join(d, *parts)

        t0 = time.perf_counter()
        _cli(["synth", "-o", p("data"), "--n-train", str(n_train),
              "--n-test", str(n_test), "--n-continuous", str(n_cont)])
        out = _cli(["isolated_train", "-i", p("data", "train"), "-o",
                    p("bank.npz"), "--n-states", "5", "--n-gaussians", "4"])
        acc = float(_cli(["isolated_test", "-i", p("bank.npz"), "-d",
                          p("data", "test")]).strip().splitlines()[-1])
        ctx.say("em", f"synth + isolated_train + isolated_test "
                f"{time.perf_counter() - t0:.2f} s wall, isolated accuracy "
                f"{acc:.3f}")
        for algo in ("hard", "soft"):
            runs = {}
            for where in ("device", "cpu"):
                ckpt = p(f"em-{algo}-{where}")
                argv = ["continuous_train", "-i", p("bank.npz"), "-o", ckpt,
                        "-d", p("data", "train"), "--iterations",
                        str(s.em_iterations), "--algo", algo]
                t0 = time.perf_counter()
                if where == "cpu":
                    with jax.default_device(cpu):
                        _cli(argv)
                else:
                    _cli(argv)
                runs[where] = _iteration_costs(ckpt)
                ctx.say("em", f"{algo} EM on {where}: "
                        f"{time.perf_counter() - t0:.2f} s wall, costs "
                        f"{runs[where]}")
            got, want = np.asarray(runs["device"]), np.asarray(runs["cpu"])
            _, rel = assert_close(f"{algo} EM costs vs CPU", got, want,
                                  rtol=TOLERANCES["em_cost_rtol"])
            slack = TOLERANCES["em_monotone_rtol"] * np.abs(got[:-1])
            if np.any(got[1:] > got[:-1] + slack):
                raise PhaseFailure(f"{algo} EM costs increase: {got.tolist()}")
            ctx.say("em", f"{algo} EM: costs non-increasing, max rel err vs "
                    f"CPU {rel:.3g} (tolerance {TOLERANCES['em_cost_rtol']:g})")
        last = sorted(glob.glob(p("em-hard-device", "bank_*.npz")))[-1]
        out = _cli(["connected_test", "-i", last, "-d", p("data", "test"),
                    "--graph", "loop", "--lm", "bigram"])
        wer = float([ln for ln in out.splitlines()
                     if ln.startswith("WER:")][0].split()[1])
        ctx.say("em", f"connected_test --graph loop --lm bigram: WER {wer:.3f}")
        if wer > 0.25:
            raise PhaseFailure(f"connected_test WER {wer} above the 0.25 the "
                               "CPU suite holds this corpus to")
        out = _cli(["stream", "-i", last, "-d", p("data", "test"),
                    "--incremental"])
        lines = [ln for ln in out.splitlines() if "mid-stream" in ln]
        if not lines:
            raise PhaseFailure("stream --incremental printed no results")
        ctx.say("em", f"stream --incremental: {len(lines)} files, e.g. "
                f"{lines[0]}")
    _peak(ctx, "em")


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def phase_sharded_em(ctx: Ctx):
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.models.graph import build_word_graph, pad_graphs
    from speech_recognition_jax.parallel.mesh import make_mesh
    from speech_recognition_jax.parallel.trainer import (
        make_sharded_embedded_step,
        shard_embedded_inputs,
    )
    from speech_recognition_jax.train.embedded_step import embedded_step

    s = ctx.sizes
    mesh = make_mesh(shape=(2, 2))
    # 11 digits + a silence model: the model axis splits the 12 banks
    bank = digit_bank(n_models=12, seed=4)
    trans = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
    rng = np.random.default_rng(5)
    graphs = [build_word_graph(trans, [[int(w)] for w in rng.integers(0, 12, 5)])
              for _ in range(s.multi_em_batch)]
    gb, eps_depth = pad_graphs(graphs)
    feats = rng.standard_normal(
        (s.multi_em_batch, s.multi_em_frames, 39)).astype(np.float32)
    nf = np.full((s.multi_em_batch,), s.multi_em_frames, np.int32)
    step = make_sharded_embedded_step(mesh, eps_depth=eps_depth,
                                      shard_models=True)
    args = shard_embedded_inputs(mesh, bank, feats, nf, gb, shard_models=True)
    t0 = time.perf_counter()
    jax.block_until_ready(step(*args))
    ctx.say("sharded_em", f"2x2 mesh, {s.multi_em_batch} x "
            f"{s.multi_em_frames}: first step {time.perf_counter() - t0:.2f} s"
            " (set-up)")
    (new_bank, stats), dt = _wall(lambda: step(*args))
    ctx.say("sharded_em", f"step {dt * 1e3:.2f} ms wall")
    one = jax.devices()[0]
    keys = ("trans", "eps_trans", "init_cost", "end_states", "bank_state")
    ref_bank, ref_stats = jax.jit(
        lambda b, f, n, g: embedded_step(b, f, n, g, eps_depth=eps_depth))(
        *_on(one, (bank, jnp.asarray(feats), jnp.asarray(nf),
                   {k: jnp.asarray(gb[k]) for k in keys})))
    _, rel = assert_close("sharded EM total cost", stats.total_cost,
                          ref_stats.total_cost,
                          rtol=TOLERANCES["sharded_rtol"])
    dists = {}
    for f in ("means", "log_vars", "log_weights"):
        a = np.asarray(getattr(new_bank, f), np.float64)
        b = np.asarray(getattr(ref_bank, f), np.float64)
        dists[f] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        if not np.isfinite(dists[f]) or (
                dists[f] > TOLERANCES["sharded_param_rel_l2"]):
            raise PhaseFailure(f"sharded EM {f}: relative L2 distance "
                               f"{dists[f]:.3g} to one card")
    ctx.say("sharded_em", f"vs one card: total cost rel err {rel:.3g}, "
            "parameter relative L2 " + ", ".join(
                f"{k} {v:.3g}" for k, v in dists.items()))


def phase_sharded_decode(ctx: Ctx):
    import jax
    import jax.numpy as jnp

    from speech_recognition_jax.models.hmm import bank_nll
    from speech_recognition_jax.models.lexgraph import lex_words_from_path
    from speech_recognition_jax.ops.viterbi_banded import (
        banded_backtrace,
        viterbi_banded,
    )
    from speech_recognition_jax.parallel.mesh import make_mesh
    from speech_recognition_jax.parallel.sharded_decode import (
        make_sharded_banded_viterbi,
        pad_banded_for_sharding,
    )

    s = ctx.sizes
    mesh = make_mesh(shape=(1, 4))
    bank, lexg, _, words, unit_ids, means = lex_case(s.lex_words)
    g = lexg.banded
    bgp, s_orig = pad_banded_for_sharding(g, 4)
    run = make_sharded_banded_viterbi(mesh, bgp, eps_depth=lexg.eps_depth)
    t = s.sharded_frames
    feats = lex_features(words, unit_ids, means, s.sharded_utts, t, seed=12)
    nll = np.asarray(jax.vmap(lambda x: bank_nll(bank, x))(jnp.asarray(feats)))
    nll = nll[:, :, np.asarray(g.bank_state)]
    ends = np.asarray(g.end_states)
    bonus = np.asarray(g.end_bonus)
    ctx.say("sharded_decode", f"{s_orig} states over 4 cards, "
            f"{s.sharded_utts} utterances x {t} frames")
    got_w, got_c, ref_w, ref_c = [], [], [], []
    for i in range(s.sharded_utts):
        pad = np.zeros((t, bgp.band.shape[1]), np.float32)
        pad[:, :s_orig] = nll[i]
        t0 = time.perf_counter()
        fin, bp8, eps_u = jax.block_until_ready(run(jnp.asarray(pad), t))
        if i < 2:
            ctx.say("sharded_decode", f"utt {i}: {time.perf_counter() - t0:.3f}"
                    " s wall" + (" (set-up: compile + run)" if i == 0 else ""))
        fin = np.asarray(fin)[:s_orig]
        e = int(ends[np.argmin(fin[ends] + bonus)])
        st, fl = banded_backtrace(bp8, eps_u, bgp, jnp.int32(e), jnp.int32(t),
                                  eps_depth=lexg.eps_depth)
        got_w.append(lex_words_from_path(lexg, np.asarray(st), t,
                                         np.asarray(fl)))
        got_c.append(float(np.min(fin[ends] + bonus)))
        # one card
        f1, b1, u1 = viterbi_banded(_on(jax.devices()[0], jnp.asarray(nll[i])),
                                    g, jnp.int32(t), eps_depth=lexg.eps_depth)
        f1 = np.asarray(f1)
        e1 = int(ends[np.argmin(f1[ends] + bonus)])
        st1, fl1 = banded_backtrace(b1, u1, g, jnp.int32(e1), jnp.int32(t),
                                    eps_depth=lexg.eps_depth)
        ref_w.append(lex_words_from_path(lexg, np.asarray(st1), t,
                                         np.asarray(fl1)))
        ref_c.append(float(np.min(f1[ends] + bonus)))
    ties, rel = compare_decodes("state-sharded vs one card", got_w, got_c,
                                ref_w, ref_c, rtol=TOLERANCES["sharded_rtol"],
                                max_tie_share=0.0)
    ctx.say("sharded_decode", f"vs one card: words identical, max rel cost "
            f"err {rel:.3g}")


def phase_sharded_bigram(ctx: Ctx):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from speech_recognition_jax.models.hmm import bank_nll
    from speech_recognition_jax.ops.lattice import (
        lattice_rescore,
        lattice_words_device,
        rescore_backoff,
        rescore_backoff_sliced,
        viterbi_lattice_tb,
    )
    from speech_recognition_jax.parallel.mesh import make_mesh

    s = ctx.sizes
    mesh = make_mesh(shape=(4, 1))
    bank, lexg, lm, words, unit_ids, means = lex_case(s.lex_words)
    g = lexg.banded
    t = s.lex_frames
    feats = lex_features(words, unit_ids, means, s.bigram_batch, t, seed=13)
    nf = np.full((s.bigram_batch,), t, np.int32)
    sliced = rescore_backoff_sliced(lm, lexg.leaf_word)
    bo, counts = (sliced if sliced is not None
                  else (rescore_backoff(lm, lexg.leaf_word), None))
    lw = jnp.asarray(lexg.leaf_word)
    lm_arrays = tuple(jnp.asarray(np.asarray(a, np.float32))
                      for a in (lm.cost, lm.start_cost, lm.end_cost))
    su = lexg.n_states // lexg.n_arcs
    max_words = min(t, t // su + 1)

    @jax.jit
    def bigram_decode(feats, nf):
        nll = jax.vmap(lambda x, n: bank_nll(bank, x, jnp.arange(t) < n))(
            feats, nf)
        nll_tb = jnp.transpose(nll, (1, 2, 0))[:, g.bank_state, :]
        _, ends_cost, ends_tau = viterbi_lattice_tb(nll_tb, g, nf)
        res = lattice_rescore(ends_cost, ends_tau, lw, *lm_arrays, nf,
                              backoff=bo, backoff_counts=counts)
        leaves, n_words = lattice_words_device(
            res.pred_w, res.ends_tau, res.best_leaf, nf, max_words=max_words,
            lane_invperm=res.lane_invperm)
        return leaves, n_words, res.cost

    def seqs(out):
        leaves, n_words, cost = (np.asarray(x) for x in out)
        lwn = np.asarray(lexg.leaf_word)
        return ([lwn[leaves[:n_words[i], i][::-1]].tolist()
                 for i in range(leaves.shape[1])], cost)

    data = NamedSharding(mesh, P("data"))
    args = (jax.device_put(jnp.asarray(feats),
                           NamedSharding(mesh, P("data", None, None))),
            jax.device_put(jnp.asarray(nf), data))
    t0 = time.perf_counter()
    with mesh:
        jax.block_until_ready(bigram_decode(*args))
        ctx.say("sharded_bigram", f"{s.bigram_batch} streams over 4 cards: "
                f"first call {time.perf_counter() - t0:.2f} s (set-up)")
        out, dt = _wall(lambda: bigram_decode(*args))
    ctx.say("sharded_bigram", f"{s.bigram_batch} x {t} in {dt * 1e3:.2f} ms "
            "wall")
    one = jax.devices()[0]
    ref = bigram_decode(*_on(one, (jnp.asarray(feats), jnp.asarray(nf))))
    (w, c), (rw, rc) = seqs(out), seqs(ref)
    ties, rel = compare_decodes("data-sharded bigram vs one card", w, c, rw,
                                rc, rtol=TOLERANCES["sharded_rtol"])
    ctx.say("sharded_bigram", f"vs one card: {ties} ties, max rel cost err "
            f"{rel:.3g}")


ONE_CARD = (("frontend", phase_frontend), ("decode", phase_decode),
            ("lextree", phase_lextree), ("streaming", phase_streaming),
            ("em", phase_em))
FOUR_CARDS = (("sharded_em", phase_sharded_em),
              ("sharded_decode", phase_sharded_decode),
              ("sharded_bigram", phase_sharded_bigram))


def select_phases(four_cards: bool):
    """``(cards needed, phases)`` for the chosen mode."""
    return (4, FOUR_CARDS) if four_cards else (1, ONE_CARD)


def run_phases(ctx: Ctx, phases) -> list:
    """Run every phase; return the names of those that failed (each
    failure's traceback goes to stderr)."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(ctx)
        except Exception:  # reported below and fails the run
            traceback.print_exc()
            failed.append(name)
            ctx.say(name, "FAILED")
        else:
            ctx.say(name, f"ok ({time.perf_counter() - t0:.1f} s)")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths of parallel/")
    args = ap.parse_args(argv)
    n_cards, phases = select_phases(args.four_cards)

    devices = require_gpu(n_cards)[:n_cards]
    import jax

    from speech_recognition_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    tag = card_tag()
    print(f"card: {tag}", flush=True)
    print(f"[{tag}] jax {jax.__version__}, devices {devices}", flush=True)
    ctx = Ctx(sizes=FULL, tag=tag, ref_device=jax.devices("cpu")[0])
    failed = run_phases(ctx, phases)
    if failed:
        print(f"chip_smoke: phases failed: {', '.join(failed)}",
              file=sys.stderr, flush=True)
        return 1
    print(last_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
