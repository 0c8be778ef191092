"""Command-line interface.

Mirrors the reference CLI's actions — ``isolated_train``,
``isolated_test``, ``record``, ``continuous_train``
(``/root/reference/cli.py:8-10``) — plus ``connected_test`` (the
reference's separate ``main.py`` script) and ``synth`` (generate the
deterministic synthetic Aurora-style corpus, since the original data is
private).  Unlike the reference there are no hard-coded absolute data
paths (``config.py:2``) or CWD-relative cache dirs; everything is a
flag.

Run:  python -m speech_recognition_jax.cli ACTION [flags]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

import numpy as np

from speech_recognition_jax.config import (
    DIGIT_NAMES,
    DecodeConfig,
    FrontendConfig,
    HMMConfig,
    TrainConfig,
)


def _featurize_files(paths, cfg: FrontendConfig, cap_samples: int,
                     norm: str = "utterance", cmvn=None, chunk: int = 512):
    """Wavs -> features, one batched jit over the whole file list.

    The frontend config adapts to the files' actual sample rate (the
    reference passes the wav's rate to psf.mfcc, sr/core.py:39-40; Aurora
    data is 8 kHz).  norm='utterance' (reference parity) or 'cmvn' (raw
    features; pass cmvn=(mean, std) to apply corpus stats, None to get
    raw features for stats estimation)."""
    import dataclasses

    import jax.numpy as jnp

    from speech_recognition_jax.ops.frontend import apply_cmvn, mfcc39_batch, padded_length
    from speech_recognition_jax.runtime.loader import (
        PrefetchWavBatches,
        load_wav_batch,
    )

    paths = list(paths)
    # Large corpora stream through the prefetching input pipeline: the
    # C++ thread-pool loader reads batch k+1 from disk while batch k
    # featurizes on-device (uniform chunk size keeps one compiled
    # shape; the tail chunk zero-pads and its outputs are dropped).
    if len(paths) > chunk:
        feats_all, lens_all = [], []
        pad = (-len(paths)) % chunk
        padded_paths = paths + [paths[0]] * pad
        for cpaths, samples, lengths, rates in PrefetchWavBatches(
                padded_paths, chunk, cap_samples):
            f, l = _featurize_loaded(samples, lengths, rates, cfg,
                                     cap_samples, norm, cmvn)
            feats_all.extend(f)
            lens_all.extend(l)
        return feats_all[: len(paths)], lens_all[: len(paths)]

    # native batched IO (C++ thread pool; scipy fallback)
    samples, lengths, rates = load_wav_batch(paths, cap_samples)
    return _featurize_loaded(samples, lengths, rates, cfg, cap_samples,
                             norm, cmvn)


def _featurize_loaded(samples, lengths, rates, cfg, cap_samples, norm, cmvn):
    import dataclasses

    import jax.numpy as jnp

    from speech_recognition_jax.ops.frontend import apply_cmvn, mfcc39_batch, padded_length
    b = samples.shape[0]
    rate = int(rates[0]) if len(rates) else cfg.sample_rate
    if np.any(rates[:b] != rate):
        raise ValueError(f"mixed sample rates in batch: {sorted(set(rates.tolist()))}")
    if rate != cfg.sample_rate:
        cfg = dataclasses.replace(cfg, sample_rate=rate)
    L = padded_length(cfg, cap_samples)
    if L > samples.shape[1]:
        samples = np.pad(samples, ((0, 0), (0, L - samples.shape[1])))
    else:
        samples = samples[:, :L]

    mode = "utterance" if norm == "utterance" else "none"
    fb, nfb = mfcc39_batch(
        jnp.asarray(samples), jnp.asarray(np.minimum(lengths, cap_samples), np.int32),
        cfg, None, mode,
    )
    if norm == "cmvn" and cmvn is not None:
        fb = apply_cmvn(fb, nfb, jnp.asarray(cmvn[0]), jnp.asarray(cmvn[1]))
    fb = np.asarray(fb)
    lens = [int(n) for n in np.asarray(nfb)]
    return [fb[i] for i in range(b)], lens


def _featurize_arrays(sample_arrays, cfg: FrontendConfig, cap_samples: int,
                      norm: str = "utterance", cmvn=None):
    """Like :func:`_featurize_files` but for in-memory sample arrays."""
    import jax.numpy as jnp

    from speech_recognition_jax.ops.frontend import apply_cmvn, mfcc39_batch, padded_length

    L = padded_length(cfg, cap_samples)
    b = len(sample_arrays)
    buf = np.zeros((b, L), np.float32)
    lens = np.zeros((b,), np.int32)
    for i, seg in enumerate(sample_arrays):
        n = min(len(seg), L)
        buf[i, :n] = seg[:n]
        lens[i] = n
    mode = "utterance" if norm == "utterance" else "none"
    fb, nfb = mfcc39_batch(jnp.asarray(buf), jnp.asarray(lens), cfg, None, mode)
    if norm == "cmvn" and cmvn is not None:
        fb = apply_cmvn(fb, nfb, jnp.asarray(cmvn[0]), jnp.asarray(cmvn[1]))
    fb = np.asarray(fb)
    return [fb[i] for i in range(b)], [int(n) for n in np.asarray(nfb)]


def _norm_from_meta(meta):
    """(norm, cmvn) from a bank's metadata."""
    norm = meta.get("norm", "utterance")
    cmvn = None
    if norm == "cmvn":
        arrs = meta.get("arrays", {})
        cmvn = (arrs["cmvn_mean"], arrs["cmvn_std"])
    return norm, cmvn


def _stack(feats, lens, dim=39):
    tmax = max(lens)
    fb = np.zeros((len(feats), tmax, dim), np.float32)
    for i, f in enumerate(feats):
        fb[i, : lens[i]] = f[: lens[i]]
    return fb, np.asarray(lens, np.int32)


def cmd_synth(args):
    from speech_recognition_jax.data.synthetic import SyntheticDigits
    from speech_recognition_jax.data.wav import write_wav

    gen = SyntheticDigits(seed=args.seed)
    os.makedirs(os.path.join(args.output, "train"), exist_ok=True)
    os.makedirs(os.path.join(args.output, "test"), exist_ok=True)
    for u in gen.isolated_corpus(args.n_train, tag="train"):
        write_wav(os.path.join(args.output, "train", u.name), u.samples)
    for u in gen.isolated_corpus(args.n_test, tag="test"):
        write_wav(os.path.join(args.output, "test", u.name), u.samples)
    for u in gen.continuous_corpus(args.n_continuous, tag="cont"):
        write_wav(os.path.join(args.output, "train", u.name), u.samples)
    for u in gen.continuous_corpus(max(args.n_continuous // 4, 1), tag="ctest"):
        write_wav(os.path.join(args.output, "test", u.name), u.samples)
    print(f"wrote corpus under {args.output}/")


def cmd_isolated_train(args):
    import jax

    from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
    from speech_recognition_jax.train.isolated import fit_hmm
    from speech_recognition_jax.utils.checkpoint import save_bank

    cfg = FrontendConfig()
    hmm_cfg = HMMConfig(n_states=args.n_states, n_mix=args.n_gaussians)
    train_cfg = TrainConfig()

    by_digit_files = {}
    for d, name in enumerate(DIGIT_NAMES):
        pattern = re.compile("[A-Z]+_" + name + "[AB].wav")  # cli.py:27
        files = sorted(
            f for f in glob.glob(os.path.join(args.input, "*.wav"))
            if pattern.match(os.path.basename(f))
        )
        if not files:
            sys.exit(f"no training files for digit {name} under {args.input}")
        by_digit_files[d] = files

    cmvn = None
    if args.norm == "cmvn":
        from speech_recognition_jax.ops.frontend import cmvn_stats

        all_files = [f for fs in by_digit_files.values() for f in fs]
        raw, lens = _featurize_files(all_files, cfg, args.max_samples, norm="cmvn")
        tmax = max(lens)
        fb = np.zeros((len(raw), tmax, 39), np.float32)
        for i, f in enumerate(raw):
            fb[i, : lens[i]] = f[: lens[i]]
        m, sd = cmvn_stats(fb, np.asarray(lens, np.int32))
        cmvn = (np.asarray(m), np.asarray(sd))

    all_temps = {}
    for d in by_digit_files:
        feats, lens = _featurize_files(by_digit_files[d], cfg, args.max_samples,
                                       norm=args.norm, cmvn=cmvn)
        all_temps[d] = [f[:n].astype(np.float64) for f, n in zip(feats, lens)]
    pad_to = max(max(t.shape[0] for t in ts) for ts in all_temps.values())
    models = []
    for d, name in enumerate(DIGIT_NAMES):
        print(f"training {name} on {len(all_temps[d])} files")
        if args.gmm:
            models.append(
                fit_hmm(
                    jax.random.PRNGKey(train_cfg.seed + d),
                    all_temps[d],
                    use_em=args.em,
                    train_cfg=train_cfg,
                    hmm_cfg=hmm_cfg,
                    pad_to=pad_to,
                )
            )
        else:
            # reference use_gmm=False: segmental K-means templates scored
            # by mahalanobis DTW == a single-Gaussian (M=1) bank
            import jax.numpy as jnp

            from speech_recognition_jax.decode.dtw import fit_template

            m, v, t = fit_template(all_temps[d], hmm_cfg.n_states, pad_to=pad_to)
            models.append(
                GMMHMM(
                    means=jnp.asarray(m[:, None, :], jnp.float32),
                    log_vars=jnp.log(jnp.asarray(v[:, None, :], jnp.float32)),
                    log_weights=jnp.zeros((hmm_cfg.n_states, 1), jnp.float32),
                    trans_cost=jnp.asarray(t),
                )
            )

    meta = {"kind": "isolated" if args.gmm else "template",
            "n_mix": args.n_gaussians if args.gmm else 1, "norm": args.norm}
    arrays = {}
    if cmvn is not None:
        arrays = {"cmvn_mean": cmvn[0], "cmvn_std": cmvn[1]}
    if args.silence:
        from speech_recognition_jax.runtime.loader import load_wav_batch
        from speech_recognition_jax.ops.frontend import padded_length as _pl
        from speech_recognition_jax.train.silence import (
            fit_silence_hmm,
            harvest_silence_samples,
        )

        all_files = [f for fs in by_digit_files.values() for f in fs]
        L = _pl(cfg, args.max_samples)
        samples, lengths, _ = load_wav_batch(all_files, L)
        segs = harvest_silence_samples(
            [samples[i, : lengths[i]] for i in range(len(all_files))]
        )
        sil_frames = [
            f[:n]
            for f, n in zip(*_featurize_arrays(segs, cfg, args.max_samples,
                                               norm=args.norm, cmvn=cmvn))
        ]
        if sil_frames:
            sil = fit_silence_hmm(
                jax.random.PRNGKey(4242), np.concatenate(sil_frames),
                n_states=args.n_states, n_mix=min(args.n_gaussians, 2),
                hmm_cfg=hmm_cfg,
            )
            models.append(sil)
            meta["silence_index"] = len(models) - 1
            print(f"trained silence model from {len(sil_frames)} segments")

    bank = HMMBank.stack(models)
    save_bank(args.output, bank, meta, arrays=arrays)
    print(f"saved bank to {args.output}")


def cmd_isolated_test(args):
    import jax.numpy as jnp

    from speech_recognition_jax.decode.isolated import classify_batch
    from speech_recognition_jax.utils.checkpoint import load_bank

    cfg = FrontendConfig()
    bank, meta = load_bank(args.input)
    norm, cmvn = _norm_from_meta(meta)
    sil = meta.get("silence_index")
    if sil is not None:
        bank = type(bank)(*[f[:sil] for f in bank])  # classify over digits only
    files, labels = [], []
    for d, name in enumerate(DIGIT_NAMES):
        pattern = re.compile("[A-Z]+_" + name + "[AB].wav")
        for f in sorted(glob.glob(os.path.join(args.data, "*.wav"))):
            if pattern.match(os.path.basename(f)):
                files.append(f)
                labels.append(d)
    feats, lens = _featurize_files(files, cfg, args.max_samples, norm=norm, cmvn=cmvn)
    fb, nb = _stack(feats, lens)
    pred, costs = classify_batch(bank, jnp.asarray(fb), jnp.asarray(nb))
    pred = np.asarray(pred)
    for f, p, l in zip(files, pred, labels):
        if p != l:
            print(f"Digit: {DIGIT_NAMES[l]} is wrong ({os.path.basename(f)} -> {DIGIT_NAMES[p]})")
    acc = float(np.mean(pred == np.asarray(labels)))
    print(acc)


def cmd_continuous_train(args):
    import jax

    from speech_recognition_jax.data.aurora import (
        labels_from_transcript,
        transcript_from_filename,
    )
    from speech_recognition_jax.models.graph import pad_graphs, transcript_graph
    from speech_recognition_jax.train.embedded_step import embedded_step, embedded_step_soft
    from speech_recognition_jax.utils.checkpoint import (
        latest_iteration,
        load_bank,
        save_iteration,
    )

    import jax.numpy as jnp

    cfg = FrontendConfig()
    start_it = 0
    it_found, ckpt = latest_iteration(args.output)
    if ckpt:
        print(f"resuming from {ckpt}")
        bank, meta = load_bank(ckpt)
        start_it = it_found + 1
    else:
        bank, meta = load_bank(args.input)
    norm, cmvn = _norm_from_meta(meta)

    files = sorted(glob.glob(os.path.join(args.data, "*.wav")))
    files = [f for f in files if transcript_from_filename(os.path.basename(f))]
    labels = [
        labels_from_transcript(transcript_from_filename(os.path.basename(f)))
        for f in files
    ]
    feats, lens = _featurize_files(files, cfg, args.max_samples, norm=norm, cmvn=cmvn)
    fb, nb = _stack(feats, lens)

    sil = meta.get("silence_index")
    if sil is not None:
        print(f"using optional silence arcs (model {sil}) in alignment graphs")
    for it in range(start_it, start_it + args.iterations):
        trans_np = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
        graphs = [transcript_graph(trans_np, ls, sil=sil) for ls in labels]
        gb, eps_depth = pad_graphs(graphs)
        keys = ("trans", "eps_trans", "init_cost", "end_states", "bank_state")
        if args.algo == "soft":
            keys = keys + ("end_scores",)
        g = {k: jnp.asarray(gb[k]) for k in keys}
        step_fn = embedded_step_soft if args.algo == "soft" else embedded_step
        new_bank, stats = step_fn(
            bank, jnp.asarray(fb), jnp.asarray(nb), g, eps_depth=eps_depth
        )
        cost = float(stats.total_cost)
        print(f"iteration {it}: total alignment cost {cost:.1f}")
        from speech_recognition_jax.utils.checkpoint import save_bank as _sb
        import os as _os

        _sb(_os.path.join(args.output, f"bank_{it:05d}.npz"), new_bank,
            {**{k: v for k, v in meta.items() if k != "arrays"},
             "iteration": it, "cost": cost},
            arrays=meta.get("arrays", {}))
        converged = all(
            np.allclose(np.asarray(getattr(new_bank, f)), np.asarray(getattr(bank, f)),
                        rtol=1e-5, atol=1e-8)
            for f in ("means", "log_vars", "log_weights")
        )
        bank = new_bank
        if converged:
            print("continuous training converged")
            break


def cmd_connected_test(args):
    from speech_recognition_jax.data.aurora import (
        labels_from_transcript,
        transcript_from_filename,
    )
    from speech_recognition_jax.decode.connected import decode_connected
    from speech_recognition_jax.langmodel.bigram import fit_bigram, uniform_bigram
    from speech_recognition_jax.models.graph import build_loop_graph, build_word_graph
    from speech_recognition_jax.utils.checkpoint import load_bank
    from speech_recognition_jax.utils.metrics import (
        positional_digit_accuracy,
        sequence_accuracy,
        wer,
    )

    cfg = FrontendConfig()
    bank, meta = load_bank(args.input)
    norm, cmvn = _norm_from_meta(meta)
    sil = meta.get("silence_index")
    files = sorted(glob.glob(os.path.join(args.data, "*.wav")))
    files = [f for f in files if transcript_from_filename(os.path.basename(f))]
    refs = [
        labels_from_transcript(transcript_from_filename(os.path.basename(f)))
        for f in files
    ]
    feats, lens = _featurize_files(files, cfg, args.max_samples, norm=norm, cmvn=cmvn)
    fb, nb = _stack(feats, lens)

    trans_np = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
    drop = {sil} if sil is not None else None
    lm = None
    if args.lm == "bigram":
        from speech_recognition_jax.langmodel.bigram import scale

        if args.lm_train:
            lm_files = sorted(glob.glob(os.path.join(args.lm_train, "*.wav")))
            lm_seqs = [
                labels_from_transcript(transcript_from_filename(os.path.basename(f)))
                for f in lm_files
                if transcript_from_filename(os.path.basename(f))
            ]
        else:
            print("WARNING: --lm-train not given; fitting the bigram on the "
                  "test transcripts themselves (evaluation is optimistic)")
            lm_seqs = refs
        lm = scale(fit_bigram(lm_seqs, bank.n_models), args.lm_weight)
        if sil is not None:
            # the silence arc must be LM-transparent: entering/leaving
            # silence should not spend a word-transition probability
            lm.cost[sil, :] = 0.0
            lm.cost[:, sil] = 0.0
            lm.start_cost[sil] = 0.0
            lm.end_cost[sil] = 0.0
    conf_graph = conf_states = conf_eps = None
    if args.graph == "loop":
        graph = build_loop_graph(trans_np, lm=lm,
                                 word_insertion_cost=args.word_insertion_cost)
        hyps, _ = decode_connected(bank, graph, fb, nb, drop_labels=drop)
        if getattr(args, "confidence", False):
            conf_graph = graph
    elif args.graph == "lextree":
        # the large-vocabulary production decoder (models/lexgraph.py);
        # on the flat digit vocabulary it is provably identical to the
        # loop graph
        from speech_recognition_jax.decode.lextree import decode_lextree
        from speech_recognition_jax.models.lexgraph import build_lex_graph

        symbols = [chr(ord("0") + i) if i < 10 else chr(ord("A") + i - 10)
                   for i in range(bank.n_models)]
        decoder = getattr(args, "decoder", "auto")
        use_lattice = (lm is not None and
                       (decoder == "lattice"
                        or (decoder == "auto"
                            and any(len(s) > 1 for s in symbols))))
        if decoder == "lattice" and lm is None:
            sys.exit("--decoder lattice needs --lm bigram")
        if use_lattice:
            # production deep-tree path: no-LM pass-1 lattice + exact
            # bigram rescoring (ops/lattice.py) — composing the bigram
            # onto the graph only works on flat vocabularies
            from speech_recognition_jax.ops.lattice import (
                decode_lextree_bigram,
            )

            lexg = build_lex_graph(
                symbols, trans_np, {s: i for i, s in enumerate(symbols)},
                word_insertion_cost=args.word_insertion_cost)
            hyps, _ = decode_lextree_bigram(bank, lexg, lm, fb, nb)
        else:
            lexg = build_lex_graph(
                symbols, trans_np, {s: i for i, s in enumerate(symbols)},
                lm=lm, word_insertion_cost=args.word_insertion_cost)
            hyps, _ = decode_lextree(bank, lexg, fb, nb)
        if sil is not None:
            hyps = [[w for w in h if w != sil] for h in hyps]
    else:
        # one graph + one batched decode per DISTINCT slot count — a
        # compile per length group instead of per utterance (the round-1
        # form decoded one utterance at a time)
        vocab = [i for i in range(bank.n_models) if i != sil]
        by_slots = {}
        for i, r in enumerate(refs):
            by_slots.setdefault(args.n_slots or len(r), []).append(i)
        hyps = [None] * len(refs)
        for n_slots, idxs in sorted(by_slots.items()):
            graph = build_word_graph(trans_np, [vocab] * n_slots, lm=lm)
            sel = np.asarray(idxs)
            hs, _ = decode_connected(bank, graph, fb[sel], nb[sel],
                                     drop_labels=drop)
            for i, h in zip(idxs, hs):
                hyps[i] = h

    for h, r, f in zip(hyps, refs, files):
        tag = "Correct" if h == r else "Incorrect"
        print(f"{tag}: {[DIGIT_NAMES[x] for x in h]} ref {[DIGIT_NAMES[x] for x in r]}")
    if conf_graph is not None:
        # per-word frame-posterior confidence (decode/confidence.py):
        # re-derive the Viterbi path + banded-FB posteriors in one
        # batched device pass over the same graph
        import jax.numpy as jnp

        from speech_recognition_jax.decode.confidence import (
            path_posteriors,
            word_confidence,
        )
        from speech_recognition_jax.decode.connected import (
            _decode_banded_batch,
        )
        from speech_recognition_jax.ops.viterbi_banded import banded_arrays

        bg = banded_arrays(conf_graph)
        states, eps_flags, _ = _decode_banded_batch(
            bank, jnp.asarray(fb), jnp.asarray(nb), bg,
            eps_depth=conf_graph.eps_depth)
        post = np.asarray(path_posteriors(bank, bg, jnp.asarray(fb),
                                          jnp.asarray(nb), states,
                                          eps_depth=conf_graph.eps_depth))
        states = np.asarray(states)
        eps_flags = np.asarray(eps_flags)
        for i, f in enumerate(files):
            wc = word_confidence(conf_graph, states[i], eps_flags[i],
                                 post[i], int(nb[i]))
            pretty = " ".join(f"{DIGIT_NAMES[w] if w < len(DIGIT_NAMES) else 'sil'}:{c:.3f}"
                              for w, c in wc)
            print(f"confidence {os.path.basename(f)}: {pretty}")
    print("Sequence accuracy:", sequence_accuracy(hyps, refs))
    print("Digit accuracy:", positional_digit_accuracy(hyps, refs))
    print("WER:", wer(hyps, refs))


def cmd_align(args):
    """Forced alignment: per-utterance word segmentation with times."""
    import json

    import jax.numpy as jnp

    from speech_recognition_jax.data.aurora import (
        labels_from_transcript,
        transcript_from_filename,
    )
    from speech_recognition_jax.models.graph import pad_graphs, transcript_graph
    from speech_recognition_jax.train.continuous import align_batch
    from speech_recognition_jax.utils.checkpoint import load_bank

    cfg = FrontendConfig()
    bank, meta = load_bank(args.input)
    norm, cmvn = _norm_from_meta(meta)
    sil = meta.get("silence_index")
    files = sorted(glob.glob(os.path.join(args.data, "*.wav")))
    files = [f for f in files if transcript_from_filename(os.path.basename(f))]
    labels = [
        labels_from_transcript(transcript_from_filename(os.path.basename(f)))
        for f in files
    ]
    feats, lens = _featurize_files(files, cfg, args.max_samples, norm=norm, cmvn=cmvn)
    fb, nb = _stack(feats, lens)

    trans_np = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
    graphs = [transcript_graph(trans_np, ls, sil=sil) for ls in labels]
    gb, eps_depth = pad_graphs(graphs)
    g = {k: jnp.asarray(gb[k]) for k in
         ("trans", "eps_trans", "init_cost", "end_states", "bank_state")}
    ids, costs = align_batch(
        bank, jnp.asarray(fb), jnp.asarray(nb),
        g["trans"], g["eps_trans"], g["init_cost"], g["end_states"],
        g["bank_state"], eps_depth=eps_depth,
    )
    ids = np.asarray(ids)
    step_s = cfg.frame_step_s
    s_per_model = bank.n_states
    with open(args.output, "w") as out:
        for i, f in enumerate(files):
            # contiguous runs of model id -> word segments; a repeated
            # word ("44") shows as the state index dropping within the
            # same model, so split on that too
            valid = ids[i, : int(nb[i])]
            mids = valid // s_per_model
            sids = valid % s_per_model
            segs = []
            start = 0
            for t in range(1, len(mids) + 1):
                if (t == len(mids) or mids[t] != mids[start]
                        or sids[t] < sids[t - 1]):
                    m = int(mids[start])
                    name = DIGIT_NAMES[m] if m < len(DIGIT_NAMES) else "sil"
                    segs.append({
                        "word": name,
                        "start_s": round(start * step_s, 3),
                        "end_s": round(t * step_s, 3),
                    })
                    start = t
            out.write(json.dumps({
                "file": os.path.basename(f),
                "cost": float(costs[i]),
                "segments": segs,
            }) + "\n")
    print(f"wrote alignments for {len(files)} files to {args.output}")


def cmd_spellcheck(args):
    """Correct text against a dictionary (the reference's lextree +
    text-Viterbi subsystem, ``sr/langmodel/spellchecker.py:15-135``,
    with the fit/spell_check stubs implemented)."""
    from speech_recognition_jax.langmodel.spellcheck import SpellChecker

    with open(args.dict) as f:
        words = [ln.strip().lower() for ln in f if ln.strip()]
    # accept the reference's CSV-with-header format (tests/test_data/dict1.txt)
    if words and words[0] == "words":
        words = words[1:]
    if not words:
        sys.exit(f"dictionary {args.dict} contains no words")
    sc = SpellChecker().fit(words)
    if args.text is not None:
        text = args.text
    elif args.file:
        with open(args.file) as f:
            text = f.read()
    else:
        text = sys.stdin.read()
    for line in text.splitlines():
        line = line.strip().lower()
        if line:
            print(sc.spell_check(line))


def cmd_stream(args):
    """Streaming decode: push fixed-size feature chunks through the
    carried-frontier :class:`~speech_recognition_jax.decode.streaming.
    StreamingDecoder` (the long-audio serving path) instead of decoding
    utterances whole.  ``--incremental`` turns on bounded-memory
    mid-stream word emission (path-immortality flushes); words are
    printed as soon as they become immortal, the rest at finish."""
    from speech_recognition_jax.decode.streaming import StreamingDecoder
    from speech_recognition_jax.models.graph import build_loop_graph
    from speech_recognition_jax.utils.checkpoint import load_bank

    cfg = FrontendConfig()
    bank, meta = load_bank(args.input)
    norm, cmvn = _norm_from_meta(meta)
    files = sorted(glob.glob(os.path.join(args.data, "*.wav")))
    if not files:
        sys.exit(f"no wavs under {args.data}")
    feats, lens = _featurize_files(files, cfg, args.max_samples, norm=norm,
                                   cmvn=cmvn)
    fb, nb = _stack(feats, lens)

    trans_np = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
    if args.graph == "lextree":
        from speech_recognition_jax.models.lexgraph import build_lex_graph

        symbols = [chr(ord("0") + i) if i < 10 else chr(ord("A") + i - 10)
                   for i in range(bank.n_models)]
        graph = build_lex_graph(
            symbols, trans_np, {s: i for i, s in enumerate(symbols)},
            word_insertion_cost=args.word_insertion_cost)
    else:
        graph = build_loop_graph(
            trans_np, word_insertion_cost=args.word_insertion_cost)

    chunk = args.chunk_frames
    d = fb.shape[2]

    def name(w):
        return DIGIT_NAMES[w] if w < len(DIGIT_NAMES) else "sil"

    if args.incremental:
        # incremental emission needs full-width pushes per stream, so
        # ragged-length files stream one decoder each (batch=1)
        for i, f in enumerate(files):
            dec = StreamingDecoder(bank, graph, chunk_frames=chunk,
                                   emit_incremental=True,
                                   window_chunks=args.window_chunks)
            early = []
            t, L = 0, int(nb[i])
            while t < L:
                c = min(chunk, L - t)
                buf = np.zeros((chunk, d), np.float32)
                buf[:c] = fb[i, t : t + c]
                early.extend(dec.push(buf, n_valid=c)[0])
                t += c
            words, _, cost = dec.finish()
            print(f"{os.path.basename(f)}: {[name(w) for w in words]} "
                  f"({len(early)}/{len(words)} words emitted mid-stream, "
                  f"cost {cost:.1f})")
    else:
        dec = StreamingDecoder(bank, graph, chunk_frames=chunk,
                               batch=len(files))
        t_max = int(nb.max())
        t = 0
        while t < t_max:
            nv = np.clip(nb - t, 0, chunk).astype(np.int32)
            c = min(chunk, t_max - t)
            buf = np.zeros((len(files), chunk, d), np.float32)
            buf[:, :c] = fb[:, t : t + c]
            dec.push(buf, n_valid=nv)
            t += chunk
        results = dec.finish()
        if len(files) == 1:
            results = [results]
        for f, (words, _, cost) in zip(files, results):
            print(f"{os.path.basename(f)}: {[name(w) for w in words]} "
                  f"(cost {cost:.1f})")


def cmd_record(args):
    from speech_recognition_jax.data.capture import record

    record(args.output_wav)
    print(f"wrote {args.output_wav}")
    if args.input:
        import jax.numpy as jnp

        from speech_recognition_jax.decode.isolated import classify_batch
        from speech_recognition_jax.utils.checkpoint import load_bank

        cfg = FrontendConfig()
        bank, _ = load_bank(args.input)
        feats, lens = _featurize_files([args.output_wav], cfg, args.max_samples)
        fb, nb = _stack(feats, lens)
        pred, _ = classify_batch(bank, jnp.asarray(fb), jnp.asarray(nb))
        print("recognized:", DIGIT_NAMES[int(pred[0])])


def main(argv=None):
    ap = argparse.ArgumentParser(description="Classical digit ASR in JAX")
    sub = ap.add_subparsers(dest="action", required=True)

    p = sub.add_parser("synth", help="generate synthetic Aurora-style corpus")
    p.add_argument("-o", "--output", default="data")
    p.add_argument("--n-train", type=int, default=6)
    p.add_argument("--n-test", type=int, default=3)
    p.add_argument("--n-continuous", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("isolated_train")
    p.add_argument("-i", "--input", required=True, help="wav dir")
    p.add_argument("-o", "--output", default="models/bank.npz")
    p.add_argument("-g", "--gmm", action=argparse.BooleanOptionalAction, default=True,
                   help="GMM-HMM models (--no-gmm: single-Gaussian segmental "
                        "K-means templates, the reference's DTW path)")
    p.add_argument("-e", "--em", action=argparse.BooleanOptionalAction, default=True,
                   help="refine mixtures with EM (--no-em: k-means only)")
    p.add_argument("--n-states", type=int, default=5)
    p.add_argument("--n-gaussians", type=int, default=4)
    p.add_argument("--max-samples", type=int, default=64000)
    p.add_argument("--norm", choices=["utterance", "cmvn"], default="utterance",
                   help="per-utterance z-norm (reference parity) or corpus CMVN")
    p.add_argument("--silence", action="store_true",
                   help="train a silence model from non-speech regions")
    p.set_defaults(fn=cmd_isolated_train)

    p = sub.add_parser("isolated_test")
    p.add_argument("-i", "--input", required=True, help="bank .npz")
    p.add_argument("-d", "--data", required=True, help="wav dir")
    p.add_argument("--max-samples", type=int, default=64000)
    p.set_defaults(fn=cmd_isolated_test)

    p = sub.add_parser("continuous_train")
    p.add_argument("-i", "--input", required=True, help="initial bank .npz")
    p.add_argument("-o", "--output", default="models-continuous")
    p.add_argument("-d", "--data", required=True, help="wav dir")
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--algo", choices=["hard", "soft"], default="hard",
                   help="hard = Viterbi-EM (reference semantics), "
                        "soft = forward-backward Baum-Welch")
    p.add_argument("--max-samples", type=int, default=120000)
    p.set_defaults(fn=cmd_continuous_train)

    p = sub.add_parser("connected_test")
    p.add_argument("-i", "--input", required=True, help="bank .npz")
    p.add_argument("-d", "--data", required=True, help="wav dir")
    _dc = DecodeConfig()
    p.add_argument("--graph", choices=["loop", "lextree", "sausage"],
                   default="loop")
    p.add_argument("--lm", choices=["none", "bigram"], default="none")
    p.add_argument("--n-slots", type=int, default=0,
                   help=f"sausage slots (0 = per-utterance ref length; "
                        f"reference uses {_dc.n_slots})")
    p.add_argument("--word-insertion-cost", type=float,
                   default=_dc.word_insertion_cost)
    p.add_argument("--lm-weight", type=float, default=_dc.lm_weight)
    p.add_argument("--lm-train", default=None,
                   help="wav dir whose filenames provide bigram training "
                        "transcripts (default: test transcripts, with warning)")
    p.add_argument("--decoder", choices=["auto", "compose", "lattice"],
                   default="auto",
                   help="lextree+bigram strategy: compose the LM onto the "
                        "graph (flat vocabularies only) or lattice-rescore "
                        "(the deep-tree production path, ops/lattice.py); "
                        "auto picks lattice for multi-unit words")
    p.add_argument("--confidence", action="store_true",
                   help="print per-word frame-posterior confidence "
                        "(loop graph)")
    p.add_argument("--max-samples", type=int, default=120000)
    p.set_defaults(fn=cmd_connected_test)

    p = sub.add_parser("stream", help="streaming (chunked) connected decode")
    p.add_argument("-i", "--input", required=True, help="bank .npz")
    p.add_argument("-d", "--data", required=True, help="wav dir")
    p.add_argument("--graph", choices=["loop", "lextree"], default="loop")
    p.add_argument("--chunk-frames", type=int, default=64)
    p.add_argument("--incremental", action="store_true",
                   help="bounded-memory mid-stream word emission")
    p.add_argument("--window-chunks", type=int, default=4)
    p.add_argument("--word-insertion-cost", type=float,
                   default=_dc.word_insertion_cost)
    p.add_argument("--max-samples", type=int, default=120000)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("align", help="forced alignment -> word segments")
    p.add_argument("-i", "--input", required=True, help="bank .npz")
    p.add_argument("-d", "--data", required=True, help="wav dir (Aurora names)")
    p.add_argument("-o", "--output", default="alignments.jsonl")
    p.add_argument("--max-samples", type=int, default=120000)
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("spellcheck", help="correct text against a dictionary")
    p.add_argument("-d", "--dict", required=True,
                   help="dictionary file (one word per line, or the "
                        "reference's 'words' CSV)")
    p.add_argument("-t", "--text", default=None, help="text to correct")
    p.add_argument("-f", "--file", default=None,
                   help="file of text to correct (default: stdin)")
    p.set_defaults(fn=cmd_spellcheck)

    p = sub.add_parser("record")
    p.add_argument("-i", "--input", default=None, help="bank .npz for classify")
    p.add_argument("-o", "--output-wav", default="test.wav")
    p.add_argument("--max-samples", type=int, default=64000)
    p.set_defaults(fn=cmd_record)

    args = ap.parse_args(argv)
    from speech_recognition_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
