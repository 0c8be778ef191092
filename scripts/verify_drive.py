"""End-to-end library drive (the .claude/skills/verify recipe, runnable).

wav -> MFCC -> isolated training -> isolated classification ->
connected decode over the loop graph, the flat lextree (must be
bit-identical), and the token beam (full width: must also be
identical).  CPU, ~2 min.  Exits non-zero on any regression.
"""

import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import jax

jax.config.update("jax_platforms", "cpu")

import collections
import pathlib
import tempfile

import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.config import DIGIT_NAMES, FrontendConfig
from speech_recognition_jax.data import (
    SyntheticDigits,
    read_wav,
    transcript_from_filename,
    write_wav,
)
from speech_recognition_jax.decode import (
    beam_decode_lextree,
    classify_batch,
    decode_connected,
    decode_lextree,
)
from speech_recognition_jax.models import HMMBank, build_lex_graph
from speech_recognition_jax.models.graph import build_loop_graph
from speech_recognition_jax.ops import mfcc39, padded_length
from speech_recognition_jax.train import fit_hmm
from speech_recognition_jax.utils.metrics import wer


def featurize(utts, cfg):
    cap = max(len(u.samples) for u in utts)
    L = padded_length(cfg, cap)
    out, nfs = [], []
    for u in utts:
        buf = np.zeros(L, np.float32)
        buf[: len(u.samples)] = u.samples
        c, nf = mfcc39(jnp.asarray(buf), np.int32(len(u.samples)), cfg)
        out.append(np.asarray(c))
        nfs.append(int(nf))
    t = max(nfs)
    arr = np.zeros((len(out), t, 39), np.float32)
    for i, c in enumerate(out):
        arr[i, : nfs[i]] = c[: nfs[i]]
    return jnp.asarray(arr), jnp.asarray(np.asarray(nfs, np.int32))


def main():
    cfg = FrontendConfig()
    gen = SyntheticDigits(seed=11)
    train = gen.isolated_corpus(5)
    test = gen.isolated_corpus(3)

    # wav file surface round-trips
    with tempfile.TemporaryDirectory() as d:
        p = pathlib.Path(d) / train[0].name
        write_wav(p, train[0].samples)
        rate, rt = read_wav(p)
        assert len(rt) == len(train[0].samples)
        assert transcript_from_filename(p.name) is not None

    by_digit = collections.defaultdict(list)
    xs, nf = featurize(train, cfg)
    for u, x, n in zip(train, np.asarray(xs), np.asarray(nf)):
        by_digit[u.labels[0]].append(x[:n])
    key = jax.random.PRNGKey(0)
    bank = HMMBank.stack(
        [fit_hmm(jax.random.fold_in(key, d), by_digit[d])
         for d in sorted(by_digit)])

    xt, nt = featurize(test, cfg)
    pred, _ = classify_batch(bank, xt, nt)
    acc = float(np.mean(
        [int(p) == u.labels[0] for p, u in zip(np.asarray(pred), test)]))
    print("isolated acc:", acc)
    assert acc >= 0.9, acc

    conn = gen.continuous_corpus(12)
    xc, nc = featurize(conn, cfg)
    refs = [u.labels for u in conn]
    mt = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]

    gl = build_loop_graph(mt)
    seqs_loop, costs_loop = decode_connected(bank, gl, xc, nc)
    w_loop = wer(seqs_loop, refs)
    print("loop-graph WER:", w_loop)
    assert w_loop <= 0.35, w_loop

    unit_ids = {ch: i for i, ch in enumerate(DIGIT_NAMES)}
    lexg = build_lex_graph(list(DIGIT_NAMES), mt, unit_ids)
    seqs_lex, costs_lex = decode_lextree(bank, lexg, xc, nc)
    assert seqs_lex == seqs_loop
    np.testing.assert_allclose(costs_lex, costs_loop, rtol=0)
    print("lextree decode identical to the loop graph")

    seqs_beam, costs_beam = beam_decode_lextree(bank, lexg, xc, nc,
                                                k=lexg.n_states)
    assert seqs_beam == seqs_loop
    np.testing.assert_allclose(costs_beam, costs_loop, rtol=1e-6)
    seqs_nb, _ = beam_decode_lextree(bank, lexg, xc, nc, k=16)
    print("beam (full) identical; narrow k=16 WER:", wer(seqs_nb, refs))

    print("VERIFY DRIVE OK")


if __name__ == "__main__":
    main()
