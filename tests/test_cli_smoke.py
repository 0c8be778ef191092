"""CLI end-to-end smoke test: the full user journey in one pass
(synth -> isolated train/test -> continuous train -> connected test)."""

import glob
import os

import numpy as np
import pytest

from speech_recognition_jax.cli import main


def test_cli_pipeline(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    main(["synth", "-o", "data", "--n-train", "4", "--n-test", "2",
          "--n-continuous", "24"])
    main(["isolated_train", "-i", "data/train", "-o", "models/bank.npz",
          "--n-gaussians", "2"])
    main(["isolated_test", "-i", "models/bank.npz", "-d", "data/test"])
    out = capsys.readouterr().out
    acc = float(out.strip().splitlines()[-1])
    assert acc >= 0.8, f"CLI isolated accuracy {acc}"

    main(["continuous_train", "-i", "models/bank.npz", "-o", "models-cont",
          "-d", "data/train", "--iterations", "2"])
    cks = sorted(glob.glob("models-cont/*.npz"))
    assert len(cks) == 2

    # resume: one more iteration picks up from the latest checkpoint
    main(["continuous_train", "-i", "models/bank.npz", "-o", "models-cont",
          "-d", "data/train", "--iterations", "1"])
    out = capsys.readouterr().out
    assert "resuming from" in out
    assert len(glob.glob("models-cont/*.npz")) == 3

    main(["connected_test", "-i", sorted(glob.glob("models-cont/*.npz"))[-1],
          "-d", "data/test", "--graph", "loop", "--lm", "bigram"])
    out = capsys.readouterr().out
    wer = float([l for l in out.splitlines() if l.startswith("WER:")][0].split()[1])
    assert wer <= 0.25, f"CLI connected WER {wer}"

    # the lextree decoder on the flat digit vocabulary is provably the
    # loop graph: identical WER line for line
    main(["connected_test", "-i", sorted(glob.glob("models-cont/*.npz"))[-1],
          "-d", "data/test", "--graph", "lextree", "--lm", "bigram"])
    out = capsys.readouterr().out
    wer_lex = float(
        [l for l in out.splitlines() if l.startswith("WER:")][0].split()[1])
    assert wer_lex == wer, (wer_lex, wer)

    # production lattice-bigram decoder (pass-1 lattice + exact rescoring)
    # through the CLI: sane WER on the same corpus
    main(["connected_test", "-i", sorted(glob.glob("models-cont/*.npz"))[-1],
          "-d", "data/test", "--graph", "lextree", "--lm", "bigram",
          "--decoder", "lattice"])
    out = capsys.readouterr().out
    wer_lat = float(
        [l for l in out.splitlines() if l.startswith("WER:")][0].split()[1])
    assert wer_lat <= wer + 0.1, (wer_lat, wer)

    # per-word confidence emission on the loop graph
    main(["connected_test", "-i", sorted(glob.glob("models-cont/*.npz"))[-1],
          "-d", "data/test", "--graph", "loop", "--confidence"])
    out = capsys.readouterr().out
    conf_lines = [l for l in out.splitlines() if l.startswith("confidence ")]
    assert conf_lines
    for l in conf_lines:
        for tok in l.split(":", 1)[1].split():
            c = float(tok.rsplit(":", 1)[1])
            assert 0.0 <= c <= 1.0 + 1e-6, l


def test_cli_stream(tmp_path, capsys, monkeypatch):
    """The stream action: chunked decode == whole-utterance decode, and
    the incremental mode emits words mid-stream."""
    monkeypatch.chdir(tmp_path)
    main(["synth", "-o", "data", "--n-train", "4", "--n-test", "2",
          "--n-continuous", "10"])
    main(["isolated_train", "-i", "data/train", "-o", "models/bank.npz",
          "--n-gaussians", "2"])
    capsys.readouterr()
    main(["stream", "-i", "models/bank.npz", "-d", "data/test",
          "--chunk-frames", "48"])
    out1 = capsys.readouterr().out
    lines1 = [l for l in out1.splitlines() if l.endswith(")")]
    assert len(lines1) >= 2

    # incremental mode decodes the same words and reports mid-stream counts
    main(["stream", "-i", "models/bank.npz", "-d", "data/test",
          "--chunk-frames", "32", "--incremental", "--window-chunks", "2"])
    out2 = capsys.readouterr().out
    lines2 = [l for l in out2.splitlines() if "emitted mid-stream" in l]
    assert len(lines2) == len(lines1)
    words1 = {l.split(":")[0]: l.split("] (")[0] for l in lines1}
    words2 = {l.split(":")[0]: l.split("] (")[0] for l in lines2}
    assert words1 == words2

    # lextree streaming too
    main(["stream", "-i", "models/bank.npz", "-d", "data/test",
          "--graph", "lextree", "--chunk-frames", "48"])
    out3 = capsys.readouterr().out
    lines3 = [l for l in out3.splitlines() if l.endswith(")")]
    words3 = {l.split(":")[0]: l.split("] (")[0] for l in lines3}
    assert words3 == words1


def test_cli_pipeline_cmvn_silence(tmp_path, capsys, monkeypatch):
    """CMVN + silence-model flags end to end."""
    monkeypatch.chdir(tmp_path)
    main(["synth", "-o", "data", "--n-train", "4", "--n-test", "2",
          "--n-continuous", "16"])
    main(["isolated_train", "-i", "data/train", "-o", "models/bank.npz",
          "--n-gaussians", "2", "--norm", "cmvn", "--silence"])
    out = capsys.readouterr().out
    assert "trained silence model" in out
    main(["isolated_test", "-i", "models/bank.npz", "-d", "data/test"])
    acc = float(capsys.readouterr().out.strip().splitlines()[-1])
    assert acc >= 0.8, acc
    main(["continuous_train", "-i", "models/bank.npz", "-o", "models-cont",
          "-d", "data/train", "--iterations", "1"])
    import glob as g

    ck = sorted(g.glob("models-cont/*.npz"))[-1]
    main(["connected_test", "-i", ck, "-d", "data/test", "--graph", "loop"])
    out = capsys.readouterr().out
    wer = float([l for l in out.splitlines() if l.startswith("WER:")][0].split()[1])
    assert wer <= 0.3, wer
    # reference-parity sausage mode: one batched decode per distinct
    # transcript length (round-1 decoded one utterance at a time)
    main(["connected_test", "-i", ck, "-d", "data/test", "--graph", "sausage"])
    out = capsys.readouterr().out
    wer_s = float([l for l in out.splitlines()
                   if l.startswith("WER:")][0].split()[1])
    assert wer_s <= 0.35, wer_s


def test_cli_align(tmp_path, capsys, monkeypatch):
    """Forced-alignment command produces sane word segments."""
    import json

    monkeypatch.chdir(tmp_path)
    main(["synth", "-o", "data", "--n-train", "3", "--n-test", "1",
          "--n-continuous", "6"])
    main(["isolated_train", "-i", "data/train", "-o", "models/bank.npz",
          "--n-gaussians", "2"])
    main(["align", "-i", "models/bank.npz", "-d", "data/train",
          "-o", "align.jsonl"])
    rows = [json.loads(l) for l in open("align.jsonl")]
    assert len(rows) > 10
    for r in rows:
        assert r["segments"], r
        # segments tile the utterance without gaps
        assert r["segments"][0]["start_s"] == 0.0
        for a, b in zip(r["segments"], r["segments"][1:]):
            assert a["end_s"] == b["start_s"]
        # words (ignoring silence) spell the filename transcript
        from speech_recognition_jax.data.aurora import transcript_from_filename

        words = [s["word"] for s in r["segments"] if s["word"] != "sil"]
        # consecutive duplicates can appear only for repeated digits;
        # compare against the transcript directly
        assert "".join(words) == transcript_from_filename(r["file"])
