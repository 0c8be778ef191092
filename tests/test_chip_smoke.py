"""CPU tests of ``chip_smoke.py``'s own logic: the refusal without a
GPU, the compile-cache location rule, the tolerance comparators, the
last line's exact shape and the choice of phases."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from speech_recognition_jax.utils import compile_cache

REPO = Path(chip_smoke.__file__).resolve().parent


def test_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_compile_cache_location(monkeypatch, env_dir):
    """The cache follows JAX_COMPILATION_CACHE_DIR when it is set (and
    then no directory is set in code), else <checkout>/.jax_cache."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(REPO / ".jax_cache")
        assert compile_cache.enable_compile_cache() == want
        assert calls == [("jax_compilation_cache_dir", want)]
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert compile_cache.enable_compile_cache() == env_dir
        assert calls == []
    assert compile_cache.compile_cache_dir({}) == str(REPO / ".jax_cache")


def test_compare_decodes_counts_ties():
    words = [[1, 2], [3], [4, 4], [5]]
    costs = np.array([100.0, 200.0, 300.0, 400.0])
    ref_words = [[1, 2], [3], [4], [5]]
    ties, rel = chip_smoke.compare_decodes(
        "t", words, costs, ref_words, costs * (1 + 1e-7), rtol=1e-5,
        max_tie_share=0.25)
    assert ties == 1 and 0 < rel < 1e-6


@pytest.mark.parametrize("case", ["cost", "too_many_ties", "count"])
def test_compare_decodes_rejects(case):
    words = [[1, 2], [3], [4, 4], [5]]
    costs = np.array([100.0, 200.0, 300.0, 400.0])
    ref_words, ref_costs = list(words), costs.copy()
    if case == "cost":
        ref_costs[2] *= 1 + 1e-4
    elif case == "too_many_ties":
        ref_words = [[9]] * 4
    else:
        ref_words = ref_words[:3]
    with pytest.raises(chip_smoke.PhaseFailure):
        chip_smoke.compare_decodes("t", words, costs, ref_words, ref_costs,
                                   rtol=1e-5, max_tie_share=0.25)


def test_assert_close():
    err, rel = chip_smoke.assert_close("x", [1.0, 2.0], [1.0, 2.0 + 1e-9],
                                       rtol=1e-6)
    assert err == pytest.approx(1e-9) and rel < 1e-9
    with pytest.raises(chip_smoke.PhaseFailure, match="non-finite"):
        chip_smoke.assert_close("x", [np.nan], [1.0], atol=1.0)
    with pytest.raises(chip_smoke.PhaseFailure, match="shape"):
        chip_smoke.assert_close("x", [1.0], [1.0, 1.0], atol=1.0)
    with pytest.raises(chip_smoke.PhaseFailure, match="outside"):
        chip_smoke.assert_close("x", [1.1], [1.0], atol=0.05)


def test_last_line_shape():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.last_line([Dev()] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_four_cards_selects_only_its_phases():
    n1, one = chip_smoke.select_phases(False)
    n4, four = chip_smoke.select_phases(True)
    assert (n1, n4) == (1, 4)
    assert [n for n, _ in one] == ["frontend", "decode", "lextree",
                                   "streaming", "em"]
    assert [n for n, _ in four] == ["sharded_em", "sharded_decode",
                                    "sharded_bigram"]


def test_run_phases_reports_failures(capsys):
    def bad(ctx):
        raise chip_smoke.PhaseFailure("boom")

    ctx = chip_smoke.Ctx(sizes=chip_smoke.FULL, tag="t", ref_device=None)
    assert chip_smoke.run_phases(ctx, (("good", lambda c: None),
                                       ("bad", bad))) == ["bad"]
    out = capsys.readouterr()
    assert "[t] good: ok" in out.out and "[t] bad: FAILED" in out.out
    assert "boom" in out.err
