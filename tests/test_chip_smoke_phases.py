"""Every ``chip_smoke.py`` phase run end to end on the CPU at small
shapes (the four-card phases on four of the suite's virtual CPU
devices), with the same comparisons the GPU run makes."""

import jax
import pytest

import chip_smoke

TINY = chip_smoke.Sizes(
    frontend_batch=3, frontend_seconds=0.5, frontend_oracle_utts=2,
    decode_batch=4, decode_frames=60, dp_oracle_utts=1,
    lex_words=60, lex_batch=4, lex_frames=40,
    stream_batch=3, stream_frames=96, stream_chunk=32, incremental_streams=2,
    em_iterations=2,
    multi_em_batch=4, multi_em_frames=40, sharded_utts=2, sharded_frames=30,
    bigram_batch=4)

PHASES = dict(chip_smoke.ONE_CARD + chip_smoke.FOUR_CARDS)


@pytest.mark.parametrize("name", list(PHASES))
def test_phase_on_cpu(name, capsys):
    ctx = chip_smoke.Ctx(sizes=TINY, tag="cpu", ref_device=jax.devices("cpu")[0])
    PHASES[name](ctx)
    out = capsys.readouterr().out
    assert f"[cpu] {name}:" in out
