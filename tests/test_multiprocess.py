"""Two-process ``jax.distributed`` evidence (SURVEY.md §2.2 backend
row): a real multi-process run — TCP coordinator, gloo CPU collectives,
2 processes x 2 virtual devices — executes one sharded embedded-training
step and must match the single-process result.  This is the same
``jax.distributed.initialize`` + GSPMD path a multi-host GPU run uses;
only the transport differs (gloo here, NCCL there)."""

import pathlib
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from embedded_case import make_embedded_case
from speech_recognition_jax.train.embedded_step import embedded_step

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_step_matches_single_process(tmp_path):
    bank, feats, n_frames, graph_np, eps_depth, _ = make_embedded_case()
    gdev = {k: jnp.asarray(v) for k, v in graph_np.items()}
    ref_bank, ref_stats = embedded_step(
        bank, jnp.asarray(feats), jnp.asarray(n_frames), gdev,
        eps_depth=eps_depth)

    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "multiproc_worker.py"),
             str(i), str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"

    for i in range(2):
        got = np.load(tmp_path / f"proc{i}.npz")
        np.testing.assert_allclose(got["means"], np.asarray(ref_bank.means),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["log_vars"],
                                   np.asarray(ref_bank.log_vars),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["total_cost"],
                                   float(ref_stats.total_cost), rtol=1e-5)
