"""Embedded (continuous) training: Viterbi re-estimation over
transcript-composed graphs.

Replaces ``continuous_train``
(``/root/reference/sr/recognition/continuous_speech.py:56-179``).  Per
iteration the reference builds one linear word graph per utterance,
Python-Viterbi-aligns it, harvests per-GMM-state frame segments into
Python dicts, retrains every GMM from scratch (mixture splitting + EM)
and re-estimates self/exit transition costs ``p_jump =
n_occurrences / n_frames`` (``continuous_speech.py:146-164``).

Array-first differences:

* All utterances align in one vmapped ``lax.scan`` Viterbi over padded
  per-utterance graphs; emissions come from a single bank GEMM.
* Harvest is index arithmetic: path states map through ``bank_state``
  to global (model, state) ids; every GMM then trains on the shared
  flattened ``[B*T, D]`` buffer with a per-state boolean mask — the
  sufficient statistics are ``psum``-reducible, which is exactly how
  ``parallel/trainer.py`` scales this across a mesh.
* Frame-run counts (the reference's ``n_temps`` per state) are computed
  vectorized from path-state change points.
* Convergence matches the reference: allclose on every GMM's
  (weights, means, covariances) — transitions excluded, as in
  ``HMM.__eq__`` (``hmm.py:30-41``).

The reference's weight-normalization bug (weights divided by
``n_segments`` instead of the data count, ``continuous_speech.py:127,137``
— overwritten by EM anyway) is not reproduced; weights come from
cluster counts / data count as in isolated training.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from speech_recognition_jax.config import HMMConfig, TrainConfig
from speech_recognition_jax.models.graph import build_word_graph, pad_graphs
from speech_recognition_jax.models.hmm import HMMBank, bank_nll
from speech_recognition_jax.ops.viterbi import viterbi, viterbi_backtrace
from speech_recognition_jax.train.isolated import fit_gmm_state
from speech_recognition_jax.utils.numerics import POS_INF

__all__ = ["continuous_train", "align_batch", "harvest_state_ids"]

import functools


@functools.partial(jax.jit, static_argnames=("eps_depth",))
def align_batch(
    bank: HMMBank,
    feats,
    n_frames,
    trans,
    eps_trans,
    init_cost,
    end_states,
    bank_state,
    eps_depth: int = 1,
):
    """Forced alignment of a batch against per-utterance graphs.

    Returns ``(global_state_ids [B, T], costs [B])`` where ids index the
    flat (model, state) bank, and padded frames carry id -1.
    """
    b, t, d = feats.shape

    def one(x, nf, tr, eps, init, ends, bstate):
        frame_mask = jnp.arange(t) < nf
        nll = bank_nll(bank, x, frame_mask)[:, bstate]
        res = viterbi(nll, tr, init, nf, eps_trans=eps, eps_depth=eps_depth)
        end_costs = res.final_cost[ends]
        best = jnp.argmin(end_costs)
        states, _ = viterbi_backtrace(res.bp, res.eps_bp, ends[best], nf, eps_depth=eps_depth)
        ids = jnp.where(frame_mask, bstate[states], -1)
        return ids, end_costs[best]

    return jax.vmap(one)(feats, n_frames, trans, eps_trans, init_cost, end_states, bank_state)


def harvest_state_ids(ids: np.ndarray):
    """Per-global-state frame counts and run (occurrence) counts.

    ids: ``[B, T]`` global state ids, -1 padding.
    Returns ``(frame_counts [NS], run_counts [NS])`` as numpy, where NS is
    ``max(ids)+1`` per caller's bank size.
    """
    valid = ids >= 0
    changed = np.ones_like(ids, dtype=bool)
    changed[:, 1:] = ids[:, 1:] != ids[:, :-1]
    starts = valid & changed
    ns = int(ids.max()) + 1 if np.any(valid) else 0
    frame_counts = np.bincount(ids[valid].ravel(), minlength=ns)
    run_counts = np.bincount(ids[starts].ravel(), minlength=ns)
    return frame_counts, run_counts


def _graphs_for_labels(bank_np_trans, label_seqs):
    return [
        build_word_graph(bank_np_trans, [[l] for l in labels]) for labels in label_seqs
    ]


def continuous_train(
    key,
    bank: HMMBank,
    feats,
    n_frames,
    label_seqs: List[List[int]],
    hmm_cfg: HMMConfig = HMMConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    use_em: bool = True,
    checkpoint_cb: Optional[Callable[[int, HMMBank], None]] = None,
    verbose: bool = False,
) -> HMMBank:
    """Embedded Viterbi re-estimation.

    Args:
      bank: initial models (from isolated training).
      feats: ``[B, T, D]`` padded features; ``n_frames [B]``.
      label_seqs: transcript word ids per utterance.
      checkpoint_cb: called as ``cb(iteration, bank)`` after every
        iteration (the reference pickles all models each iteration,
        ``continuous_speech.py:166-170``).

    Returns the trained bank.
    """
    feats = jnp.asarray(feats, jnp.float32)
    n_frames = jnp.asarray(n_frames, jnp.int32)
    b, t, d = feats.shape
    n_models, s = bank.n_models, bank.n_states
    ns = n_models * s
    flat_x = feats.reshape(b * t, d)

    for it in range(train_cfg.continuous_max_iters):
        # 1. compose per-utterance linear graphs with current transitions
        trans_np = [np.asarray(bank.trans_cost[i]) for i in range(n_models)]
        graphs = _graphs_for_labels(trans_np, label_seqs)
        batch, eps_depth = pad_graphs(graphs)

        # 2. batched forced alignment
        ids, costs = align_batch(
            bank,
            feats,
            n_frames,
            jnp.asarray(batch["trans"]),
            jnp.asarray(batch["eps_trans"]),
            jnp.asarray(batch["init_cost"]),
            jnp.asarray(batch["end_states"]),
            jnp.asarray(batch["bank_state"]),
            eps_depth=eps_depth,
        )
        ids_np = np.asarray(ids)

        # 3. retrain every GMM state on its harvested frames
        flat_ids = jnp.asarray(ids_np.reshape(-1))
        new_means = np.asarray(bank.means).copy()
        new_vars = np.exp(np.asarray(bank.log_vars))
        new_w = np.exp(np.asarray(bank.log_weights))
        frame_counts, run_counts = harvest_state_ids(ids_np)
        frame_counts = np.pad(frame_counts, (0, ns - len(frame_counts)))
        run_counts = np.pad(run_counts, (0, ns - len(run_counts)))

        for gs in range(ns):
            mi, si = divmod(gs, s)
            if frame_counts[gs] == 0:
                # reference warns and skips states with no data
                # (continuous_speech.py:149-152)
                continue
            mask = flat_ids == gs
            mu0 = jnp.sum(jnp.where(mask[:, None], flat_x, 0.0), axis=0) / frame_counts[gs]
            key, sub = jax.random.split(key)
            m, v, w = fit_gmm_state(
                sub, flat_x, mask, mu0, hmm_cfg.n_mix, use_em=use_em,
                train_cfg=train_cfg, hmm_cfg=hmm_cfg,
            )
            new_means[mi, si] = np.asarray(m)
            new_vars[mi, si] = np.asarray(v)
            w = np.asarray(w)
            new_w[mi, si] = w / max(w.sum(), 1e-10)

        # 4. transition re-estimation (continuous_speech.py:146-164):
        # p_jump = n_runs / n_frames per state; exit cost -log(p_jump),
        # self cost -log(1 - p_jump) (applied to the last state too).
        new_trans = np.asarray(bank.trans_cost).copy()
        with np.errstate(divide="ignore"):
            for gs in range(ns):
                if frame_counts[gs] == 0:
                    continue
                mi, si = divmod(gs, s)
                p_jump = run_counts[gs] / frame_counts[gs]
                if si < s - 1:
                    new_trans[mi, si + 1, si] = (
                        -np.log(p_jump) if p_jump > 0 else POS_INF
                    )
                new_trans[mi, si, si] = (
                    -np.log(1.0 - p_jump) if p_jump < 1.0 else POS_INF
                )

        new_bank = HMMBank(
            means=jnp.asarray(new_means, jnp.float32),
            log_vars=jnp.log(jnp.maximum(jnp.asarray(new_vars, jnp.float32),
                                         hmm_cfg.var_floor)),
            log_weights=jnp.log(jnp.maximum(jnp.asarray(new_w, jnp.float32), 1e-10)),
            trans_cost=jnp.asarray(np.minimum(new_trans, POS_INF), jnp.float32),
        )

        if checkpoint_cb is not None:
            checkpoint_cb(it, new_bank)

        converged = (
            np.allclose(new_means, np.asarray(bank.means), rtol=train_cfg.rtol, atol=train_cfg.atol)
            and np.allclose(new_vars, np.exp(np.asarray(bank.log_vars)), rtol=train_cfg.rtol, atol=train_cfg.atol)
            and np.allclose(new_w, np.exp(np.asarray(bank.log_weights)), rtol=train_cfg.rtol, atol=train_cfg.atol)
        )
        bank = new_bank
        if verbose:
            print(f"continuous iteration {it}: mean align cost {float(np.mean(np.asarray(costs))):.2f}")
        if converged:
            break
    return bank
