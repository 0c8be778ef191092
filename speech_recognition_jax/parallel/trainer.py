"""Sharded training & decoding entry points.

Wraps the jittable kernels with mesh shardings (GSPMD):

* utterance batches + per-utterance graphs shard over ``'data'``,
* the model bank replicates (or shards over ``'model'`` when a bank
  outgrows a chip),
* EM sufficient statistics / new parameters come out replicated — the
  cross-shard sums inside :func:`train.embedded_step.embedded_step` are
  the ``psum``s of SURVEY.md §2.2.

Used by the multi-chip dry run (``__graft_entry__.dryrun_multichip``)
and by pod-scale training.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from speech_recognition_jax.models.hmm import HMMBank
from speech_recognition_jax.train.embedded_step import embedded_step
from speech_recognition_jax.parallel.mesh import batch_sharding, bank_sharding

GRAPH_KEYS = ("trans", "eps_trans", "init_cost", "end_states", "bank_state")
#: banded graph batch (models.graph.pad_graphs_banded) — the soft
#: (Baum-Welch) step's production form: O(3S)/frame forward-backward
SOFT_GRAPH_KEYS = ("band", "init_cost", "eps_block", "word_starts",
                   "word_ends", "start_pos", "is_start", "end_scores",
                   "bank_state")


def shard_embedded_inputs(
    mesh: Mesh, bank: HMMBank, feats, n_frames, graph_batch, shard_models: bool = False
):
    """Device-put the step inputs with their production shardings."""
    data = batch_sharding(mesh)
    b_sh = bank_sharding(mesh, shard_models)
    bank = jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), b_sh), bank)
    feats = jax.device_put(jnp.asarray(feats, jnp.float32), data)
    n_frames = jax.device_put(jnp.asarray(n_frames, jnp.int32), data)
    keys = SOFT_GRAPH_KEYS if "band" in graph_batch else GRAPH_KEYS
    g = {k: jax.device_put(jnp.asarray(graph_batch[k]), data) for k in keys}
    return bank, feats, n_frames, g


def make_sharded_embedded_step(
    mesh: Mesh, eps_depth: int = 1, var_floor: float = 1e-2,
    shard_models: bool = False, soft: bool = False
):
    """A pjit-compiled embedded-training step over the mesh.

    Batch must divide the 'data' axis size.  Returns a function
    ``step(bank, feats, n_frames, graph_batch) -> (new_bank, stats)``
    with replicated outputs.  ``soft=True`` runs the Baum-Welch
    (sum-product) step; pass the banded graph batch from
    :func:`models.graph.pad_graphs_banded` (the banded O(3S)/frame
    forward-backward is its production form).
    """
    data = NamedSharding(mesh, P("data"))
    bank_sh = bank_sharding(mesh, shard_models)

    if soft:
        from speech_recognition_jax.train.embedded_step import embedded_step_soft

        fn = functools.partial(embedded_step_soft, eps_depth=eps_depth,
                               var_floor=var_floor)
        graph_keys = SOFT_GRAPH_KEYS
    else:
        fn = functools.partial(embedded_step, eps_depth=eps_depth,
                               var_floor=var_floor)
        graph_keys = GRAPH_KEYS
    bank_shardings = HMMBank(bank_sh, bank_sh, bank_sh, bank_sh)
    return jax.jit(
        fn,
        in_shardings=(
            bank_shardings,
            data,
            data,
            {k: data for k in graph_keys},
        ),
        out_shardings=(bank_shardings, None),
    )


def make_sharded_classifier(mesh: Mesh):
    """Data-parallel isolated-word classification over the mesh."""
    from speech_recognition_jax.decode.isolated import classify_batch

    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    bank_sh = HMMBank(repl, repl, repl, repl)
    return jax.jit(classify_batch, in_shardings=(bank_sh, data, data),
                   out_shardings=(data, data))
