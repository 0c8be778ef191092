"""Worker for the two-process ``jax.distributed`` test.

Usage: ``python tests/multiproc_worker.py <process_id> <port> <outdir>``.
Each process owns 2 virtual CPU devices; the pair forms a 4-device
global 'data' mesh.  Runs ONE sharded embedded-training step on the
shared deterministic case and dumps the (replicated) outputs for the
parent test to compare against the single-process result.
"""

import os
import pathlib
import sys

proc = int(sys.argv[1])
port = sys.argv[2]
outdir = pathlib.Path(sys.argv[3])

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
repo = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(repo))
sys.path.insert(0, str(repo / "tests"))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from speech_recognition_jax.parallel.mesh import init_distributed

init_distributed(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                 process_id=proc)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()

import functools

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from embedded_case import make_embedded_case
from speech_recognition_jax.models.hmm import HMMBank
from speech_recognition_jax.parallel.mesh import make_mesh
from speech_recognition_jax.train.embedded_step import embedded_step

bank, feats, n_frames, graph_np, eps_depth, _ = make_embedded_case()

mesh = make_mesh(shape=(4, 1))
data = NamedSharding(mesh, P("data"))
repl = NamedSharding(mesh, P())


def globalize(a, sh):
    a = np.asarray(a)
    return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])


bank_g = HMMBank(*(globalize(x, repl) for x in bank))
feats_g = globalize(feats.astype(np.float32), data)
nf_g = globalize(n_frames.astype(np.int32), data)
graph_g = {k: globalize(v, data) for k, v in graph_np.items()}

step = jax.jit(
    functools.partial(embedded_step, eps_depth=eps_depth),
    in_shardings=(HMMBank(repl, repl, repl, repl), data, data,
                  {k: data for k in graph_g}),
    out_shardings=(HMMBank(repl, repl, repl, repl), None),
)
new_bank, stats = step(bank_g, feats_g, nf_g, graph_g)

np.savez(
    outdir / f"proc{proc}.npz",
    means=np.asarray(jax.device_get(new_bank.means)),
    log_vars=np.asarray(jax.device_get(new_bank.log_vars)),
    total_cost=float(stats.total_cost),
)
print(f"worker {proc} done", flush=True)
