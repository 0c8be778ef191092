from speech_recognition_jax.parallel.mesh import make_mesh, bank_sharding, batch_sharding
from speech_recognition_jax.parallel.trainer import (
    make_sharded_embedded_step,
    shard_embedded_inputs,
)
