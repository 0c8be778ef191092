from speech_recognition_jax.utils.numerics import (
    NEG_INF,
    POS_INF,
    masked_logsumexp,
    min_plus_step,
)
