from speech_recognition_jax.ops.frontend import (
    mfcc,
    mfcc39,
    padded_length,
    max_frames,
    delta_feature,
    standardize,
)
from speech_recognition_jax.ops.gmm import (
    gmm_neg_log_lik,
    gmm_emission_weights,
    mahalanobis,
)
from speech_recognition_jax.ops.viterbi import viterbi, viterbi_backtrace
from speech_recognition_jax.ops.viterbi_banded import (
    banded_arrays,
    banded_backtrace,
    banded_backtrace_tb,
    viterbi_banded,
    viterbi_banded_tb,
)
from speech_recognition_jax.ops.forward_backward import forward_backward
