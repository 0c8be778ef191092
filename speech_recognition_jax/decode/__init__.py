from speech_recognition_jax.decode.isolated import score_models, classify_batch
from speech_recognition_jax.decode.connected import (
    decode_connected,
    connected_graph_arrays,
)
from speech_recognition_jax.decode.dtw import dtw_classify_batch, fit_template, stack_templates
from speech_recognition_jax.decode.streaming import StreamingDecoder
from speech_recognition_jax.decode.lextree import beam_decode_lextree, decode_lextree
from speech_recognition_jax.decode.confidence import path_posteriors, word_confidence
