from speech_recognition_jax.models.hmm import GMMHMM, HMMBank
from speech_recognition_jax.models.graph import WordGraph, build_word_graph, pad_graphs
from speech_recognition_jax.models.lexgraph import (
    LexGraph,
    build_lex_graph,
    lex_words_from_path,
)
