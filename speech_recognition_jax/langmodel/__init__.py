from speech_recognition_jax.langmodel.bigram import BigramLM, fit_bigram, scale, uniform_bigram
from speech_recognition_jax.langmodel.lextree import LexTree, lextree_from_words
from speech_recognition_jax.langmodel.spellcheck import text_viterbi, SpellChecker
