from speech_recognition_jax.data.wav import read_wav, write_wav
from speech_recognition_jax.data.aurora import (
    transcript_from_filename,
    labels_from_transcript,
    isolated_file_pattern,
)
from speech_recognition_jax.data.synthetic import SyntheticDigits
from speech_recognition_jax.data.endpoint import endpoint_signal
