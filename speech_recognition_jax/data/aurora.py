"""Aurora digit-corpus filename conventions.

Filenames encode speaker + transcript: ``[A-Z]+_<digits>[AB].wav`` with
digit characters in ``[OZ1-9]`` (isolated-train regex
``/root/reference/cli.py:27``; continuous regexes
``/root/reference/sr/core.py:114`` and ``main.py:26``)."""

from __future__ import annotations

import re
from typing import List, Optional

from speech_recognition_jax.config import FILENAME_INDEX_MAP

_SEQ_RE = re.compile(r"(?<=_)[OZ0-9]+(?=[AB])")


def transcript_from_filename(filename: str) -> Optional[str]:
    m = _SEQ_RE.search(filename)
    return m.group(0) if m else None


def labels_from_transcript(transcript: str) -> List[int]:
    return [FILENAME_INDEX_MAP[c] for c in transcript]


def isolated_file_pattern(digit_name: str) -> str:
    """Regex matching isolated-training files for one digit
    (``/root/reference/cli.py:27``)."""
    return "[A-Z]+_" + digit_name + "[AB].wav"
