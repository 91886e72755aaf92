"""A seeded stand-in for the CLIP tokenizer (the vocabulary is not in the
repository): each word of a text becomes an id in [0, SOT) from a CRC of
the seed and the word, between SOT and EOT, zero-padded to 77. A copy of
the port's ``profile_step.stand_in_tokenizer``, kept here so that the
benchmark's inputs do not move with the program."""

from __future__ import annotations

import zlib

import numpy as np

SOT, EOT = 49406, 49407


def stand_in_tokenizer(seed: int, context_length: int = 77):
    """list of texts -> int64 ids [n, context_length]."""
    def tokenize(texts):
        out = np.zeros((len(texts), context_length), np.int64)
        for row, text in zip(out, texts):
            ids = [zlib.crc32(f"{seed}:{w}".encode()) % SOT
                   for w in text.split()[:context_length - 2]]
            row[:len(ids) + 2] = [SOT, *ids, EOT]
        return out
    return tokenize
