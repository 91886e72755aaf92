"""CLIP byte-level BPE tokenizer, without the ``regex`` package.

Counterpart of ``diffbir_tpu/models/tokenizer.py`` (the OpenAI/OpenCLIP
SimpleTokenizer): the byte -> unicode remap, ``html.unescape`` (twice) and
whitespace collapsing, lower case, the word pattern, greedy lowest-rank pair
merging with the ``</w>`` end-of-word marker, a 49408-entry vocabulary (256
bytes, 256 bytes with ``</w>``, 48894 merges, 2 specials) and 77-token
padded output with SOT and EOT. ``ftfy`` text fixing is not applied (it is
absent where the port runs; the JAX tokenizer skips it then too).

The JAX word pattern ``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
(case-insensitive) needs ``regex`` for ``\\p{L}`` and ``\\p{N}``. Here the
text is split by one left-to-right scan with the same alternation: at each
position the first alternative that matches wins (the contractions, then a
run of letters, then one number character, then a run of anything that is
neither whitespace, letter nor number), and whitespace that starts no match
is skipped. Letters and numbers are the Unicode general categories L* and
N* (``unicodedata``; characters that a newer Unicode database assigns than
Python's may class differently), whitespace is ``str.isspace`` less
U+001C-U+001F, as ``regex``'s ``\\s``.

The merges file (``bpe_simple_vocab_16e6.txt.gz``) is looked up in
``$DIFFBIR_TPU_BPE_PATH``, then in ``weights/`` of the repository; a missing
file raises FileNotFoundError naming both places. Nothing is downloaded.
``write_stand_in_merges`` writes a file of that format for runs without it.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# merges kept so total vocab = 49408: 512 base + merges + 2 specials
_MERGE_COUNT = 49408 - 512 - 2
BPE_NAME = "bpe_simple_vocab_16e6.txt.gz"

SOT = "<start_of_text>"
EOT = "<end_of_text>"
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_SPACE_RUN = re.compile(r"[^\S\x1c-\x1f]+")  # regex's \s: not the separators 1C-1F


def _is_space(c: str) -> bool:
    return c.isspace() and not "\x1c" <= c <= "\x1f"


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def split_words(text: str) -> List[str]:
    """The JAX word pattern's ``findall`` (see the module's notes)."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        hit = next((p for p in _CONTRACTIONS if text[i:i + len(p)].lower() == p), None)
        if hit is not None:
            out.append(text[i:i + len(hit)])
            i += len(hit)
        elif _is_letter(c):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
            out.append(text[i:j])
            i = j
        elif _is_number(c):
            out.append(c)
            i += 1
        elif not _is_space(c):
            j = i + 1
            while j < n and not (_is_space(text[j]) or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
            out.append(text[i:j])
            i = j
        else:
            i += 1
    return out


@functools.lru_cache()
def _byte_unicode_table() -> Dict[int, str]:
    """Reversible printable-unicode encoding of the 256 byte values."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table = {b: chr(b) for b in keep}
    extra = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


def default_bpe_path() -> str:
    repo_weights = os.path.join(os.path.dirname(__file__), "..", "..", "weights", BPE_NAME)
    for c in (os.environ.get("DIFFBIR_TPU_BPE_PATH", ""), repo_weights):
        if c and os.path.exists(c):
            return c
    raise FileNotFoundError(
        f"CLIP BPE merges file {BPE_NAME} not found: set DIFFBIR_TPU_BPE_PATH to it or place "
        f"it at {os.path.normpath(repo_weights)}")


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return _SPACE_RUN.sub(" ", text.strip()).strip().lower()


class ClipTokenizer:
    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or default_bpe_path()
        if not os.path.exists(bpe_path):
            raise FileNotFoundError(f"CLIP BPE merges file not found: {bpe_path}")
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges: List[Tuple[str, str]] = [tuple(m.split()) for m in lines[1:_MERGE_COUNT + 1]]
        base = list(_byte_unicode_table().values())
        vocab = base + [c + "</w>" for c in base] + ["".join(m) for m in merges] + [SOT, EOT]
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.rank: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _merge_word(self, token: str) -> List[str]:
        """Greedy BPE: repeatedly merge the lowest-rank adjacent pair."""
        if token in self._cache:
            return self._cache[token]
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self.rank.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            a, b = parts[best_i], parts[best_i + 1]
            merged: List[str] = []
            i = 0
            while i < len(parts):  # every non-overlapping (a, b), left to right
                if i < len(parts) - 1 and parts[i] == a and parts[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in split_words(_clean(text)):
            mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._merge_word(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) not in (self.sot_id, self.eot_id))
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts: Union[str, List[str]], context_length: int = 77) -> np.ndarray:
        """Tokenize to a padded [N, context_length] int32 array (SOT ... EOT 0...)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_id] + self.encode(t) + [self.eot_id]
            if len(ids) > context_length:
                ids = ids[:context_length - 1] + [self.eot_id]
            out[i, :len(ids)] = ids
        return out


def write_stand_in_merges(path: str, texts: Sequence[str], total: int = _MERGE_COUNT) -> None:
    """A stand-in merges file, gzipped as the real one: merges that build
    every word of ``texts`` left to right, then filler merges of tokens no
    text can make, ``total`` in all, so that SOT and EOT get the real
    file's ids (49406, 49407 at the default). Its ids are not CLIP's."""
    table = _byte_unicode_table()
    merges, seen = [], set()
    for text in texts:
        for word in split_words(_clean(text)):
            parts = [table[b] for b in word.encode("utf-8")]
            parts[-1] += "</w>"
            while len(parts) > 1:
                if (parts[0], parts[1]) not in seen:
                    seen.add((parts[0], parts[1]))
                    merges.append((parts[0], parts[1]))
                parts = [parts[0] + parts[1]] + parts[2:]
    if len(merges) > total:
        raise ValueError(f"the texts need {len(merges)} merges, more than {total}")
    # filler: tokens with a character beyond the byte table, which no text makes
    merges += [(f"\u3400{k}", "\u3401") for k in range(total - len(merges))]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2 (stand-in)\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")


@functools.lru_cache()
def get_tokenizer(bpe_path: Optional[str] = None) -> ClipTokenizer:
    return ClipTokenizer(bpe_path)
