"""The port's CLIP tokenizer (no ``regex``) against the JAX one.

Both read one merges file the test writes (``write_stand_in_merges``, the
real file's format and size: SOT 49406, EOT 49407); the cases cover the
CLI's default prompts, contractions, digits, non-ASCII letters and
numbers, HTML entities, whitespace runs, words the merges do not build,
and truncation past 77 tokens. The ids must be equal; a missing merges
file raises FileNotFoundError naming it.
"""

import numpy as np
import pytest

from diffbir_tpu.models.tokenizer import ClipTokenizer as JaxClipTokenizer
from diffbir_tpu_torch.inference.__main__ import DEFAULT_NEG_PROMPT, DEFAULT_POS_PROMPT
from diffbir_tpu_torch.models import tokenizer as port_tok

CASES = [
    DEFAULT_POS_PROMPT,
    DEFAULT_NEG_PROMPT,
    "",
    "It's we're they've I'm you'll he'd DON'T ''s o'clock 'S",
    "32k 2024 3.14 x264 1,000,000",
    "Café naïve Ünïcødé 漢字テスト ٣٤ ½ Ⅻ ÀÉÎ",
    "&amp; &lt;b&gt;bold&lt;/b&gt; &amp;amp; &quot;quoted&quot; &#39;apos&#39;",
    "  lots \t of\n\n white   space   and em  ",
    "unmergedwordzzz qwxv!!?? -- ... ;;",
    " ".join(["photo"] * 40) + " the end",
]


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / port_tok.BPE_NAME)
    port_tok.write_stand_in_merges(path, CASES[:2] + ["photo the end it's café"])
    return path


@pytest.fixture(scope="module")
def pair(merges):
    return JaxClipTokenizer(merges), port_tok.ClipTokenizer(merges)


def test_vocabulary_matches_jax(pair):
    ref, tok = pair
    assert tok.vocab_size == ref.vocab_size == 49408
    assert (tok.sot_id, tok.eot_id) == (ref.sot_id, ref.eot_id) == (49406, 49407)
    assert tok.encoder == ref.encoder


@pytest.mark.parametrize("case", range(len(CASES)))
def test_ids_match_jax(pair, case):
    ref, tok = pair
    text = CASES[case]
    np.testing.assert_array_equal(tok([text]), ref([text]))
    assert tok.encode(text) == ref.encode(text)
    assert tok.decode(tok.encode(text)) == ref.decode(ref.encode(text))


def test_truncation_ends_with_eot(pair):
    ref, tok = pair
    ids = tok(CASES[-1] * 3)
    assert ids.shape == (1, 77) and ids[0, 0] == 49406 and ids[0, -1] == 49407
    assert (ids[0] > 0).all()
    np.testing.assert_array_equal(ids, ref(CASES[-1] * 3))
    np.testing.assert_array_equal(tok(CASES), ref(CASES))


def test_missing_merges_file_raises(monkeypatch, tmp_path):
    missing = str(tmp_path / "absent.txt.gz")
    monkeypatch.setenv("DIFFBIR_TPU_BPE_PATH", missing)
    with pytest.raises(FileNotFoundError, match=port_tok.BPE_NAME):
        port_tok.default_bpe_path()
    with pytest.raises(FileNotFoundError, match="absent"):
        port_tok.ClipTokenizer(missing)
