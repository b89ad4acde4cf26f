"""The port's regex-free CLIP tokenizer against the golden pack and the JAX
package's tokenizer (which uses the ``regex`` module)."""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from fsvlm_tpu.models.clip import tokenizer as jax_tok
from fsvlm_tpu_torch.models.clip import tokenizer as port_tok

PACK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_pack",
                    "tokenizer.npz")


def test_port_tokenizer_replays_golden_pack():
    from test_tokenizer import TEXTS

    z = np.load(PACK)
    texts = [t for t in TEXTS if t]
    assert int(z["n_texts"]) == len(texts)
    np.testing.assert_array_equal(port_tok.tokenize(texts), z["tokenize_ids"])
    tok = port_tok.get_tokenizer()
    for i, t in enumerate(texts):
        np.testing.assert_array_equal(
            np.asarray(tok.encode(t), np.int32), z[f"encode_{i}"], err_msg=t)


def test_port_tokenizer_vocab_truncate_decode():
    tok = port_tok.get_tokenizer()
    assert (tok.vocab_size, tok.sot_id, tok.eot_id) == (49408, 49406, 49407)
    with pytest.raises(RuntimeError):
        port_tok.tokenize("word " * 200)
    ids = port_tok.tokenize("word " * 200, truncate=True)
    assert ids.shape == (1, 77) and ids[0, -1] == tok.eot_id
    text = "a photo of a golden retriever, a type of dog."
    assert tok.decode(tok.encode(text)).strip() == \
        "a photo of a golden retriever , a type of dog ."


@pytest.mark.parametrize("text", [
    "x²y Ⅻ ½ ३४ 七", "don'T 'S 'ſ 'll'd 're've 'm", "<|endoftext|>a<|ſtartoftext|>",
    "..'s !!? — «quoted» ¿qué?", "tab\tnew\nline  nbsp thin end",
    "é ä क्ष", "猫の写真 고양이 사진", "x\x1cy\x1fz",
])
def test_port_split_matches_regex_on_edge_cases(text):
    assert port_tok.get_tokenizer().encode(text) == jax_tok.get_tokenizer().encode(text)


_CATEGORIES = ["Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No",
               "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So", "Zs"]
_PIECES = st.one_of(
    st.characters(categories=_CATEGORIES),
    st.sampled_from(["²", "Ⅻ", "'s", "'LL", "'d", "ſ", " ", "\t", "<|endoftext|>",
                     "猫", "写真", "a", "1962", ".", "-"]),
)


@settings(max_examples=300, deadline=None)
@given(st.lists(_PIECES, max_size=24).map("".join))
def test_port_tokenize_matches_jax_on_drawn_strings(text):
    np.testing.assert_array_equal(
        port_tok.tokenize(text, truncate=True), jax_tok.tokenize(text, truncate=True))
