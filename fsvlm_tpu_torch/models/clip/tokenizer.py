"""CLIP byte-level BPE tokenizer without the third-party ``regex`` package.

Copy of fsvlm_tpu.models.clip.tokenizer (reference:
PromptSRC/clip/simple_tokenizer.py:1-132, clip/clip.py:185-221) whose
pre-tokenizer is rewritten on the standard library.  CLIP splits text with

    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+            (IGNORECASE)

which needs the Unicode property classes of ``regex``.  ``_split_words``
walks the string by hand with the same alternatives in the same order:
letters and numbers are ``unicodedata`` categories L* and N*, whitespace is
``str.isspace`` minus U+001C..U+001F (which ``regex``'s ``\\s`` excludes), and
the case-insensitive literals also accept U+017F (long s), the one lowercase
character that simple case folding maps onto their ASCII letters.

The BPE merge table is data, read in place: ``$FSVLM_BPE_PATH`` or the copy
that ships beside the JAX package (read by path, never imported).
"""

import functools
import gzip
import html
import os
import unicodedata

import numpy as np

from .textfix import fix_text

_VOCAB_FILENAME = "bpe_simple_vocab_16e6.txt.gz"

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# whitespace as the `regex` module's \s sees it: str.isspace() without the
# four ASCII information separators
_NOT_REGEX_SPACE = frozenset("\x1c\x1d\x1e\x1f")


def find_bpe_vocab():
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    candidates = []
    env = os.environ.get("FSVLM_BPE_PATH")
    if env:
        candidates.append(env)
    candidates.append(os.path.join(repo, "fsvlm_tpu", "models", "clip", _VOCAB_FILENAME))
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(
        f"CLIP BPE vocab ({_VOCAB_FILENAME}) not found. Searched: {candidates}. "
        "Set FSVLM_BPE_PATH to the vocab file location."
    )


@functools.lru_cache()
def byte_to_unicode_table():
    """Reversible byte -> printable-unicode map (GPT-2 style): printable
    latin bytes map to themselves, the other 68 to 256+i, in vocab order."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    ordered = {b: chr(b) for b in keep}
    extra = 0
    for b in range(256):
        if b not in ordered:
            ordered[b] = chr(256 + extra)
            extra += 1
    return ordered


def _is_space(c):
    return c.isspace() and c not in _NOT_REGEX_SPACE


def _is_letter(c):
    return unicodedata.category(c)[0] == "L"


def _is_number(c):
    return unicodedata.category(c)[0] == "N"


def _fold(c):
    return "s" if c == "ſ" else c.lower()


def _literal_at(text, i, lit):
    """Case-insensitive match of ASCII ``lit`` at text[i:]."""
    if i + len(lit) > len(text):
        return False
    return all(_fold(text[i + j]) == ch for j, ch in enumerate(lit))


def _split_words(text):
    """Words of CLIP's pre-tokenizer pattern, as ``regex.findall`` returns them."""
    words = []
    i, n = 0, len(text)
    while i < n:
        lit = next((t for t in (SOT_TOKEN, EOT_TOKEN) + _CONTRACTIONS
                    if _literal_at(text, i, t)), None)
        if lit is not None:
            words.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        c = text[i]
        if _is_letter(c):
            j = i + 1
            while j < n and _is_letter(text[j]):
                j += 1
        elif _is_number(c):
            j = i + 1
        elif not _is_space(c):
            j = i + 1
            while j < n and not (_is_space(text[j]) or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        else:
            i += 1
            continue
        words.append(text[i:j])
        i = j
    return words


def _collapse_space(text):
    """``regex.sub(r"\\s+", " ", text)`` with the same notion of whitespace."""
    out, prev_space = [], False
    for c in text:
        if _is_space(c):
            if not prev_space:
                out.append(" ")
            prev_space = True
        else:
            out.append(c)
            prev_space = False
    return "".join(out)


def _clean_text(text):
    """ftfy.fix_text + double html.unescape + strip
    (simple_tokenizer.py:50-55); ``textfix.fix_text`` stands in for ftfy."""
    text = fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


class ClipTokenizer:
    def __init__(self, bpe_path=None):
        bpe_path = bpe_path or find_bpe_vocab()
        self.byte_encoder = byte_to_unicode_table()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}

        lines = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        # line 0 is a header; the usable merge list is exactly
        # 49152 - 256*2 - 2 entries (SOT/EOT + byte vocab take the rest)
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines]
        self.merge_rank = {pair: i for i, pair in enumerate(merges)}

        vocab = list(self.byte_encoder.values())
        vocab += [c + "</w>" for c in vocab]
        vocab += ["".join(pair) for pair in merges]
        vocab += [SOT_TOKEN, EOT_TOKEN]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}

        self._bpe_cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}

    @property
    def vocab_size(self):
        return len(self.encoder)

    @property
    def sot_id(self):
        return self.encoder[SOT_TOKEN]

    @property
    def eot_id(self):
        return self.encoder[EOT_TOKEN]

    def _apply_bpe(self, token):
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        # a "word" is a sequence of symbols; the last byte carries the
        # end-of-word marker
        symbols = list(token[:-1]) + [token[-1] + "</w>"]
        if len(symbols) == 1:
            return token + "</w>"

        while len(symbols) > 1:
            # find the lowest-rank adjacent pair
            best_rank = None
            best_idx = -1
            for i in range(len(symbols) - 1):
                rank = self.merge_rank.get((symbols[i], symbols[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_idx = i
            if best_rank is None:
                break
            first, second = symbols[best_idx], symbols[best_idx + 1]
            # merge every (non-overlapping, left-to-right) occurrence of the pair
            merged = []
            i = 0
            while i < len(symbols):
                if (
                    i < len(symbols) - 1
                    and symbols[i] == first
                    and symbols[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged

        result = " ".join(symbols)
        self._bpe_cache[token] = result
        return result

    def encode(self, text):
        text = _clean_text(text)
        text = _collapse_space(text).strip().lower()
        ids = []
        for word in _split_words(text):
            mapped = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[sym] for sym in self._apply_bpe(mapped).split(" "))
        return ids

    def decode(self, ids):
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def get_tokenizer():
    return ClipTokenizer()


def tokenize(texts, context_length=77, truncate=False):
    """Tokenize text(s) into a [N, context_length] int32 array.

    Parity with clip/clip.py:185-221: SOT + bpe ids + EOT, zero padded; raises
    on overflow unless ``truncate`` (which then keeps EOT as last token).
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    sot, eot = tok.sot_id, tok.eot_id

    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [sot] + tok.encode(text) + [eot]
        if len(ids) > context_length:
            if truncate:
                ids = ids[:context_length]
                ids[-1] = eot
            else:
                raise RuntimeError(
                    f"Input {text} is too long for context length {context_length}"
                )
        out[row, : len(ids)] = ids
    return out
