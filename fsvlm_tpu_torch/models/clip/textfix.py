"""Vendored ftfy-equivalent text repair for the CLIP tokenizer.

Copy of fsvlm_tpu.models.clip.textfix (stdlib only); the port keeps its own
so that it imports nothing of the JAX package.

The reference tokenizer runs ``ftfy.fix_text`` before BPE
(PromptSRC/clip/simple_tokenizer.py:50-55).  ftfy is not installed in this
environment, so this module reimplements the default ftfy pipeline stages
that matter for tokenizer parity on real-world class names and prompts:

- HTML entity unescaping (ftfy ``unescape_html='auto'``)
- mojibake repair: UTF-8 bytes mis-decoded as cp1252/latin-1, including
  double-encoding (ftfy ``fix_encoding``)
- C1 control characters reinterpreted as cp1252 (``fix_c1_controls``)
- latin ligatures -> ascii letters (``fix_latin_ligatures``)
- full/half-width forms -> canonical width (``fix_character_width``)
- curly quotes -> straight quotes (``uncurl_quotes``)
- unicode line breaks -> ``\\n`` (``fix_line_breaks``)
- lone surrogates -> U+FFFD (``fix_surrogates``)
- removal of non-printing control characters (``remove_control_chars``)
- NFC normalization (``normalization='NFC'``)

The implementation is original (no ftfy code); behavior is pinned by
tests/test_textfix.py against ftfy's published documentation examples.
"""

import html
import re
import unicodedata

_LIGATURES = {
    "ﬀ": "ff",
    "ﬁ": "fi",
    "ﬂ": "fl",
    "ﬃ": "ffi",
    "ﬄ": "ffl",
    "ﬅ": "st",
    "ﬆ": "st",
    "Ĳ": "IJ",
    "ĳ": "ij",
}

_QUOTES = {
    "‘": "'",
    "’": "'",
    "‚": "'",
    "‛": "'",
    "“": '"',
    "”": '"',
    "„": '"',
    "‟": '"',
}

_LINE_BREAKS = {
    "\r\n": "\n",
    "\r": "\n",
    " ": "\n",
    " ": "\n",
    "": "\n",
}

# cp1252 leaves five byte values undefined; "sloppy" cp1252 (what ftfy uses
# to model real-world decoders) passes them through as their C1 codepoints.
_CP1252_HOLES = {0x81, 0x8D, 0x8F, 0x90, 0x9D}


def _to_bytes_sloppy_cp1252(text):
    """Inverse of the buggy decoder that produced the mojibake: re-encode
    via cp1252, letting undefined cp1252 slots fall back to latin-1."""
    out = bytearray()
    for ch in text:
        code = ord(ch)
        try:
            out += ch.encode("cp1252")
        except UnicodeEncodeError:
            if code < 0x100:
                out.append(code)
            else:
                return None
    return bytes(out)


def _fix_encoding_once(text):
    if not any(ord(c) > 0x7F for c in text):
        return text
    raw = _to_bytes_sloppy_cp1252(text)
    if raw is None:
        return text
    try:
        candidate = raw.decode("utf-8")
    except UnicodeDecodeError:
        # ftfy's restore_byte_a0: a 0xA0 (NBSP) continuation byte often got
        # flattened to a plain space downstream of the bad decode ("Ã " for
        # "à"); restore it after UTF-8 lead bytes and retry.
        restored = re.sub(rb"([\xc2-\xf4]) ", lambda m: m.group(1) + b"\xa0", raw)
        if restored == raw:
            return text
        try:
            candidate = restored.decode("utf-8")
        except UnicodeDecodeError:
            return text
    # Only a genuine multi-byte UTF-8 sequence shortens the text; a pure
    # latin-1 string round-trips unchanged and is left alone.
    return candidate if len(candidate) < len(text) else text


def fix_encoding(text):
    """Undo UTF-8-decoded-as-cp1252 mojibake, up to triple encoding."""
    for _ in range(3):
        fixed = _fix_encoding_once(text)
        if fixed == text:
            return text
        text = fixed
    return text


def _fix_c1_controls(text):
    out = []
    for ch in text:
        code = ord(ch)
        if 0x80 <= code <= 0x9F and code not in _CP1252_HOLES:
            out.append(bytes([code]).decode("cp1252"))
        else:
            out.append(ch)
    return "".join(out)


def _fix_character_width(text):
    out = []
    for ch in text:
        code = ord(ch)
        if 0xFF01 <= code <= 0xFFEF:
            out.append(unicodedata.normalize("NFKC", ch))
        elif ch == "　":  # ideographic space
            out.append(" ")
        else:
            out.append(ch)
    return "".join(out)


def _fix_surrogates(text):
    return "".join(
        "�" if 0xD800 <= ord(c) <= 0xDFFF else c for c in text
    )


def _remove_control_chars(text):
    return "".join(
        c
        for c in text
        if not (unicodedata.category(c) == "Cc" and c not in "\t\n")
    )


_HAS_ENTITY = re.compile(r"&#?\w+;")


def fix_text(text):
    """Default-config ftfy.fix_text equivalent (stages listed above)."""
    if _HAS_ENTITY.search(text):
        text = html.unescape(text)
    text = fix_encoding(text)
    text = _fix_c1_controls(text)
    # a C1 fix can reveal another layer of mojibake (double encoding whose
    # inner bytes landed in the C1 range)
    text = fix_encoding(text)
    for src, dst in _LIGATURES.items():
        if src in text:
            text = text.replace(src, dst)
    text = _fix_character_width(text)
    for src, dst in _QUOTES.items():
        if src in text:
            text = text.replace(src, dst)
    for src, dst in _LINE_BREAKS.items():
        if src in text:
            text = text.replace(src, dst)
    text = _fix_surrogates(text)
    text = _remove_control_chars(text)
    return unicodedata.normalize("NFC", text)
