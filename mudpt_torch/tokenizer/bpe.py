"""Byte-level BPE tokenizer producing CLIP's 49,408-entry vocabulary.

A copy of ``mudpt_tpu/tokenizer/bpe.py`` that needs only the standard
library: text is unicode-fixed, html-unescaped, whitespace-collapsed and
lowercased; split by the CLIP pattern; each piece is mapped through the
GPT-2 byte->unicode table and merged bottom-up by BPE rank, with ``</w>``
marking word ends.

The JAX package splits with the third-party ``regex`` module
(``\\p{L}``, ``\\p{N}``, ``\\s``).  Here those classes are expanded into
explicit character classes built from ``unicodedata`` when the module is
imported, so stdlib ``re`` gives the same pieces:

  * letters / numbers: every code point whose general category starts with
    ``L`` / ``N``;
  * whitespace: the Unicode ``White_Space`` set that ``regex`` means by
    ``\\s`` (stdlib ``\\s`` also matches U+001C..U+001F, which ``regex``
    does not);
  * U+0345 (COMBINING GREEK YPOGEGRAMMENI) matches neither the letter run
    nor the punctuation run under ``regex``'s IGNORECASE (it case-folds to
    a letter), so it is dropped from both here too.

Ids agree with the JAX tokenizer for every code point assigned in this
interpreter's Unicode database; code points assigned only in the newer
database bundled with ``regex`` may split differently.

The merge table is the public OpenAI CLIP asset
(``bpe_simple_vocab_16e6.txt.gz``), copied under ``assets/``.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import Dict, List, Tuple

_ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                      "bpe_simple_vocab_16e6.txt.gz")

# number of merge rules in the CLIP vocab: 49152 total - 256 bytes*2 - 2 specials
_N_MERGES = 49152 - 256 - 2


def _category_class(prefix: str) -> str:
    """Body of a character class holding every code point whose Unicode
    general category starts with ``prefix``, as compact ranges."""
    parts = []
    start = None
    for cp in range(sys.maxunicode + 2):
        ok = cp <= sys.maxunicode and unicodedata.category(chr(cp)).startswith(prefix)
        if ok and start is None:
            start = cp
        elif not ok and start is not None:
            lo, hi = re.escape(chr(start)), re.escape(chr(cp - 1))
            parts.append(lo if start == cp - 1 else f"{lo}-{hi}")
            start = None
    return "".join(parts)


_LETTERS = _category_class("L")
_NUMBERS = _category_class("N")
# regex's \s: the Unicode White_Space property
_WHITESPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


@functools.lru_cache()
def _byte_unicode_table() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode mapping."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    table = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + offset)
            offset += 1
    return table


_MOJIBAKE_MARKERS = re.compile(
    # Only the high-confidence mojibake leads: U+00C2/U+00C3 (mis-decoded
    # UTF-8 leads of the Latin-1 supplement) and U+00E2 (general-punctuation
    # triples), followed by a continuation-range char (U+0080-U+00BF) or its
    # cp1252 remapping.
    "[\u00c2\u00c3\u00e2]"
    "[\u0080-\u00bf\u20ac\u2018\u2019\u201c\u201d\u2013\u2014\u2026\u02dc\u2122]"
)


def _fix_mojibake(text: str) -> str:
    """Best-effort ftfy.fix_text stand-in for the classic mojibake case:
    UTF-8 bytes decoded as Latin-1/cp1252.  Only rewrites when the text
    shows mojibake marker sequences AND the repaired form round-trips, so
    plain accented text ('café') is untouched."""
    for _ in range(3):  # double-encoded mojibake repairs in two passes
        if not _MOJIBAKE_MARKERS.search(text):
            return text
        try:
            repaired = text.encode("cp1252", errors="strict").decode("utf-8")
        except (UnicodeEncodeError, UnicodeDecodeError):
            try:
                repaired = text.encode("latin-1", errors="strict").decode(
                    "utf-8"
                )
            except (UnicodeEncodeError, UnicodeDecodeError):
                return text
        if repaired == text:
            return text
        text = repaired
    return text


def _fix_text(text: str) -> str:
    text = _fix_mojibake(text)
    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    return text.strip()


# applied to lowercased text, so the case-insensitive flag of the regex
# original only matters for U+0345 (see the module docstring)
_SPLIT_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    f"|[{_LETTERS}]+|[{_NUMBERS}]|[^{_WHITESPACE}{_LETTERS}{_NUMBERS}\u0345]+"
)
_WS_RE = re.compile(f"[{_WHITESPACE}]+")


class ClipBPE:
    def __init__(self):
        self.byte_to_u = _byte_unicode_table()
        self.u_to_byte = {u: b for b, u in self.byte_to_u.items()}

        with gzip.open(_ASSET, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merge_lines = lines[1 : _N_MERGES + 1]
        merges: List[Tuple[str, str]] = [tuple(m.split()) for m in merge_lines]

        units = list(_byte_unicode_table().values())
        vocab: List[str] = units + [u + "</w>" for u in units]
        vocab.extend(a + b for a, b in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.rank: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self._word_cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot(self) -> int:
        return self.encoder["<|endoftext|>"]

    def _merge_word(self, word: str) -> List[str]:
        """Apply BPE merges to one byte-unicode word; returns subword pieces."""
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        if len(word) == 1:
            pieces = [word + "</w>"]
            self._word_cache[word] = pieces
            return pieces

        parts: List[str] = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            # find the lowest-rank adjacent pair
            best_rank = None
            best_idx = -1
            for i in range(len(parts) - 1):
                r = self.rank.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_idx = r, i
            if best_rank is None:
                break
            first, second = parts[best_idx], parts[best_idx + 1]
            # merge every occurrence of this exact pair left-to-right
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i + 1 < len(parts)
                    and parts[i] == first
                    and parts[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._word_cache[word] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        text = _WS_RE.sub(" ", _fix_text(text)).strip().lower()
        ids: List[int] = []
        for piece in _SPLIT_RE.findall(text):
            # special tokens map to their single id (the reference seeds its
            # BPE cache with them) — without this they would be byte-mapped
            # and BPE-split into subwords
            if piece in ("<|startoftext|>", "<|endoftext|>"):
                ids.append(self.encoder[piece])
                continue
            mapped = "".join(self.byte_to_u[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[sub] for sub in self._merge_word(mapped))
        return ids

    def decode(self, ids) -> str:
        joined = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.u_to_byte[u] for u in joined if u in self.u_to_byte)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def get_tokenizer() -> ClipBPE:
    return ClipBPE()
