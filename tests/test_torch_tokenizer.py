"""The port's stdlib-``re`` tokenizer against the JAX package's
``regex``-based one: every template of ``trainers/templates.py`` with a set
of classnames, the fixed-length table, and a numpy-seeded fuzz over
non-ASCII letters, digits, punctuation and whitespace."""

import unicodedata

import numpy as np
import pytest

from mudpt_tpu import tokenizer as JTOK
from mudpt_tpu.trainers.templates import (
    CUSTOM_TEMPLATES,
    IMAGENET_TEMPLATES,
    IMAGENET_TEMPLATES_SELECT,
)

from mudpt_torch import tokenizer as TTOK

TEMPLATES = sorted(set(IMAGENET_TEMPLATES + IMAGENET_TEMPLATES_SELECT
                       + list(CUSTOM_TEMPLATES.values())))
CLASSNAMES = [
    "cat", "great_white_shark", "Abyssinian", "Boeing 737-700", "2012 Tesla Model S",
    "Annual Crop Land", "apple_pie", "jack-o'-lantern", "crêpe", "Saint Bernard",
    "object number 42", "T-shirt", "yo-yo", "Pembroke Welsh Corgi", "pad thai",
    "Herbaceous Vegetation Land", "ApplyEyeMakeup", "faces_easy", "Ferrari 458 Italia",
    "Köln cathedral",
]


@pytest.mark.parametrize("template", TEMPLATES)
def test_templates_and_classnames_match_jax(template):
    j, t = JTOK.get_tokenizer(), TTOK.get_tokenizer()
    for name in CLASSNAMES:
        text = template.format(name.replace("_", " "))
        assert t.encode(text) == j.encode(text), text


def test_tokenize_table_matches_jax():
    texts = [f"a photo of a {n}." for n in CLASSNAMES] + ["word " * 100]
    np.testing.assert_array_equal(TTOK.tokenize(texts, truncate=True),
                                  JTOK.tokenize(texts, truncate=True))
    assert TTOK.tokenize(["hi"]).dtype == np.int32


def _pool():
    """Assigned code points of scripts both Unicode databases agree on:
    Latin, Greek, Cyrillic, Arabic, Devanagari, CJK, fullwidth forms, and
    general punctuation, currency and number forms."""
    ranges = [(0x21, 0x7E), (0xA1, 0x24F), (0x370, 0x3FF), (0x400, 0x4FF),
              (0x600, 0x6FF), (0x900, 0x97F), (0x2000, 0x206F), (0x20A0, 0x20BF),
              (0x2150, 0x218B), (0x3000, 0x303F), (0x4E00, 0x4F00), (0xFF01, 0xFF5E)]
    return [chr(c) for lo, hi in ranges for c in range(lo, hi + 1)
            if unicodedata.category(chr(c)) not in ("Cn", "Cs", "Co")]


def test_fuzz_matches_jax():
    j, t = JTOK.get_tokenizer(), TTOK.get_tokenizer()
    rng = np.random.RandomState(7)
    pool = _pool()
    spaces = [" ", "  ", "\t", "\n", " ", " ", "　", "\x1c"]
    for _ in range(400):
        parts = []
        for _ in range(rng.randint(1, 16)):
            r = rng.rand()
            if r < 0.55:
                parts.append("".join(pool[k] for k in rng.randint(0, len(pool), rng.randint(1, 8))))
            elif r < 0.75:
                parts.append(str(rng.randint(0, 10 ** 6)))
            elif r < 0.9:
                parts.append(spaces[rng.randint(len(spaces))])
            else:
                parts.append(["'s", "'ll", "'ve", "&amp;", "...", "<|endoftext|>"][rng.randint(6)])
        text = "".join(parts)
        assert t.encode(text) == j.encode(text), repr(text)
