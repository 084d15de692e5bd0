"""Batch tokenization to fixed-length (n, 77) int32 arrays (a copy of
``mudpt_tpu/tokenizer/tokenize.py``).

[SOT] + bpe(text) + [EOT], zero-padded to the context length; over-long
inputs raise unless ``truncate=True``, in which case the sequence is cut
and the last slot forced to EOT.  Output is numpy int32, so the JAX package
and the port can be fed the same table.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from mudpt_torch.tokenizer.bpe import get_tokenizer

CONTEXT_LENGTH = 77
SOT_TOKEN = 49406
EOT_TOKEN = 49407


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
) -> np.ndarray:
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids: List[int] = [tok.sot] + tok.encode(text) + [tok.eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = tok.eot
        out[i, : len(ids)] = ids
    return out
