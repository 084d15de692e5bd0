from mudpt_torch.tokenizer.bpe import ClipBPE, get_tokenizer
from mudpt_torch.tokenizer.tokenize import tokenize, SOT_TOKEN, EOT_TOKEN, CONTEXT_LENGTH

__all__ = [
    "ClipBPE",
    "get_tokenizer",
    "tokenize",
    "SOT_TOKEN",
    "EOT_TOKEN",
    "CONTEXT_LENGTH",
]
