from .base import Tokenizer, TokenType, Vocab, split_on_special
from .bpe import BPETokenizer
from .factory import tokenizer_from_metadata, vocab_from_metadata
from .spm import SPMTokenizer
from .stream import StreamDecoder

__all__ = [
    "BPETokenizer",
    "SPMTokenizer",
    "StreamDecoder",
    "TokenType",
    "Tokenizer",
    "Vocab",
    "split_on_special",
    "tokenizer_from_metadata",
    "vocab_from_metadata",
]
