from .tokenizers import whitespace_tokenizer

__all__ = ["whitespace_tokenizer"]
