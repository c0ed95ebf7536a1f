"""Tokenizers.

The reference library ships no tokenizer; users supply a callable
(`reference src/lib.rs:14`), and every reference test uses a
single-space splitter (`src/lib.rs:42-44`):

    s.split(' ').map(Cow::from).collect()

``whitespace_tokenizer`` reproduces that exactly: it splits on the single
space character only (NOT arbitrary whitespace, and it does NOT collapse
runs of spaces — empty tokens are produced and later filtered by the index,
`src/index.rs:100-110`, and counted but skipped by the query,
`src/query.rs:32-35`).
"""

from __future__ import annotations

from typing import Callable, List

Tokenizer = Callable[[str], List[str]]


def whitespace_tokenizer(s: str) -> List[str]:
    """Split on the single space character, exactly like Rust ``split(' ')``."""
    return s.split(" ")
