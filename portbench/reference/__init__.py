"""The plain reference: BM25 over an inverted index of its own, in numpy.
It imports neither JAX nor any package of this repository's
programs, and takes nothing the program made: only the generated token ids
and the query words."""

from .index import ReferenceIndex, rank, rounder
from .scorers import bm25

__all__ = ["ReferenceIndex", "rank", "rounder", "bm25"]
