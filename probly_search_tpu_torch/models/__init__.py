"""Scoring models of the torch port (BM25 only; zero-to-one is ROADMAP M7)."""

from . import bm25

__all__ = ["bm25"]
