"""Scoring models of the torch port: the scorer protocol (``base``), BM25 and
zero-to-one, each with a ``new()`` factory as in the JAX package."""

from . import bm25, zero_to_one
from .base import FieldData, ScoreCalculator, TermData

__all__ = ["bm25", "zero_to_one", "ScoreCalculator", "TermData", "FieldData"]
