"""probly_search_tpu_torch — probly-search on a CUDA card, in PyTorch with
hand-written CUDA kernels.

Counterpart of ``probly_search_tpu`` (the JAX package, which stays the
reference).  The port keeps its own copies of the host layers: ``Index``, its
segments and native build, snapshots, ``IndexConfig``, the tokenizers, the
scorers' host halves and the f64 oracle ``Index.query``.  Their state equals
the JAX package's bit for bit, and ``index.snapshot`` carries an index saved
by either package into the other.  The device path is the port's own:

    from probly_search_tpu_torch import Index, bm25, zero_to_one
    ix = Index(1)                      # device="cuda" unless asked otherwise
    ix.add_documents_columnar(keys, [texts])
    rows = ix.query_batch(queries, zero_to_one.new(), top_k=10)
    scores, slots, keys = ix.query_batch_async(queries, bm25.new()).get_arrays()

This package imports torch and never JAX, nor anything of the JAX package.
"""

from .config import HostFallbackError, IndexConfig
from .index.core import DocumentDetails, DocumentPointer, FieldDetails, Index, QueryResult
from .index.device import DeviceIndex, PendingBatch
from .models import bm25, zero_to_one
from .models.base import FieldData, ScoreCalculator, TermData
from .utils.tokenizers import whitespace_tokenizer

__all__ = [
    "DeviceIndex",
    "PendingBatch",
    "Index",
    "IndexConfig",
    "HostFallbackError",
    "QueryResult",
    "DocumentDetails",
    "DocumentPointer",
    "FieldDetails",
    "ScoreCalculator",
    "TermData",
    "FieldData",
    "bm25",
    "zero_to_one",
    "whitespace_tokenizer",
]
