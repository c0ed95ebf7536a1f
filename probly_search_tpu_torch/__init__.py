"""probly_search_tpu_torch — the BM25 serving path of probly-search on a
CUDA card, in PyTorch with hand-written CUDA kernels.

Counterpart of ``probly_search_tpu`` (the JAX package, which stays the
reference).  The host layers are shared by import: ``Index``, its segments
and native build, ``IndexConfig``, the tokenizers and the f64 oracle
``Index.query``.  The device path is the port's own:

    from probly_search_tpu_torch import DeviceIndex, Index, IndexConfig, bm25
    dix = DeviceIndex(ix, device="cuda")
    scores, slots, keys = dix.query_batch_async(queries, bm25.new()).get_arrays()

This package imports torch and never JAX.
"""

from probly_search_tpu import Index, IndexConfig, whitespace_tokenizer

from .index.device import DeviceIndex, PendingBatch
from .models import bm25

__all__ = [
    "DeviceIndex",
    "PendingBatch",
    "Index",
    "IndexConfig",
    "bm25",
    "whitespace_tokenizer",
]
