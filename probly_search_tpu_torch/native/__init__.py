"""Native host runtime (C++ via ctypes; no pybind11 in this environment).

Builds lazily with g++ on first use into ``build/torch_native/`` (see
``build.py``).  Everything here has a pure-Python fallback, so the package
works without a compiler — the native path is a host-throughput
optimization for the indexing pipeline (the analogue of the reference's
Rust hot loop, `reference src/index.rs:90-157`).
"""

from .build import (
    get_lib,
    intern_csr_multi_native,
    native_available,
    tokenize_csr_multi_native,
    tokenize_csr_native,
    tokenize_index_native,
)

__all__ = [
    "get_lib",
    "intern_csr_multi_native",
    "native_available",
    "tokenize_csr_multi_native",
    "tokenize_csr_native",
    "tokenize_index_native",
]
