"""Device operations of the torch port: the torch merge (``merge``), and the
hand-written CUDA kernels, each beside its plain torch version: the fused
BM25 query (``fused_query``, K1 and K3), the fused zero-to-one query
(``fused_z2o``, K4), the standalone merge (``fused_merge``, K5) and the
launch probe (``launch_probe``, P1)."""
