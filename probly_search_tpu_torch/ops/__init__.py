"""Device operations of the torch port: the torch merge (``merge``) and the
fused BM25 query kernel with its plain version (``fused_query``)."""
