"""``drain_self_ms.bm25``'s reading, in the zero-to-one cell: ``query/drain``
self time, decoding the drained rows and splicing in the host rows."""

from portbench.manifest import HERE, load_reader

read = load_reader(HERE / "metrics" / "drain_self_ms.bm25.py")
