"""``capture_ms.bm25``'s reading in a zero-to-one cell: the CUDA graph
captures of its class graphs (``ClassGraphs._capture`` under
``Z2OClassKey``) inside the measured window, ``captures`` beside it."""

from portbench.manifest import HERE, load_reader

read = load_reader(HERE / "metrics" / "capture_ms.bm25.py")
