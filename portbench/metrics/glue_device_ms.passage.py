"""``glue_device_ms.bm25``'s reading, in the passage-search cell, where it moves
``window_p95_ms`` (that cell reports no ``qps`` end to end)."""

from portbench.manifest import HERE, load_reader

read = load_reader(HERE / "metrics" / "glue_device_ms.bm25.py")
