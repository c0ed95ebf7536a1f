"""``qps``'s reading in a ``--trace 1`` run of the passage-search cell:
queries drained in the traced window over its wall seconds, the profiler
on.  That cell's untraced ``qps`` spreads by process past the largest bound
the benchmark allows, so it reports the rate here, per layer, beside
``window_p95_ms``."""

from portbench.manifest import HERE, load_reader

read = load_reader(HERE / "metrics" / "qps.py")
