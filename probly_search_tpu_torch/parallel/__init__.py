"""Doc-sharded serving over a ("data", "docs") grid of torch devices.

Counterpart of ``probly_search_tpu/parallel``: each doc shard owns the
postings of the doc slots congruent to its shard id, every shard scores its
own postings with the single-device kernels, and the shards' top-k rows are
gathered onto the data row's first device and merged there.  A second axis,
"data", splits the query batch.
"""

from .dist_query import ShardedDeviceIndex, ShardedPendingBatch
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "ShardedDeviceIndex", "ShardedPendingBatch", "make_mesh"]
