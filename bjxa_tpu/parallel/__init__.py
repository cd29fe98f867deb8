"""Multi-device / multi-host scaling layer.

The reference is single-threaded by design (``bjxa.3.rst.in:278-283``); this
package is where the device build diverges: corpora shard over a device mesh
(data parallel over files), and a single huge stream shards its block range
over devices with only the two-int16-per-channel predictor state crossing
shard boundaries (sequence parallel), exchanged with ``lax.ppermute`` and
iterated to an exact fixed point.  Multi-process (multi-host) corpus jobs
wire up through :mod:`bjxa_tpu.parallel.distributed`.
"""

from bjxa_tpu.parallel import distributed
from bjxa_tpu.parallel.mesh import make_mesh, dp_sharding
from bjxa_tpu.parallel.sharded import decode_file_sharded, decode_corpus_sharded

__all__ = [
    "distributed",
    "make_mesh",
    "dp_sharding",
    "decode_file_sharded",
    "decode_corpus_sharded",
]
