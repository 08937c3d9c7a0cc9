"""Out-of-core data: the sharded block cache and the streaming dataset.

The port's copy of lightgbmv1_tpu/data/:

* :mod:`.block_cache` — the on-disk format: the binned matrix written
  once as fixed-row-count block shards under a manifest (format version,
  per-block SHA-256 digests), each block loadable on its own.  A cache
  either package writes loads in the other.
* :mod:`.streaming` — :class:`StreamingDataset` (the ``BinnedDataset``
  surface over a cache, the row bulk left on disk), the block sources the
  row-block trainer (models/gbdt_stream.py) reads, and the
  :class:`DeviceLedger` of the trainer's device buffers.
"""

from .block_cache import (BLOCK_CACHE_MAGIC, BlockCacheError, is_block_cache,
                          load_manifest, manifest_bin_layout,
                          write_block_cache)
from .streaming import (DeviceLedger, InMemoryBlockSource, StreamingDataset,
                        block_source_for)

__all__ = [
    "BLOCK_CACHE_MAGIC", "BlockCacheError", "is_block_cache",
    "load_manifest", "manifest_bin_layout", "write_block_cache",
    "StreamingDataset", "InMemoryBlockSource", "DeviceLedger",
    "block_source_for",
]
