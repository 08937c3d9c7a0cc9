"""StreamingDataset, the block sources and the device-byte ledger.

The port's copy of lightgbmv1_tpu/data/streaming.py.

:class:`StreamingDataset` subclasses ``io.dataset.BinnedDataset`` with
``binned=None``: it presents the surface the trainer reads (``num_data``,
the feature metadata, the bin mappers, label / weight / group) while the
row bulk stays on disk in the block cache (data/block_cache.py), each
block digest-checked at every load.

:class:`InMemoryBlockSource` cuts a resident ``BinnedDataset`` into the
same blocks: ``stream_enable=true`` on in-memory data runs the same
trainer (the parity tests' streamed side, and a bound on the device
working set where the host holds rows the card cannot).

:class:`DeviceLedger` is the account behind the memory contract: the
streaming trainer declares every device buffer it makes, by tag
(``TAGS``), and releases it when it retires; ``peak_bytes`` is held to
scale with ``stream_block_rows``, not with the rows, by
tests/test_torch_stream_train.py and chip_smoke.py's streaming phase.
``bag_mask`` is the JAX package's device draw of the bagging mask; the
port draws that mask on the host (the threefry stream gives the same
bits on either device), so nothing is held under it.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..io.dataset import BinnedDataset, Metadata, mappers_from_sections
from ..utils.log import log_info
from .block_cache import (BlockCacheError, load_manifest,
                          manifest_bin_layout, read_block,
                          read_meta_arrays, shard_blocks, unpack4bit,
                          validate_block_table)

_peak_gauge = None


def _obs_peak_gauge():
    global _peak_gauge
    if _peak_gauge is None:
        from ..obs.metrics import default_registry

        _peak_gauge = default_registry().gauge(
            "stream_peak_device_bytes",
            "Ledger-accounted peak streaming device working set")
    return _peak_gauge


class DeviceLedger:
    """Named device-byte accounting of the streaming trainer: block
    uploads (``block_bins``, ``block_g3``, ``block_lid``), the gradient
    pass's blocks (``grad_block``), the histogram accumulators
    (``hist_acc``) and the leaf-sized pool (``hist_pool``).  A new peak
    sets the ``stream_peak_device_bytes`` gauge."""

    TAGS = ("block_bins", "block_g3", "block_lid", "grad_block", "hist_acc",
            "hist_pool", "bag_mask")

    def __init__(self):
        self._live: Dict[int, Tuple[str, int]] = {}
        self._next = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_tags: Dict[str, int] = {}

    def hold(self, tag: str, nbytes: int) -> int:
        if tag not in self.TAGS:
            raise ValueError(f"ledger tag {tag!r}: expected one of "
                             f"{self.TAGS}")
        h = self._next
        self._next += 1
        self._live[h] = (tag, int(nbytes))
        self.live_bytes += int(nbytes)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            by_tag: Dict[str, int] = {}
            for t, b in self._live.values():
                by_tag[t] = by_tag.get(t, 0) + b
            self.peak_tags = by_tag
            _obs_peak_gauge().set(self.peak_bytes)
        return h

    def hold_tensor(self, tag: str, t) -> int:
        return self.hold(tag, t.element_size() * t.numel())

    def release(self, handle: Optional[int]) -> None:
        if handle is None or handle not in self._live:
            return
        _, b = self._live.pop(handle)
        self.live_bytes -= b

    def reset(self) -> None:
        self._live.clear()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_tags = {}


class _BlockSource:
    """Blocks of contiguous rows as host arrays.  ``bin_layout`` is the
    stored layout: ``u8`` blocks are (F, rows) bins, ``packed4`` blocks
    the (ceil(F/2), rows) bytes, which the trainer uploads as they are
    (K1 and the routing read the nibbles)."""

    num_rows: int = 0
    num_features: int = 0
    block_dtype = np.uint8
    block_rows: int = 0
    bin_layout: str = "u8"
    ranges: List[Tuple[int, int]] = []

    def load_block(self, index: int) -> np.ndarray:
        raise NotImplementedError

    @property
    def num_blocks(self) -> int:
        return len(self.ranges)

    @property
    def stored_features(self) -> int:
        """The rows of a stored block: F, or ceil(F/2) packed."""
        if self.bin_layout == "packed4":
            return -(-self.num_features // 2)
        return self.num_features


class InMemoryBlockSource(_BlockSource):
    """A resident (F, N) matrix cut into blocks of ``block_rows`` rows
    (``stream_enable=true`` on in-memory data)."""

    def __init__(self, binned: np.ndarray, block_rows: int):
        if block_rows < 1:
            raise ValueError("stream_block_rows must be >= 1")
        self._binned = binned
        F, N = binned.shape
        self.num_rows = N
        self.num_features = F
        self.block_dtype = binned.dtype
        self.block_rows = int(block_rows)
        self.ranges = [(a, min(a + block_rows, N))
                       for a in range(0, N, block_rows)]

    def load_block(self, index: int) -> np.ndarray:
        a, b = self.ranges[index]
        return self._binned[:, a:b]


class _CacheBlockSource(_BlockSource):
    """The blocks of a cache on disk, or (``shard=(rank, world)``) of one
    host shard's contiguous block run, its rows re-based to [0, rows)."""

    def __init__(self, path: str, manifest: dict, shard=None):
        self._path = path
        self._manifest = manifest
        self.num_features = int(manifest["num_features"])
        self.block_dtype = np.dtype(manifest["dtype"])
        self.bin_layout = manifest_bin_layout(manifest)
        self.block_rows = int(manifest["block_rows"])
        full = validate_block_table(path, manifest)
        if shard is None:
            self._block0 = self._row0 = 0
            self.num_rows = int(manifest["num_rows"])
            self.ranges = full
        else:
            sh = shard_blocks(manifest, shard[0], shard[1], path=path)
            self._block0 = sh["block_lo"]
            self._row0 = sh["row_begin"]
            self.num_rows = sh["row_end"] - sh["row_begin"]
            self.ranges = [(a - self._row0, b - self._row0)
                           for a, b in full[sh["block_lo"]:sh["block_hi"]]]

    @property
    def shard_row_range(self):
        """The global (row_begin, row_end) this source covers."""
        return self._row0, self._row0 + self.num_rows

    def load_block(self, index: int) -> np.ndarray:
        if not 0 <= index < len(self.ranges):
            raise BlockCacheError(
                f"{self._path}: shard-local block index {index} out of "
                f"range (this shard holds {len(self.ranges)} blocks)")
        return read_block(self._path, self._manifest, self._block0 + index)


class StreamingDataset(BinnedDataset):
    """A ``BinnedDataset`` over a block cache: the feature metadata and
    the label rows resident, the bins loaded block by block (``binned``
    is None, as for sparse input).  ``shard=(rank, world)`` opens one
    host shard: its block run, its metadata rows, ``num_data`` its row
    count."""

    is_streaming = True

    def __init__(self, path: str, shard=None):
        self.cache_path = str(path)
        manifest = load_manifest(self.cache_path)
        z = read_meta_arrays(self.cache_path, manifest)
        mappers = mappers_from_sections(z)
        if len(mappers) != int(manifest["num_features"]):
            raise BlockCacheError(
                f"{path}: meta shard has {len(mappers)} mappers, manifest "
                f"says {manifest['num_features']} features")
        source = _CacheBlockSource(self.cache_path, manifest, shard=shard)
        r0, r1 = source.shard_row_range
        n_total = int(manifest["num_rows"])
        meta = Metadata()
        if z["group"].size:
            if shard is not None:
                raise BlockCacheError(
                    f"{path}: host-sharded streaming of ranking data is "
                    "not supported (query-aligned sharding is not wired)")
            meta.set_group(z["group"])
        if z["label"].size:
            meta.label = z["label"][r0:r1].astype(np.float32)
        if z["weight"].size:
            meta.weight = z["weight"][r0:r1].astype(np.float32)
        if z["init_score"].size:
            k = max(1, z["init_score"].size // max(n_total, 1))
            meta.init_score = z["init_score"].reshape(n_total, k)[
                r0:r1].ravel()
        super().__init__(None, mappers, meta,
                         feature_names=[str(s) for s in z["feature_names"]],
                         max_bin=int(z["max_bin"]), num_data=r1 - r0)
        self.source = source
        self.manifest = manifest
        self.shard = shard
        self.shard_row_range = (r0, r1)
        log_info(f"Opened block cache {path}: {self.num_data} rows"
                 + (f" (host shard {shard[0]}/{shard[1]}, global rows "
                    f"[{r0}, {r1}))" if shard is not None else "")
                 + f", {self.num_features} features, "
                 f"{source.num_blocks} blocks")

    @property
    def train_matrix(self):
        # the trainer must never take the matrix whole
        return None

    def iter_blocks(self) -> Iterator[Tuple[int, int, np.ndarray]]:
        for i, (a, b) in enumerate(self.source.ranges):
            yield a, b, self.source.load_block(i)

    def materialize(self) -> BinnedDataset:
        """The resident ``BinnedDataset`` of the same rows (tests, small
        data); a packed cache's bins come back as (F, N) bytes."""
        full = np.empty((self.source.stored_features, self.num_data),
                        dtype=self.source.block_dtype)
        for a, b, blk in self.iter_blocks():
            full[:, a:b] = blk
        if self.source.bin_layout == "packed4":
            full = unpack4bit(full, self.num_features)
        return BinnedDataset(full, self.bin_mappers, self.metadata,
                             feature_names=list(self.feature_names),
                             max_bin=self.max_bin)


def block_source_for(train_set, block_rows: int) -> _BlockSource:
    """The trainer's blocks: a ``StreamingDataset``'s cache, or a resident
    dense ``BinnedDataset`` cut at ``stream_block_rows``."""
    if getattr(train_set, "is_streaming", False):
        return train_set.source
    if train_set.binned is None:
        raise BlockCacheError(
            "stream_enable requires dense bins (EFB bundle-only sparse "
            "datasets are not streamable)")
    return InMemoryBlockSource(train_set.binned, block_rows)
