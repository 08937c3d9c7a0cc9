"""Row-block streaming tree grower: out-of-core training.

Port of lightgbmv1_tpu/models/grower_stream.py (``StreamGrower``).  The
tree is the masked sequential grower's (models/grower.py
``make_leafwise_grower(partition=False)``, the reference's best-first
split order): the same function grows it, the split scan included
(``find_best_split``, the split-scan kernel on the card), with its two
O(N) passes handed to :class:`_StreamRows`, which folds them over row
blocks instead of a resident (F, N) matrix:

* the **root pass** folds each block's histogram into a running (F, B,
  3) accumulator (``ops/histogram.hist_one_leaf_accum``: on the card K1
  at one slot a block, ``acc + K1(block)``) and its row sums into the
  root sum (``sums_accum``, ``acc + root_sums(block)`` in block order);
* each **split pass** routes the block's rows through the split
  (``split_go_left`` on ``hist_cuda.bins_of_feat``, which reads a packed
  block's nibble) and folds the smaller child's histogram (and, with no
  histogram pool, the larger's) into its accumulator; the block's leaf
  ids go back to the host.

Both folds are exact at one block: a one-block stream is the resident
masked grower bit for bit on either device.  Past one block the K1 and
root-sum folds add the blocks' partials in block order: deterministic,
not the resident single pass (whose K1 chunks and reduction order
differ).  On the CPU the ``scatter`` fold continues the resident row
order, and a row-order root sum (the JAX package's scatter fold, which
the parity tests put in on both sides) makes a streamed model the
resident one byte for byte at any block count.

The blocks go host -> device double-buffered (``_BlockFeed``): pinned
host staging buffers, a copy ``torch.cuda.Stream``, ``non_blocking``
copies, and an event the compute stream waits on before it reads a
block; a staging buffer is reused only after its copy's event completed,
and a slot's device buffers only after the compute stream's event that
it finished the block.  Block i + 1 is staged and copied while the card
computes block i (``stream_prefetch``; off: one slot, each copy waits
for the last block's compute).  The leaf ids come back with
``non_blocking`` copies into a pinned host array, synchronised once at
the end of each pass (the host reads them only at the next pass).

Every device buffer is declared to the ``DeviceLedger``: the slots
(``block_bins``, ``block_g3``, ``block_lid``) for the tree's whole
growth, the accumulators (``hist_acc``) while they live, the pool
(``hist_pool``).  Trace spans (obs/trace.py): ``stream.fetch_block``
(the block read, digest check included), ``stream.h2d_block`` (staging
and the copies issued) and ``stream.accumulate`` (the block's compute
issued).
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import trace
from ..ops import histogram
from ..ops.hist_cuda import bins_of_feat, unpack4bit
from ..ops.split import FeatureMeta, SplitParams
from .grower import make_leafwise_grower, split_go_left


class _BlockFeed:
    """One pass's blocks on ``device``: ``run(g3_host, lid_host, fn)``
    calls ``fn(a, b, bins, g3, lid)`` for each block's rows [a, b) on
    device tensors (``lid`` None where ``lid_host`` is).  On the CPU the
    block tensors are the host rows themselves."""

    def __init__(self, source, device, prefetch: bool, ledger):
        self.source, self.device, self.ledger = source, device, ledger
        self.cuda = device.type == "cuda"
        self.nslots = 2 if prefetch else 1
        self.rows = max((b - a for a, b in source.ranges), default=0)
        self.fr = source.stored_features
        self.dtype = torch.from_numpy(
            np.zeros(0, source.block_dtype)).dtype
        self.itemsize = np.dtype(source.block_dtype).itemsize
        self.stages = []
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.stages = [torch.empty(self.fr * self.rows, dtype=self.dtype,
                                       pin_memory=True)
                           for _ in range(self.nslots)]
        self.slots = None
        self._handles = []

    def open(self):
        """The slots' device buffers, held for a tree's growth."""
        R, nb = self.rows, self.fr * self.rows
        for _ in range(self.nslots):
            self._handles += [
                self.ledger.hold("block_bins", nb * self.itemsize),
                self.ledger.hold("block_g3", 12 * R),
                self.ledger.hold("block_lid", 4 * R)]
        if not self.cuda:
            return
        dev = self.device
        self.slots = [dict(
            stage=self.stages[s],
            bins=torch.empty(nb, dtype=self.dtype, device=dev),
            g3=torch.empty(3 * R, dtype=torch.float32, device=dev),
            lid=torch.empty(R, dtype=torch.int32, device=dev),
            copied=torch.cuda.Event(), used=torch.cuda.Event())
            for s in range(self.nslots)]

    def close(self):
        self.slots = None
        for h in self._handles:
            self.ledger.release(h)
        self._handles = []

    def _upload(self, i, slot, g3_host, lid_host):
        a, b = self.source.ranges[i]
        n, fr = b - a, self.fr
        with trace.span("stream.fetch_block", cat="stream",
                        args={"block": i} if trace.enabled() else None):
            blk = self.source.load_block(i)
        with trace.span("stream.h2d_block", cat="stream",
                        args={"block": i} if trace.enabled() else None):
            # the staging buffer's last copy must have landed
            slot["copied"].synchronize()
            stage = slot["stage"][:fr * n]
            np.copyto(stage.numpy().reshape(fr, n), blk)
            with torch.cuda.stream(self.copy_stream):
                # the compute stream has finished the slot's last block
                self.copy_stream.wait_event(slot["used"])
                slot["bins"][:fr * n].copy_(stage, non_blocking=True)
                slot["g3"][:3 * n].copy_(g3_host[a:b].reshape(-1),
                                         non_blocking=True)
                if lid_host is not None:
                    slot["lid"][:n].copy_(lid_host[a:b], non_blocking=True)
                slot["copied"].record(self.copy_stream)

    def run(self, g3_host, lid_host, fn):
        ranges = self.source.ranges
        if not self.cuda:
            for i, (a, b) in enumerate(ranges):
                with trace.span("stream.fetch_block", cat="stream",
                                args={"block": i} if trace.enabled()
                                else None):
                    blk = self.source.load_block(i)
                with trace.span("stream.h2d_block", cat="stream",
                                args={"block": i} if trace.enabled()
                                else None):
                    bins = torch.tensor(blk)
                with trace.span("stream.accumulate", cat="stream",
                                args=({"block": i, "rows": b - a}
                                      if trace.enabled() else None)):
                    fn(a, b, bins, g3_host[a:b],
                       None if lid_host is None else lid_host[a:b])
            return
        compute = torch.cuda.current_stream(self.device)
        self._upload(0, self.slots[0], g3_host, lid_host)
        for i, (a, b) in enumerate(ranges):
            slot, n = self.slots[i % self.nslots], b - a
            compute.wait_event(slot["copied"])
            with trace.span("stream.accumulate", cat="stream",
                            args=({"block": i, "rows": n}
                                  if trace.enabled() else None)):
                fn(a, b, slot["bins"][:self.fr * n].view(self.fr, n),
                   slot["g3"][:3 * n].view(n, 3),
                   None if lid_host is None else slot["lid"][:n])
            slot["used"].record(compute)
            if i + 1 < len(ranges):
                self._upload(i + 1, self.slots[(i + 1) % self.nslots],
                             g3_host, lid_host)
        # the pass's leaf-id read-backs have landed, and no copy is left
        # reading the host rows
        compute.synchronize()


class _StreamRows:
    """The masked grower's passes (``MaskedRows``' interface) folded over
    the blocks of a ``_BlockFeed``; ``lid_host`` holds each row's leaf."""

    def __init__(self, grower, g3_host, lid_host):
        self.g = grower
        self.device, self.num_rows = grower.device, grower.source.num_rows
        self.g3_host, self.lid_host = g3_host, lid_host
        self._acc_handles = []

    def _fold(self, acc, bins, g3, lid, target):
        g = self.g
        if g.packed and g.method != "pallas":
            # scatter and onehot read byte bins: decode the block (exact)
            bins = unpack4bit(bins, g.F)
        return histogram.hist_one_leaf_accum(
            acc, bins, g3, lid, target, g.B, method=g.method,
            precision=g.precision,
            packed=g.packed and g.method == "pallas", num_features=g.F)

    def _hold_accs(self, n):
        for h in self._acc_handles:
            self.g.ledger.release(h)
        self._acc_handles = [self.g.ledger.hold("hist_acc",
                                                self.g.F * self.g.B * 12)
                             for _ in range(n)]

    def root(self):
        self._hold_accs(1)
        acc, rs = None, None

        def fn(a, b, bins, g3, lid):
            nonlocal acc, rs
            zeros = torch.zeros(b - a, dtype=torch.int32, device=g3.device)
            acc = self._fold(acc, bins, g3, zeros, 0)
            rs = histogram.sums_accum(rs, g3)

        self.g.feed.run(self.g3_host, None, fn)
        return acc, rs

    def split(self, leaf, nl, rule, lsum, rsum, need_large):
        sm_left = bool(lsum[2] <= rsum[2])
        small, large = (leaf, nl) if sm_left else (nl, leaf)
        self._hold_accs(2 if need_large else 1)
        acc_s = acc_l = None
        packed, lid_host = self.g.packed, self.lid_host
        cuda = self.device.type == "cuda"

        def fn(a, b, bins, g3, lid):
            nonlocal acc_s, acc_l
            gl = split_go_left(bins_of_feat(bins, rule[0], packed).long(),
                               *rule[1:])
            lid = torch.where((lid == leaf) & ~gl, torch.full_like(lid, nl),
                              lid)
            acc_s = self._fold(acc_s, bins, g3, lid, small)
            if need_large:
                acc_l = self._fold(acc_l, bins, g3, lid, large)
            lid_host[a:b].copy_(lid, non_blocking=cuda)

        self.g.feed.run(self.g3_host, lid_host, fn)
        return sm_left, acc_s, acc_l

    def leaf_ids(self):
        for h in self._acc_handles:
            self.g.ledger.release(h)
        self._acc_handles = []
        return self.lid_host.clone()


class StreamGrower:
    """``grow(binned, g3_host, base_mask, key=None, cegb_used=None) ->
    (tree, leaf_id_host, root_sum)`` over a block source (the trainer's
    grower interface; ``binned`` is unused and ``cegb_used`` refused
    upstream).  ``g3_host`` (N, 3) f32 on the host; the tree and root
    sum on ``device``, the leaf ids (N,) int32 on the host."""

    def __init__(self, *, source, ledger, device, num_leaves: int,
                 num_bins: int, meta: FeatureMeta, params: SplitParams,
                 max_depth: int = -1, feature_fraction_bynode: float = 1.0,
                 interaction_groups=None, hist_method: str = "scatter",
                 hist_precision: str = "bf16x2", hist_pool_mb: float = -1.0,
                 prefetch: bool = True):
        self.source, self.ledger = source, ledger
        self.device = torch.device(device)
        self.L, self.B = num_leaves, num_bins
        self.F = int(meta.num_bins.shape[0])
        self.method = self.hist_method = hist_method
        self.precision = hist_precision
        self.packed = source.bin_layout == "packed4"
        self._grow = make_leafwise_grower(
            num_leaves=num_leaves, num_bins=num_bins, meta=meta,
            params=params, hist_fn=None, max_depth=max_depth,
            partition=False, hist_pool_mb=hist_pool_mb, packed=self.packed,
            feature_fraction_bynode=feature_fraction_bynode,
            interaction_groups=interaction_groups)
        self.use_pool = self._grow.use_pool
        self.feed = _BlockFeed(source, self.device, prefetch, ledger)
        N = source.num_rows
        pin = self.device.type == "cuda"
        self._g3 = torch.empty((N, 3), dtype=torch.float32, pin_memory=pin)
        self._lid = torch.empty(N, dtype=torch.int32, pin_memory=pin)

    def __call__(self, binned, g3_host, base_mask, key=None,
                 cegb_used=None):
        self._g3.copy_(g3_host)
        self._lid.zero_()
        rows = _StreamRows(self, self._g3, self._lid)
        pool = (self.ledger.hold("hist_pool", self.L * self.F * self.B * 12)
                if self.use_pool else None)
        self.feed.open()
        try:
            tree, leaf_id, root_sum = self._grow(None, None, base_mask,
                                                 key=key, rows=rows)
        finally:
            self.feed.close()
            self.ledger.release(pool)
        return tree, leaf_id, root_sum
