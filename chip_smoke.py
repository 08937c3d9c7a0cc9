#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--rows 1048576] [--requests 500]
                          [--train-rows 1048576] [--iters 50]

Phases (any failure exits non-zero with no ``ok`` line):

1. device   — the card's name and power limit (nvidia-smi), torch/CUDA.
2. build    — nvcc builds ``lightgbmv1_tpu_torch/csrc/*.cu`` (one process
              per source, all started together); build seconds and the
              ptxas register/shared-memory lines.
3. model    — a synthetic full-width model from ``--seed``: binary, 500
              trees of 255 leaves grown leaf-wise by splitting random
              leaves, 28 features, thresholds from a fixed 63-value grid
              per feature, mixed missing types and default_left, small
              leaf values, no threshold inside +-kZeroThreshold.  Written
              as v3 model text by the port's ``model_to_string`` and
              loaded with ``Booster(model_file=...)`` on ``cuda``.
4. kernels  — each kernel against its plain PyTorch version on the card:
              K4 scores (raw, sigmoid), K4 leaf, K4 on uint16/int32 codes,
              K4 packed codes (a second model with <= 13 thresholds a
              feature), K4 with K = 3 and softmax (a 60-tree model), and
              K5.  Leaves exact; raw scores within
              1e-6 * sum_t max_l |leaf_value| + 1e-7; transformed 1e-6.
5. bulk     — the main path, launch counts reset first:
              ``Booster.predict(X, predict_method="fused", raw_score=True)``
              on ``--rows`` rows with NaNs and zeros, ``pred_leaf`` on a
              16,384-row subset, and ``predict_method="pallas"``; checked
              against the numpy HostTree oracle on a subset.
6. server   — ``Server`` with predict_method=fused answers ``--requests``
              requests of 1-256 rows from 8 threads, with one publish and
              one rollback in mid-traffic; every answer checked against
              ``Booster.predict`` of the version it names.
7. launches — both kernels' counts moved in phases 5-6, the fused plan is
              eligible; then each kernel is timed (CUDA events) at the
              main path's chunk shape beside its plain version and its
              bound.
8. data     — ``--train-rows`` x 28 training rows and 131,072 valid rows
              from the port's copy of bench.py:42 make_data, binned at
              max_bin=63 (B = 64) by ``Dataset.construct``.
9. K1       — the histogram kernel against its plain versions on the card
              at F = 28, N = --train-rows, B = 64, L in {2, 5, 17, 64} on
              signed, varied rows, and at N = 4,096, L = 64, in each of
              bf16x2 / bf16 / f32: bit for bit the row-order version
              (``hist_leaves_roworder_ref``: each chunk's cell summed in
              row order from 0, the chunks in order, hi and lo apart);
              against the index_add_ version counts exact and every cell
              of n rows within 2 (n + 1) 2^-24 of its absolute sum
              (+1e-6; the f32 bound of a sum of n terms, for each side);
              two launches on the same input bitwise equal; with the last
              slot dead (``live_slots = L - 1``) the other slots' cells
              bitwise the all-live ones and the dead slot +0.0.  Each case
              names the pairs of precisions the tolerance tells apart;
              the small case must tell all three apart.
10. train   — the training main path, launch counts reset first:
              ``train`` on the headline configuration (binary, 255 leaves,
              max_bin 63, defaults) for ``--iters`` iterations with the
              valid set; K1 launched (its launches by slot count and
              precision add up) and no plain histogram; s/iter,
              M row-trees/s, the held-out AUC (> 0.90) and the model
              text's sha256 and length.  Then K1 is held to its plain
              versions, as in phase 9, on the inputs of the path's last
              call at each slot count (with the call's live slots).  The
              saved model text is loaded by ``Booster(model_file=...)``
              and serves the valid rows through K4 within the serving
              tolerance of the trainer's own valid scores.
11. parity  — 65,536 x 28 rows, 63 leaves in waves of 32 (slot buckets
              {4, 16, 32}, deep rounds), hist_dtype=f32, 5 iterations, on
              the card and on the CPU (plain versions): split features
              and threshold bins identical at every node of every tree.
12. timing  — K1 at each slot bucket of the main path (its own last
              inputs, recorded in phase 10) beside its plain version, one
              ``index_add_`` and its bound.
13. profile — five headline iterations under torch.profiler: device time
              by kernel and the device's busy share.
14. K2/K3   — the fused round K2 and the valid routing K3 against their
              plain versions on the card, on phase 8's bins with signed,
              varied rows: S in {4, 16, 63} in subtraction mode and S = 63
              pool-free, each in bf16x2 / bf16 / f32.  New leaf ids,
              labels and K3 exact (K3 also equal to K2's own new leaf
              ids); hsmall bitwise equal to K1 on the emitted label; the
              residue against the plain scan run on the CPU on the same
              histograms (bitwise equality reported) and against the
              plain version on the card: picks identical outside ties,
              values within four tie bands; two launches bitwise equal.
15. fused   — the fused training main path, launch counts reset first:
              ``train`` at the headline configuration with
              ``hist_method=fused`` for ``--iters`` iterations with the
              valid set.  K2 launched once a non-root round (its launches
              by bucket add up), K3 once a round, K1 once a tree, no plain
              version called; s/iter, M row-trees/s, AUC > 0.90 and within
              2e-3 of phase 10's, the model text's sha256 and length; the
              saved model served through K4.  K2
              held to its plain version on the path's last inputs.
16. parity  — phase 11's configuration on the card, ``hist_method=fused``
              against ``pallas``: the same split feature and threshold at
              every node of every tree; the largest leaf-value difference.
17. timing  — K2 at each slot bucket and K3 on the main path's last
              inputs, beside their plain versions and bounds.
18. profile — five fused headline iterations, as phase 13.
19. K6      — the persistent wave loop's plan at the headline shape
              (eligible), then K6 on the headline bins and phase 14's
              signed, varied rows from a frontier captured after the root
              and two single rounds of a headline tree grown on them,
              R = 4, subtraction and pool-free, bf16x2 and f32:
              against R launches of K2 with the PyTorch pick and replay
              (packed rows, leaf ids, pool and split counts bitwise, and
              two launches bitwise equal) and against its plain version
              on the card (split counts exact; picks identical outside the
              tie band; gains and sums within phase 14's bounds; leaf ids
              exact while the picks agree).
20. looped  — the looped training main path, launch counts reset first:
              ``train`` at the headline configuration with
              ``hist_method=fused, hist_dtype_deep=bf16x2,
              wave_loop_rounds=4`` for ``--iters`` iterations with the
              valid set.  K6 launched once a segment (at least once a
              tree), K2 never, K3 once a replayed round, K1 once a tree, no
              plain version; the model text byte-identical to the single
              round's with the same knobs, trained in the same phase (one
              run each: s/iter, M row-trees/s); AUC > 0.90; the model
              text's sha256 and length; the model served through K4.
21. timing  — K6 on the main path's last inputs beside its plain version,
              R K2 rounds on the same inputs and its bound; five looped
              iterations profiled, as phase 13; then the ``kernels`` line
              (K1, K2, K3, K6, K4, K5) is printed.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from lightgbmv1_tpu_torch import Booster, Dataset, train
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.binning import (K_ZERO_THRESHOLD, MISSING_NAN,
                                             MISSING_ZERO)
from lightgbmv1_tpu_torch.io.model_text import model_to_string
from lightgbmv1_tpu_torch.models import grower_wave
from lightgbmv1_tpu_torch.models.predict import BatchPredictor
from lightgbmv1_tpu_torch.models.tree import HostTree
from lightgbmv1_tpu_torch.ops import _build, hist_cuda as hc
from lightgbmv1_tpu_torch.ops import fused_cuda as fc
from lightgbmv1_tpu_torch.ops import loop_cuda as lc
from lightgbmv1_tpu_torch.ops import predict_cuda as pc
from lightgbmv1_tpu_torch.ops import wave_fused as wf
from lightgbmv1_tpu_torch.ops.split import (TIE_RTOL, SplitParams,
                                            gain_shift, make_feature_meta,
                                            scan_direction_gains,
                                            scan_left_sums)
from lightgbmv1_tpu_torch.parallel.trainer import build_trainer
from lightgbmv1_tpu_torch.serve import ServeConfig, Server

F = 28                      # features of the bench headline model
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# 4-byte shared-memory / L1 gathers a second: 132 SMs x 32 banks x
# 1.98 GHz boost clock (Hopper: 32 banks of 4 B per SM per clock)
GATHERS_PER_S = 132 * 32 * 1.98e9
SRC = "lightgbmv1_tpu_torch/csrc/predict_walk.cu"
HIST_SRC = "lightgbmv1_tpu_torch/csrc/hist.cu"
FUSED_SRC = "lightgbmv1_tpu_torch/csrc/wave_fused.cu"
LOOP_SRC = "lightgbmv1_tpu_torch/csrc/wave_loop.cu"
# the bench headline training configuration (root PERF.md "Headline"):
# binary, 255 leaves (waves of 63, slot buckets {4, 16, 63}), max_bin 63
# (a 64-bin axis), every other knob at its default
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
                "metric": "auc,binary_logloss", "verbosity": -1}
FUSED_PARAMS = dict(TRAIN_PARAMS, hist_method="fused")
VALID_ROWS = 131072


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# synthetic model
# ---------------------------------------------------------------------------


def make_trees(rng, n_trees, n_leaves, n_features, grid):
    """Trees grown leaf-wise by splitting a random existing leaf (the new
    leaf goes right, the split leaf keeps its index on the left — the
    reference's numbering); features, grid thresholds, missing types and
    default_left drawn at random."""
    trees = []
    n_nodes = n_leaves - 1
    for _ in range(n_trees):
        lc = np.zeros(n_nodes, np.int32)
        rc = np.zeros(n_nodes, np.int32)
        parent = np.full(n_leaves, -1, np.int64)   # node holding each leaf
        is_right = np.zeros(n_leaves, bool)
        for node in range(n_nodes):
            leaf = rng.randint(node + 1)           # leaves 0..node exist
            p = parent[leaf]
            if p >= 0:
                (rc if is_right[leaf] else lc)[p] = node
            lc[node], rc[node] = ~leaf, ~(node + 1)
            parent[leaf], is_right[leaf] = node, False
            parent[node + 1], is_right[node + 1] = node, True
        feat = rng.randint(n_features, size=n_nodes).astype(np.int32)
        thr = grid[feat, rng.randint(grid.shape[1], size=n_nodes)]
        leaf_count = rng.randint(1, 1000, size=n_leaves)
        trees.append(HostTree(
            n_leaves, split_feature=feat, threshold=thr,
            default_left=rng.rand(n_nodes) < 0.5,
            missing_type=rng.randint(3, size=n_nodes).astype(np.int32),
            left_child=lc, right_child=rc,
            split_gain=rng.rand(n_nodes) * 10.0,
            internal_value=rng.randn(n_nodes) * 0.02,
            internal_weight=rng.rand(n_nodes) * 100.0,
            internal_count=rng.randint(2, 2000, size=n_nodes),
            leaf_value=rng.randn(n_leaves) * 0.02,
            leaf_weight=rng.rand(n_leaves) * 50.0,
            leaf_count=leaf_count, leaf_parent=parent.astype(np.int32)))
    return trees


def make_model(seed, n_trees=500, n_leaves=255, n_grid=63, num_class=1):
    """v3 model text of a synthetic ensemble (binary, or multiclass with
    ``num_class`` trees an iteration) and its trees."""
    rng = np.random.RandomState(seed)
    grid = np.sort(rng.standard_normal((F, n_grid)), axis=1)
    check((np.abs(grid) > K_ZERO_THRESHOLD).all(), "threshold in the zero band")
    trees = make_trees(rng, n_trees, n_leaves, F, grid)
    objective = ("binary sigmoid:1" if num_class == 1
                 else f"multiclass num_class:{num_class}")
    text = model_to_string(
        trees, objective_string=objective, num_class=num_class,
        num_tree_per_iteration=num_class,
        feature_names=[f"Column_{i}" for i in range(F)],
        feature_infos=["[-5:5]"] * F)
    return text, trees


def make_rows(rng, n):
    X = rng.standard_normal((n, F))
    X[rng.rand(n, F) < 0.10] = np.nan
    X[rng.rand(n, F) < 0.05] = 0.0
    return X


def raw_tol(trees) -> float:
    return 1e-6 * sum(float(np.abs(t.leaf_value).max()) for t in trees) + 1e-7


def leaf_depths(trees, L):
    """(T, L) decisions from the root to each leaf."""
    out = np.zeros((len(trees), L), np.int64)
    for ti, t in enumerate(trees):
        stack = [(0, 0)] if t.num_leaves > 1 else []
        while stack:
            nd, d = stack.pop()
            for c in (int(t.left_child[nd]), int(t.right_child[nd])):
                if c >= 0:
                    stack.append((c, d + 1))
                else:
                    out[ti, ~c] = d + 1
    return out


def walk_loads(tables, codes, n_steps, zero_code, nan_code,
               chunk=16384):
    """Leaf ids, steps and four-byte table/code loads of every (row, tree)
    walk of ``codes``, counted as walk_tree in predict_walk.cu makes
    them: each step loads the split feature, the row's code, the missing
    type and the child; then default_left for a missing value, else the
    threshold bin and, for a NaN or zero code, the zero bin (5 or 6)."""
    T, L1 = tables.split_feature.shape
    off = torch.arange(T, device=codes.device)[None, :] * L1
    feat, tbin, zbin, dl, mt, lc, rc = (a.reshape(-1) for a in tables[1:8])
    root = (tables.num_leaves > 1).long() - 1          # 0, or -1: leaf 0
    leaves, steps, loads = [], 0, 0
    for lo in range(0, codes.shape[0], chunk):
        c = codes[lo: lo + chunk].long()
        node = root.expand(c.shape[0], T)
        for _ in range(max(int(n_steps), 1)):
            act = node >= 0
            i = node.clamp(min=0) + off
            b = torch.gather(c, 1, feat[i].long())
            is_nan = b == nan_code
            special = is_nan | (b == zero_code)
            m = mt[i]
            missing = torch.where(m == MISSING_NAN, is_nan,
                                  (m == MISSING_ZERO) & special)
            left = torch.where(missing, dl[i] != 0,
                               torch.where(special, zbin[i], b) <= tbin[i])
            steps += int(act.sum())
            loads += int((act & ~missing & special).sum())
            node = torch.where(act, torch.where(left, lc[i], rc[i]).long(),
                               node)
        leaves.append((-node - 1).to(torch.int32))
    return torch.cat(leaves), steps, 5 * steps + loads


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def phase_kernels(models, dev, n_rows, rng) -> dict:
    """Each kernel against its plain version on the same card inputs;
    returns the max abs score error per kernel."""
    err = {"serving_fused": 0.0, "serving_leaf": 0.0}
    X = make_rows(rng, n_rows)
    for name, (text, trees, K, method_kw) in models.items():
        bp = BatchPredictor(trees, K, F, method="fused", device=dev,
                            **method_kw)
        check(bp.fused_plan["eligible"], f"{name}: fused plan refused "
              f"({bp.fused_plan['reason']})")
        codes = torch.from_numpy(bp.encode(X)).to(dev)
        kw = dict(n_steps=bp.depth, zero_code=bp.binner.zero_code,
                  nan_code=bp.binner.nan_code, K=K,
                  tree_tile=bp.fused_plan["tree_tile"], packed=bp.packed)
        tol = raw_tol(trees)
        transforms = [None, "sigmoid"] if K == 1 else [None, "softmax"]
        for tr in transforms:
            got = pc.serving_fused(bp._fused_tables, codes, transform=tr, **kw)
            want = pc.serving_fused_ref(bp._fused_tables, codes,
                                        transform=tr, **kw)
            e = max_err(got, want)
            limit = tol if tr is None else 1e-6
            log(f"  K4 {name} scores[{tr or 'raw'}] max_abs_err={e:.3e} "
                f"(tol {limit:.3e})")
            check(e <= limit, f"K4 {name} {tr}: {e} > {limit}")
            err["serving_fused"] = max(err["serving_fused"], e)
        got = pc.serving_fused(bp._fused_tables, codes, mode="leaf", **kw)
        want = pc.serving_fused_ref(bp._fused_tables, codes, mode="leaf", **kw)
        check(torch.equal(got, want), f"K4 {name} leaf ids differ")
        log(f"  K4 {name} leaf: exact ({tuple(got.shape)})")
        # a ragged row count (the last block half full) and the server's
        # small buckets go through the same masks
        for n in (1000, 256):
            part = codes[:n]
            for mode in ("scores", "leaf"):
                got = pc.serving_fused(bp._fused_tables, part, mode=mode, **kw)
                want = pc.serving_fused_ref(bp._fused_tables, part,
                                            mode=mode, **kw)
                check(max_err(got, want) <= tol,
                      f"K4 {name} {mode} at {n} rows differs")
        log(f"  K4 {name} at 1000 (ragged) and 256 rows: ok")
        if not bp.packed:
            base = pc.serving_fused(bp._fused_tables, codes, **kw)
            for dt in (torch.uint16, torch.int32):
                other = pc.serving_fused(bp._fused_tables, codes.to(dt), **kw)
                check(torch.equal(other, base), f"K4 {name} {dt} codes differ")
            log(f"  K4 {name} uint16/int32 codes: identical to uint8")
        unpacked = torch.from_numpy(bp.binner.prebin(X)).to(dev)
        leaf_tables = pc.walk_tables(bp.arrays)
        kw5 = dict(n_steps=bp.depth, zero_code=bp.binner.zero_code,
                   nan_code=bp.binner.nan_code)
        got = pc.serving_leaf(leaf_tables, unpacked, **kw5)
        want = pc.serving_leaf_ref(leaf_tables, unpacked, **kw5)
        check(torch.equal(got, want), f"K5 {name} leaf ids differ")
        check(torch.equal(pc.serving_leaf(leaf_tables, unpacked[:1001], **kw5),
                          want[:1001]), f"K5 {name} ragged leaf ids differ")
        log(f"  K5 {name} leaf: exact ({tuple(got.shape)})")
    return err


def phase_bulk(booster, trees, n_rows, rng) -> dict:
    X = make_rows(rng, n_rows)
    out = {}
    # the serving tables are built once a predictor (a publish's work);
    # the timed predicts below are the steady state
    for method in ("fused", "pallas"):
        t0 = time.perf_counter()
        bp = booster._device_predictor(trees, 1, 0, method, {})
        out[f"build_{method}_s"] = time.perf_counter() - t0
        log(f"  BatchPredictor({method}) built in "
            f"{out[f'build_{method}_s']:.3f} s")
    # the host's share: the float64 prebin every chunk goes through
    t0 = time.perf_counter()
    for lo in range(0, n_rows, bp.chunk_rows):
        bp.encode(X[lo: lo + bp.chunk_rows])
    out["encode_s"] = time.perf_counter() - t0
    log(f"  host prebin of {n_rows} rows: {out['encode_s']:.3f} s")
    for method in ("fused", "pallas"):
        t0 = time.perf_counter()
        raw = booster.predict(X, predict_method=method, raw_score=True)
        secs = time.perf_counter() - t0
        check(raw.shape == (n_rows,) and np.isfinite(raw).all(),
              f"{method}: bad output {raw.shape}")
        out[method] = {"rows_per_s": n_rows / secs, "seconds": secs,
                       "raw": raw}
        log(f"  Booster.predict(method={method}, raw) {n_rows} rows: "
            f"{secs:.3f} s, {n_rows / secs:.0f} rows/s")
    n_leaf = min(16384, n_rows)
    leaf = booster.predict(X[:n_leaf], predict_method="fused", pred_leaf=True)
    check(leaf.shape == (n_leaf, len(trees)), f"pred_leaf {leaf.shape}")
    # the numpy HostTree oracle on a subset
    n_sub = min(4096, n_rows)
    sub = X[:n_sub]
    host_raw = booster.predict(sub, raw_score=True)        # host walk, f64
    host_leaf = np.stack([t.predict_leaf_index(sub) for t in trees], axis=1)
    check(np.array_equal(leaf[:n_sub], host_leaf), "fused leaf ids != host")
    tol = raw_tol(trees)
    for method in ("fused", "pallas"):
        e = float(np.abs(out[method]["raw"][:n_sub] - host_raw).max())
        log(f"  {method} raw vs host oracle: max_abs_err={e:.3e} "
            f"(tol {tol:.3e})")
        check(e <= tol, f"{method} raw vs host: {e} > {tol}")
    f64 = booster.predict(sub, predict_method="fused", raw_score=True,
                          predict_f64_scores=True)
    check(np.array_equal(f64, host_raw), "f64 lane not bit-identical")
    prob = booster.predict(sub, predict_method="fused")
    check(np.abs(prob - 1 / (1 + np.exp(-host_raw))).max() <= 1e-6,
          "converted output differs")
    log("  leaves exact, f64 lane bit-identical, converted output ok")
    return out


def phase_server(booster_a, booster_b, n_requests, rng, dev) -> dict:
    """8 threads of 1-256-row requests; one publish (model B) and one
    rollback (back to A) in mid-traffic."""
    server = Server(booster_a, ServeConfig(
        max_batch_rows=1024, max_batch_delay_ms=2.0, queue_depth_rows=1 << 16,
        predictor_kwargs={"method": "fused"}), device=dev)
    seeds = rng.randint(1 << 30, size=8)
    results, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def worker(seed):
        r = np.random.RandomState(seed)
        try:
            while not stop.is_set():
                rows = make_rows(r, r.randint(1, 257))
                res = server.submit(rows)
                with lock:
                    results.append((rows, res))
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in seeds]
    t0 = time.perf_counter()
    for t in threads:
        t.start()

    def more(n):
        """Wait until ``n`` more requests have been answered."""
        goal = len(results) + n
        while len(results) < goal and not errors:
            time.sleep(0.001)

    # a third of the traffic on A, a third on B, a third on A again; the
    # publish and the rollback happen while the workers keep submitting
    more(n_requests // 3)
    tag_b = server.publish(booster_b)
    more(n_requests // 3)
    tag_a = server.rollback()
    mark, t_mark = len(results), time.perf_counter()
    more(n_requests - 2 * (n_requests // 3))
    stop.set()
    t_end = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    snap = server.metrics_snapshot()
    server.close()
    check(not errors, f"server errors: {errors[:3]}")
    check(not any(t.is_alive() for t in threads), "a client thread hung")
    check(len(results) >= n_requests, f"{len(results)} answers")
    by_tag = {tag_a: booster_a, tag_b: booster_b}
    tags = {res.version for _, res in results}
    check(tags <= set(by_tag) and len(tags) == 2, f"versions seen: {tags}")
    for tag, booster in by_tag.items():
        mine = [(rows, res) for rows, res in results if res.version == tag]
        X = np.concatenate([rows for rows, _ in mine])
        want = booster.predict(X, predict_method="fused", raw_score=True)
        got = np.concatenate([res.values[:, 0] for _, res in mine])
        e = float(np.abs(got - want).max())
        check(e <= raw_tol(booster._all_trees()),
              f"server answers of {tag} differ from Booster.predict by {e}")
        log(f"  {len(mine)} answers tagged {tag}: max_abs_err vs "
            f"Booster.predict = {e:.3e}")
    log(f"  {len(results)} requests in {secs:.2f} s; server qps="
        f"{snap['qps']} p50_ms={snap['p50_ms']:.3f} "
        f"p99_ms={snap['p99_ms']:.3f} batches={snap['batches']} "
        f"occupancy={snap['batch_occupancy']}")
    # the steady window: from the rollback's return to the stop, with no
    # publish building tables on the host beside the dispatcher
    steady = [res for _, res in results[mark:]]
    lat = sorted(res.latency_ms for res in steady)
    snap["steady"] = {
        "requests": len(lat), "qps": len(lat) / (t_end - t_mark),
        "p50_ms": lat[len(lat) // 2],
        "p99_ms": lat[min(int(0.99 * len(lat)), len(lat) - 1)],
        # a request's wait for its batch, and its batch's predict leg
        "mean_queue_ms": float(np.mean([r.queue_ms for r in steady])),
        "mean_walk_ms": float(np.mean([r.walk_ms for r in steady])),
        "mean_batch_rows": float(np.mean([r.batch_rows for r in steady]))}
    log(f"  steady window: {json.dumps(snap['steady'])}")
    return snap


def time_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` launches after one warm-up, by
    CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_timing(booster, trees, dev, launches, errs, rng) -> list:
    """Each kernel at the main path's chunk shape (131,072 rows of u8
    codes of the 500-tree model) beside its plain version and bound."""
    bp = booster._device_predictor(trees, 1, 0, "fused", {})
    n = bp.chunk_rows
    codes = torch.from_numpy(bp.encode(make_rows(rng, n))).to(dev)
    kw = dict(n_steps=bp.depth, zero_code=bp.binner.zero_code,
              nan_code=bp.binner.nan_code)
    tables = bp._fused_tables
    leaf_tables = pc.walk_tables(bp.arrays)
    T, L = len(trees), bp.arrays.leaf_value.shape[1]
    L1 = bp.arrays.split_feature.shape[1]
    # the work this run's data needs, counted from the walks themselves
    leaf, steps, walk = walk_loads(leaf_tables, codes, **kw)
    check(torch.equal(leaf, pc.serving_leaf(leaf_tables, codes, **kw)),
          "load count walked other leaves than the kernel")
    fkw = dict(kw, K=1, tree_tile=bp.fused_plan["tree_tile"])
    rows = []
    specs = [
        ("serving_fused", "lightgbmv1_tpu/ops/predict_pallas.py:202",
         lambda: pc.serving_fused(tables, codes, **fkw),
         lambda: pc.serving_fused_ref(tables, codes, **fkw),
         # codes in, tables (7 node tables + leaf values + num_leaves) in,
         # (N, 1) f32 out; a leaf-value gather a walk on top of the steps
         n * F + tables.split_feature.shape[0] * (7 * L1 + L + 1) * 4 + n * 4,
         walk + n * T),
        ("serving_leaf", "lightgbmv1_tpu/ops/predict_pallas.py:55",
         lambda: pc.serving_leaf(leaf_tables, codes, **kw),
         lambda: pc.serving_leaf_ref(leaf_tables, codes, **kw),
         n * F + T * (7 * L1 + 1) * 4 + n * T * 4,
         walk),
    ]
    for name, replaces, kern, plain, nbytes, gathers in specs:
        ms = time_ms(kern, 10)
        plain_ms = time_ms(plain, 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = gathers / GATHERS_PER_S * 1e3
        row = {"name": name, "route": "cuda", "source": SRC,
               "replaces": replaces, "launches": int(launches[name]),
               "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": None, "rows": n, "walk_steps": steps,
               "gathers": gathers, "bytes": nbytes}
        log(f"  {name}: {ms:.3f} ms (plain {plain_ms:.1f} ms, bound "
            f"{row['bound_ms']:.3f} ms by {row['bound_by']}, "
            f"{n / ms * 1e3:.3e} rows/s)")
        rows.append(row)
    # the server's largest bucket: 4 blocks of 256 rows on a 132-SM card
    small = codes[:1024]
    rows[0]["ms_at_1024_rows"] = time_ms(
        lambda: pc.serving_fused(tables, small, **fkw), 20)
    log(f"  serving_fused on a 1024-row server batch: "
        f"{rows[0]['ms_at_1024_rows']:.3f} ms")
    return rows


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def make_data(n, seed):
    """The JAX package's bench.py:42 make_data, copied: 28 standard-normal
    f32 features and a label from a noisy logit of six of them."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 28).astype(np.float32)
    logit = (X[:, 0] * 1.2 - X[:, 1] + 0.6 * X[:, 2] * X[:, 3]
             + 0.4 * X[:, 4] + 0.3 * np.sin(3.0 * X[:, 5]))
    y = (logit + rng.randn(n).astype(np.float32) > 0).astype(np.float64)
    return X, y


def k1_tol(absum: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """K1 against its plain version: both sum the same rounded parts in
    f32, in other orders (the plain version's index_add_ in atomic
    order).  A recursive f32 sum of n terms is off by at most n * 2^-24
    of the terms' absolute sum, so a cell of n rows agrees within twice
    that (+1e-6); a constant column (the first iteration's hessians) does
    drift that way, by its rounding bias."""
    return 2.0 * (count + 1.0) * 2.0 ** -24 * absum + 1e-6


def signed_rows(rng, n, dev) -> torch.Tensor:
    """(n, 3) f32 rows with signed normal grads, varied positive hessians
    and a count of 1 (tests/test_torch_hist.py's inputs, count aside)."""
    g3 = rng.randn(n, 3).astype(np.float32)
    g3[:, 1] = np.abs(g3[:, 1]) * 0.25
    g3[:, 2] = 1.0
    return torch.from_numpy(g3).to(dev).contiguous()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_k1(tag, binned, g3, lid, L, B=64, live=None) -> dict:
    """K1 against its plain versions on one input in all three precisions
    (``live``: the slots whose rows add, as the call gave it): bit for bit
    the row-order version (the kernel's order), and against the
    index_add_ version counts exact and every cell within ``k1_tol``; two
    launches bitwise equal; and the dead-slot limit — K1 with the last
    slot dead gives the all-live cells of the other slots bit for bit and
    a +0.0 dead slot.  Also names the pairs of precisions whose plain
    versions differ past the tolerance in some cell: on such an input the
    check would catch a kernel that computed the other precision."""
    absum = hc.index_add_hist(binned, [g3.abs()], lid, L, B, live)
    tol = k1_tol(absum, absum[..., 2:3])       # the count column is >= 0
    wants, err, rel_max = {}, 0.0, 0.0
    for prec in hc.PRECISIONS:
        got = hc.hist_leaves(binned, g3, lid, L, B, prec, live)
        again = hc.hist_leaves(binned, g3, lid, L, B, prec, live)
        want = wants[prec] = hc.hist_leaves_ref(binned, g3, lid, L, B, prec,
                                                live)
        row = hc.hist_leaves_roworder_ref(binned, g3, lid, L, B, prec, live)
        check(same_bits(got, row), f"K1 {tag} {prec}: not bitwise the "
              f"row-order version ({int((got != row).sum())} cells differ)")
        check(torch.equal(got[..., 2], want[..., 2]),
              f"K1 {tag} {prec}: counts differ")
        diff = (got - want).abs()
        over = int((diff > tol).sum())
        check(over == 0, f"K1 {tag} {prec}: {over} cells off tolerance")
        check(same_bits(got, again), f"K1 {tag} {prec}: two launches "
              "differ")
        full = hc.hist_leaves(binned, g3, lid, L, B, prec)
        dead = hc.hist_leaves(binned, g3, lid, L, B, prec, L - 1)
        check(same_bits(dead[:L - 1], full[:L - 1])
              and not bool(dead[L - 1].view(torch.int32).any()),
              f"K1 {tag} {prec}: the dead slot's rows changed a live cell "
              "or the dead slot is not 0")
        err = max(err, float(diff.max()))
        rel_max = max(rel_max, float((diff / (absum + 1e-30)).max()))
    seps = [f"{p}|{q}" for i, p in enumerate(hc.PRECISIONS)
            for q in hc.PRECISIONS[i + 1:]
            if bool(((wants[p] - wants[q]).abs() > tol).any())]
    log(f"  K1 {tag}: bitwise the row-order version, dead slot 0 and live "
        f"cells unchanged, counts exact, bitwise repeatable; vs index_add_ "
        f"max_abs_err={err:.3e}, max err/abs-sum {rel_max:.2e}; separates "
        f"{', '.join(seps) or 'no pair of precisions'}")
    return {"case": tag, "max_abs_err": err, "max_err_over_abs_sum": rel_max,
            "separates": seps, "bitwise_roworder": True,
            "dead_slot_ok": True}


def phase_hist_kernel(binned, dev, rng) -> list:
    """K1 against its plain version on the card at the main path's shape
    (the headline bins, random slots, signed varied rows) at each slot
    count of the path, and on the first 4,096 rows at 64 slots, where a
    cell holds a row or two: there the tolerance must tell every pair of
    precisions apart."""
    N = binned.shape[1]
    out = []
    for L in (2, 5, 17, 64):
        lid = torch.from_numpy(rng.randint(0, L, N).astype(np.int32)).to(dev)
        out.append(check_k1(f"N={N} L={L} signed rows", binned,
                            signed_rows(rng, N, dev), lid, L))
    n = 4096
    small = binned[:, :n].contiguous()
    lid = torch.from_numpy(rng.randint(0, 64, n).astype(np.int32)).to(dev)
    out.append(check_k1(f"N={n} L=64 signed rows", small,
                        signed_rows(rng, n, dev), lid, 64))
    check(len(out[-1]["separates"]) == 3, "the small K1 case does not tell "
          f"every pair of precisions apart: {out[-1]['separates']}")
    return out


class HistRecorder:
    """Keeps the inputs of the last K1 call at each (slots, precision) of a
    run: the main path's own shapes and data, at its latest iteration, for
    the checks and the timing after it.  It counts nothing; the wrapper
    counts its launches."""

    def __init__(self):
        self.last = {}

    def __enter__(self):
        self._orig = hc.hist_leaves

        def wrapped(binned, g3, leaf_id, num_leaves, num_bins,
                    precision="bf16x2", live_slots=None):
            self.last[(int(num_leaves), precision)] = (binned, g3, leaf_id,
                                                       num_bins, live_slots)
            return self._orig(binned, g3, leaf_id, num_leaves, num_bins,
                              precision, live_slots)

        hc.hist_leaves = wrapped
        return self

    def __exit__(self, *exc):
        hc.hist_leaves = self._orig


def phase_hist_main_inputs(rec: HistRecorder) -> list:
    """K1 against its plain versions on the main path's own inputs at each
    of its (slots, precision) keys, as its last iteration gave them (the
    live slots too)."""
    out = []
    for (L, prec), (binned, g3, label, B, live) in sorted(rec.last.items()):
        out.append(check_k1(f"main path L={L} live={live} ({prec} on the "
                            "path)", binned, g3, label, L, B, live))
    return out


def _on(dev) -> dict:
    """The entry points' own default is the card; name any other device."""
    return {} if torch.device(dev).type == "cuda" else {"device": dev}


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def phase_train(ds, dv, Xv, iters, dev):
    """The training main path (counts reset before, read after), then the
    saved model served through K4.  Returns its numbers and the K1 call
    record."""
    hc.reset_launch_counts()
    pc.reset_launch_counts()
    ev = {}
    with HistRecorder() as rec:
        t0 = time.perf_counter()
        booster = train(TRAIN_PARAMS, ds, iters, valid_sets=[dv],
                        evals_result=ev, **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    launches = hc.launch_counts["hist_leaves"]
    buckets = {f"{L}:{prec}": v for (L, prec), v
               in sorted(hc.bucket_launch_counts.items())}
    plain = dict(hc.plain_counts)
    log(f"  K1 launches on the training path: {launches} "
        f"({json.dumps(buckets)}); plain-version calls: {plain}")
    check(launches > 0, "K1 never launched on the training path")
    check(sum(buckets.values()) == launches,
          "K1's launches by bucket do not add up to its launches")
    check(set(rec.last) == set(hc.bucket_launch_counts),
          f"K1 was called at {sorted(rec.last)} but launched at "
          f"{sorted(hc.bucket_launch_counts)}")
    check(not any(plain.values()),
          "a plain histogram ran on the training path")
    n = ds.num_data()
    trees = booster.num_trees()
    auc = ev["valid_0"]["auc"][-1]
    out = {"seconds": secs, "iters": iters, "s_per_iter": secs / iters,
           "M_row_trees_per_s": n * trees / secs / 1e6,
           "valid_auc": auc, "valid_logloss": ev["valid_0"]["binary_logloss"][-1],
           "trees": trees, "leaves": [int(t.num_leaves) for t in
                                      booster._gbdt._device_trees[:3]],
           "k1_launches": launches, "k1_launches_by_bucket": buckets}
    log(f"  {iters} iterations of {n} rows in {secs:.2f} s: "
        f"{out['s_per_iter']:.3f} s/iter, {out['M_row_trees_per_s']:.2f} M "
        f"row-trees/s; valid AUC {auc:.5f} logloss "
        f"{out['valid_logloss']:.5f}")
    check(trees == iters, f"{trees} trees for {iters} iterations")
    check(auc > 0.90, f"valid AUC {auc} <= 0.90")
    out.update(text_hash(booster.model_to_string(), "staged"))
    out["served_max_abs_err"] = serve_trained(booster, Xv, dev,
                                              "trained_model.txt")
    return out, rec


def text_hash(text: str, tag: str) -> dict:
    """The sha256 and length of a model text: the same bits from another
    build of the kernels give the same hash."""
    out = {"model_text_sha256": hashlib.sha256(text.encode()).hexdigest(),
           "model_text_bytes": len(text)}
    log(f"  {tag} model text: sha256 {out['model_text_sha256']}, "
        f"{out['model_text_bytes']} bytes")
    return out


def serve_trained(booster, Xv, dev, name) -> float:
    """The trained model's text, loaded by ``Booster(model_file=...)``,
    serves the valid rows through K4 within the serving tolerance of the
    trainer's own valid scores; returns the largest difference."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, name)
    booster.save_model(path)
    served = Booster(model_file=path, **_on(dev))
    check(served.num_trees() == booster.num_trees(), "saved model lost trees")
    raw = served.predict(Xv, predict_method="fused", raw_score=True)
    want = booster._gbdt._valid_scores[0].score[:, 0].cpu().numpy()
    tol = raw_tol(served._all_trees())
    e = float(np.abs(raw - want).max())
    log(f"  saved model served through K4: max_abs_err vs the trainer's "
        f"valid scores {e:.3e} (tol {tol:.3e})")
    check(e <= tol, f"served model differs from the trainer by {e}")
    return e


PARITY_PARAMS = dict(TRAIN_PARAMS, num_leaves=63, leafwise_wave_size=32,
                     hist_dtype="f32", hist_method="pallas", metric="auc")


def phase_parity(seed, dev, n=65536) -> dict:
    """f32 trees on the card and on the CPU must split identically."""
    return same_splits(seed, n, {"card": (PARITY_PARAMS, dev),
                                 "CPU": (PARITY_PARAMS, "cpu")})


def same_splits(seed, n, runs) -> dict:
    """Two 5-iteration f32 trainings of ``n`` rows (``runs``: two labels
    -> (params, device)) must split identically at every node."""
    X, y = make_data(n, seed + 7)
    saved = grower_wave._BUCKET_MIN_N
    grower_wave._BUCKET_MIN_N = 1
    try:
        boosters = [train(p, Dataset(X, label=y), 5, device=d)
                    for p, d in runs.values()]
    finally:
        grower_wave._BUCKET_MIN_N = saved
    nodes, leaf_err = 0, 0.0
    for tg, tc in zip(boosters[0]._all_trees(), boosters[1]._all_trees()):
        n = tc.num_leaves - 1
        check(tg.num_leaves == tc.num_leaves, "parity: leaf counts differ")
        check(np.array_equal(tg.split_feature, tc.split_feature)
              and np.array_equal(tg.threshold_bin, tc.threshold_bin),
              "parity: split features / threshold bins differ")
        nodes += n
        leaf_err = max(leaf_err, float(np.abs(tg.leaf_value
                                              - tc.leaf_value).max()))
    log(f"  f32 trees, {' vs '.join(runs)}: {nodes} nodes of 5 trees "
        f"identical (features, threshold bins); max leaf-value diff "
        f"{leaf_err:.3e}")
    return {"nodes": nodes, "max_leaf_diff": leaf_err}


def phase_hist_timing(rec: HistRecorder, trained: dict, checks: list
                      ) -> dict:
    """K1 at each slot bucket of the main path, on the inputs of its last
    call there, beside its plain version, one ``index_add_`` and its
    bound; returns the kernels-line row (top level: the largest
    bucket)."""
    buckets = []
    n_trees = trained["trees"]
    for (L, prec), (binned, g3, label, B, live_slots) in sorted(
            rec.last.items()):
        Fn, N = binned.shape
        ms = time_ms(lambda: hc.hist_leaves(binned, g3, label, L, B, prec,
                                            live_slots), 10)
        plain_ms = time_ms(lambda: hc.hist_leaves_ref(
            binned, g3, label, L, B, prec, live_slots), 2)
        flat = ((torch.arange(Fn, device=binned.device)[:, None] * L
                 + label.long()[None, :]) * B + binned.long()).reshape(-1)
        vals = g3.repeat(Fn, 1)
        acc = torch.zeros((Fn * L * B, 3), dtype=torch.float32,
                          device=binned.device)
        library_ms = time_ms(lambda: acc.index_add_(0, flat, vals), 5)
        # the path's last slot is its dead one (hist_wave, live_slots =
        # L - 1): the live rows are those of the other slots
        live = int(((label >= 0) & (label < L - 1)).sum())
        nbytes = Fn * N + N * 12 + N * 4 + L * Fn * B * 3 * 4
        ops = (2 if prec == "bf16x2" else 1) * 3 * live * Fn
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        b = {"slots": L - 1, "L": L, "precision": prec, "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": nbytes, "ops": ops,
             "launches": trained["k1_launches_by_bucket"].get(f"{L}:{prec}",
                                                              0)}
        b["launches_per_tree"] = b["launches"] / n_trees
        buckets.append(b)
        log(f"  K1 L={L} ({prec}): {ms:.3f} ms (plain {plain_ms:.1f} ms, "
            f"index_add_ {library_ms:.3f} ms, bound {b['bound_ms']:.4f} ms "
            f"by {b['bound_by']}), {b['launches_per_tree']:.2f} launches "
            f"a tree")
    top = max(buckets, key=lambda b: b["L"])
    return {"name": "hist_leaves", "route": "cuda", "source": HIST_SRC,
            "replaces": "lightgbmv1_tpu/ops/hist_pallas.py:95",
            "launches": int(trained["k1_launches"]),
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "max_err_over_abs_sum": max(c["max_err_over_abs_sum"]
                                        for c in checks),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "at": f"L={top['L']} "
            f"{top['precision']}", "buckets": buckets, "checks": checks}

def phase_profile(ds, iters, dev, params=TRAIN_PARAMS) -> dict:
    """Where an iteration's time goes: ``iters`` headline iterations
    under torch.profiler (after one warm-up), device time by kernel and
    the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    booster = Booster(params, train_set=ds, **_on(dev))
    booster.update()
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            booster.update()
        _sync(dev)
        wall = time.perf_counter() - t0

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))

    # the kernels themselves (the ops that launched them carry the same
    # device time again)
    kern = sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU
                   and dev_us(e) > 0), key=lambda r: -r[1])
    total_us = sum(us for _, us, _ in kern)
    out = {"iters": iters, "wall_ms_per_iter": wall / iters * 1e3,
           "device_ms_per_iter": total_us / iters / 1e3,
           "device_busy_share": (total_us / 1e6 / wall) if kern else None,
           "top": [{"kernel": k[:80], "ms_per_iter": us / iters / 1e3,
                    "calls_per_iter": c / iters} for k, us, c in kern[:10]]}
    if not kern:
        log("  the profiler recorded no device time: not measured")
        return out
    log(f"  {iters} iterations profiled: {out['wall_ms_per_iter']:.1f} ms "
        f"wall, {out['device_ms_per_iter']:.1f} ms device an iteration "
        f"(busy {out['device_busy_share']:.1%})")
    for r in out["top"]:
        log(f"    {r['ms_per_iter']:8.3f} ms  {r['calls_per_iter']:7.1f}x  "
            f"{r['kernel']}")
    return out


# ---------------------------------------------------------------------------
# the fused round (K2) and the valid routing (K3)
# ---------------------------------------------------------------------------


def round_inputs(binned, meta, S, n_live, sub, prec, rng):
    """One wave round's inputs at ``S`` slots (``n_live`` splits, the rest
    dead): rows spread over ``2S + 7`` current leaves, random splits on
    the dataset's own features (real missing types), signed varied rows,
    the children's exact sums and, in subtraction mode, the parents'
    histograms.  Returns the keyword arguments of ``fc.fused_round``."""
    F, N = binned.shape
    dev = binned.device
    B = 64
    n_cur = 2 * S + 7
    L = n_cur + S                     # dead slots carry leaf L: no row's

    def t(a, dt=torch.int32):
        return torch.as_tensor(a, dtype=dt, device=dev)

    oleaf = t(rng.randint(0, n_cur, N))
    nb = meta.num_bins.cpu().numpy()
    feats = rng.randint(0, F, n_live)
    thrs = np.array([rng.randint(0, max(int(nb[f]) - 1, 1)) for f in feats])

    def pad(v, fill):
        return np.concatenate([v, np.full(S - n_live, fill, v.dtype)])

    feats_s = t(pad(feats, 0))
    rmeta = wf.pack_route_meta(
        feats_s, t(pad(thrs, 0)), t(pad(rng.rand(n_live) < 0.5, False),
                                    torch.bool),
        t(pad(rng.choice(n_cur, n_live, replace=False), L)),
        t(pad(n_cur + np.arange(n_live), 0)), meta,
        sml=t(pad(rng.rand(n_live) < 0.5, False), torch.bool))
    route = {"oleaf": oleaf, "feats": feats_s, "rmeta": rmeta,
             "num_leaves": L}
    g3 = signed_rows(rng, N, dev)
    dbin = wf.decision_bins(binned, oleaf, feats_s, rmeta[:, 0], L)
    _, child = wf.route_tile(dbin, oleaf, rmeta, nslots=2 * S, sub=False)
    csums = torch.zeros((2 * S + 1, 3), dtype=torch.float32,
                        device=dev).index_add_(0, child.long(), g3)[:2 * S]
    live_c = torch.arange(2 * S, device=dev) < 2 * n_live
    csums[~live_c] = 1.0
    kw = dict(nslots=S if sub else 2 * S, num_bins=B, precision=prec,
              meta=meta, params=SplitParams(min_data_in_leaf=20.0),
              mask=live_c[:, None].expand(2 * S, F).contiguous(),
              csums=csums, route=route)
    if sub:
        # each live slot's parent: the histogram of its leaf's rows
        slot_of = torch.full((n_cur + 1,), S, dtype=torch.int32, device=dev)
        slot_of[rmeta[:n_live, 0].long()] = torch.arange(
            n_live, dtype=torch.int32, device=dev)
        kw["parent"] = hc.index_add_hist(binned, [g3], slot_of[oleaf.long()],
                                         S + 1, B)[:S].contiguous()
        kw["sml"] = rmeta[:, 7] != 0
    return g3, kw


def plain_kw(kw) -> dict:
    """K2's keyword arguments as its plain version takes them (the
    kernel's feature table is the kernel's own)."""
    return {k: v for k, v in kw.items() if k != "fmeta"}


def same_value(a, b) -> torch.Tensor:
    """Elementwise: equal, or both NaN."""
    return (a == b) | (torch.isnan(a) & torch.isnan(b))


def gain_bound(left2, csums, gains, shift, lbound, params) -> torch.Tensor:
    """(C, F) bound on a gain's difference between two scans whose left
    sums differ by at most ``lbound`` (C, F, 3): over the feature's valid
    candidates, the gain's derivative in the left grad and hessian sums
    times that, plus eight f32 roundings of its terms on each side."""
    L = left2.double()                                   # (C, 2, F, B, 3)
    R = csums.double()[:, None, None, None, :] - L
    hl = L[..., 1] + params.lambda_l2
    hr = R[..., 1] + params.lambda_l2
    ql, qr = L[..., 0].abs() / hl, R[..., 0].abs() / hr
    dg = lbound.double()[:, None, :, None, 0]
    dh = lbound.double()[:, None, :, None, 1]
    b = (2 * (ql + qr) * dg + (ql * ql + qr * qr) * dh
         + 8 * 2.0 ** -24 * (ql * L[..., 0].abs() + qr * R[..., 0].abs()
                             + shift.double().abs()[:, None, None, None]))
    b = torch.where(torch.isfinite(gains), b, torch.zeros_like(b))
    return b.amax(dim=(1, 3)) + 1e-6


def check_k2(tag, binned, g3, kw) -> dict:
    """K2 (and K3 on the same rows) against the plain versions on one
    round's inputs; returns what was measured."""
    S = kw["nslots"] if kw.get("parent") is not None else kw["nslots"] // 2
    C, F, B = 2 * S, binned.shape[0], kw["num_bins"]
    prec, meta, params = kw["precision"], kw["meta"], kw["params"]
    got = fc.fused_round(binned, g3, **kw)
    again = fc.fused_round(binned, g3, **kw)
    want = fc.fused_round_ref(binned, g3, **plain_kw(kw))
    res, hsm, nleaf, label = got
    for a, b, what in zip(got, again, ("residue", "hsmall", "new leaf ids",
                                       "label")):
        check(a is None or bool(same_value(a, b).all()),
              f"K2 {tag}: two launches differ in {what}")
    check(torch.equal(nleaf, want[2]), f"K2 {tag}: new leaf ids differ")
    check(torch.equal(label, want[3]), f"K2 {tag}: labels differ")
    route = kw["route"]
    k3 = fc.route_rows(binned, route["oleaf"], route["feats"],
                       route["rmeta"], route["num_leaves"])
    check(torch.equal(k3, nleaf), f"K3 {tag}: differs from K2's leaf ids")
    check(torch.equal(k3, fc.route_rows_ref(
        binned, route["oleaf"], route["feats"], route["rmeta"],
        route["num_leaves"])), f"K3 {tag}: differs from its plain version")
    # K2's histograms are K1's on the emitted label, bit for bit
    k1 = hc.hist_leaves(binned, g3, label, kw["nslots"] + 1, B,
                        prec)[:kw["nslots"]]
    if hsm is not None:
        check(torch.equal(hsm, k1), f"K2 {tag}: hsmall differs from K1")
        children = wf.subtract_children(hsm, kw["parent"], kw["sml"])
    else:
        children = k1
    # the plain scan on the CPU, on the same histograms
    res_cpu = wf.child_scan_residue(
        children.cpu(), kw["mask"].cpu(), kw["csums"].cpu(),
        meta_blk=type(meta)(*(x.cpu() for x in meta)), params=params,
        num_bins=B, fblk=F).to(binned.device)
    bitwise_cpu = bool(same_value(res, res_cpu).all())
    # the plain version on the card: picks outside ties, values in bound
    left2 = scan_left_sums(children, meta)
    gains, shift = scan_direction_gains(left2, kw["csums"], meta,
                                        kw["mask"], params)
    gains_f = torch.cat([gains[:, 0], gains[:, 1]], dim=2)
    pres = want[0]
    fbest_p = pres[..., 0]
    band = TIE_RTOL * (shift.abs()[:, None] + torch.where(
        torch.isfinite(fbest_p), fbest_p.abs(), torch.zeros_like(fbest_p)))
    sel_k, sel_p = res[..., 2].long(), pres[..., 2].long()
    g_at_k = torch.gather(gains_f, 2, sel_k[..., None])[..., 0]
    pick_off = (sel_k != sel_p) & ~(g_at_k >= fbest_p - 2 * band)
    check(not bool(pick_off.any()), f"K2 {tag}: {int(pick_off.sum())} "
          "picks differ from the plain version outside the tie band")
    fin = torch.isfinite(fbest_p) & (sel_k == sel_p)
    # the card's plain version scans its left sums in f32 in another
    # order: each is within 2 B 2^-24 of its channel's absolute sum
    absum = children.abs().sum(dim=2)                    # (C, F, 3)
    lbound = 2 * B * 2.0 ** -24 * absum + 1e-6
    err_l = torch.where(fin[..., None], (res[..., 3:] - pres[..., 3:]).abs(),
                        torch.zeros_like(lbound))
    check(bool((err_l <= lbound).all()), f"K2 {tag}: left sums off by "
          f"{float(err_l.max()):.3e} past 2 B 2^-24 of their absolute sum")
    bound = gain_bound(left2, kw["csums"], gains, shift, lbound, params)
    err_g = torch.where(fin, (res[..., :2] - pres[..., :2]).abs().amax(-1),
                        torch.zeros_like(fbest_p))
    check(bool(((err_g <= bound) | ~fin).all()), f"K2 {tag}: gains off by "
          f"{float(err_g.max()):.3e} past the bound the left sums' carries")
    # the cross-feature half on both residues
    shift_c = gain_shift(kw["csums"], params)
    pk = wf._pick_pack(res, shift_c, kw["csums"], meta, B)
    pp = wf._pick_pack(pres, shift_c, kw["csums"], meta, B)
    fk, fp = pk[:, 1].long(), pp[:, 1].long()
    ci = torch.arange(C, device=binned.device)
    gb = fbest_p.max(dim=1).values
    gband = TIE_RTOL * (shift_c.abs() + torch.where(
        torch.isfinite(gb), gb.abs(), torch.zeros_like(gb)))
    feat_off = (fk != fp) & ~(fbest_p[ci, fk] >= gb - 2 * gband)
    check(not bool(feat_off.any()), f"K2 {tag}: {int(feat_off.sum())} "
          "children pick another feature outside the tie band")
    out = {"case": tag, "residue_bitwise_cpu_plain": bitwise_cpu,
           "sel_diff_in_band": int((sel_k != sel_p).sum()),
           "feature_diff_in_band": int((fk != fp).sum()),
           "max_gain_err": float(err_g.max()),
           "max_left_err": float(err_l.max()),
           "rows_in_slots": int((label < kw["nslots"]).sum())}
    log(f"  K2 {tag}: leaf ids, labels, K3 exact; hsmall "
        f"{'== K1' if hsm is not None else '(pool-free)'}; residue "
        f"{'bitwise equal to' if bitwise_cpu else 'differs from'} the CPU "
        f"plain scan; vs the card's plain version {out['sel_diff_in_band']}"
        f" picks / {out['feature_diff_in_band']} features differ in the "
        f"tie band, max gain err {out['max_gain_err']:.2e}, left "
        f"{out['max_left_err']:.2e}")
    return out


def phase_fused_kernels(binned, meta, rng) -> list:
    """K2 and K3 against their plain versions on the headline bins."""
    out = []
    for S, n_live, sub in ((4, 3, True), (16, 16, True), (63, 63, True),
                           (63, 63, False)):
        for prec in hc.PRECISIONS:
            g3, kw = round_inputs(binned, meta, S, n_live, sub, prec, rng)
            out.append(check_k2(f"S={S} {'sub' if sub else 'pool-free'} "
                                f"{prec}", binned, g3, kw))
    return out


class FusedRecorder:
    """Keeps the inputs of the last K2 call at each (nslots, precision,
    mode) of a run, and of the last K3 call: the main path's own shapes
    and data, for the checks and the timing after it.  It counts nothing;
    the wrappers count their launches."""

    def __init__(self):
        self.last = {}
        self.route = None

    def __enter__(self):
        self._orig = fc.fused_round, fc.route_rows

        def fused(binned, g3, **kw):
            mode = "sub" if kw.get("parent") is not None else "pool"
            self.last[(kw["nslots"], kw["precision"], mode)] = (binned, g3,
                                                                kw)
            return self._orig[0](binned, g3, **kw)

        def route(binned, lids, feats, rmeta, num_leaves):
            self.route = (binned, lids, feats, rmeta, num_leaves)
            return self._orig[1](binned, lids, feats, rmeta, num_leaves)

        fc.fused_round, fc.route_rows = fused, route
        return self

    def __exit__(self, *exc):
        fc.fused_round, fc.route_rows = self._orig


def reset_counts() -> None:
    for mod in (hc, fc, pc, lc):
        mod.reset_launch_counts()


def phase_fused_train(ds, dv, Xv, iters, dev, staged):
    """The fused training main path (counts reset before, read after),
    then the saved model served through K4."""
    reset_counts()
    ev = {}
    with FusedRecorder() as rec:
        t0 = time.perf_counter()
        booster = train(FUSED_PARAMS, ds, iters, valid_sets=[dv],
                        evals_result=ev, **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    k2 = fc.launch_counts["fused_round"]
    k3 = fc.launch_counts["route_rows"]
    k1 = hc.launch_counts["hist_leaves"]
    buckets = {f"{ns}:{prec}:{mode}": v for (ns, prec, mode), v
               in sorted(fc.bucket_launch_counts.items())}
    plain = {**{f"hist.{k}": v for k, v in hc.plain_counts.items()},
             **{f"fused.{k}": v for k, v in fc.plain_counts.items()}}
    trees = booster.num_trees()
    log(f"  launches on the fused path: K2 {k2} ({json.dumps(buckets)}), "
        f"K3 {k3}, K1 {k1}; plain-version calls: {plain}")
    check(trees == iters, f"{trees} trees for {iters} iterations")
    check(k2 > 0, "K2 never launched on the fused path")
    check(sum(buckets.values()) == k2,
          "K2's launches by bucket do not add up to its launches")
    check(set(rec.last) == set(fc.bucket_launch_counts),
          f"K2 was called at {sorted(rec.last)} but launched at "
          f"{sorted(fc.bucket_launch_counts)}")
    check(k3 == k2, f"K3 launched {k3} times for {k2} rounds")
    check(k1 == trees, f"K1 launched {k1} times for {trees} root passes")
    check(not any(plain.values()), "a plain version ran on the fused path")
    n = ds.num_data()
    auc = ev["valid_0"]["auc"][-1]
    out = {"seconds": secs, "iters": iters, "s_per_iter": secs / iters,
           "M_row_trees_per_s": n * trees / secs / 1e6, "valid_auc": auc,
           "valid_logloss": ev["valid_0"]["binary_logloss"][-1],
           "auc_minus_staged": auc - staged["valid_auc"], "trees": trees,
           "k2_launches": k2, "k2_launches_by_bucket": buckets,
           "k2_launches_per_tree": k2 / trees, "k3_launches": k3,
           "k1_launches": k1}
    log(f"  {iters} fused iterations of {n} rows in {secs:.2f} s: "
        f"{out['s_per_iter']:.3f} s/iter, {out['M_row_trees_per_s']:.2f} M "
        f"row-trees/s; valid AUC {auc:.5f} (staged {staged['valid_auc']:.5f}"
        f"), logloss {out['valid_logloss']:.5f}; K2 "
        f"{out['k2_launches_per_tree']:.2f} launches a tree")
    check(auc > 0.90, f"valid AUC {auc} <= 0.90")
    check(abs(auc - staged["valid_auc"]) <= 2e-3,
          f"fused AUC {auc} is more than 2e-3 from the staged {staged}")
    out.update(text_hash(booster.model_to_string(), "fused"))
    out["served_max_abs_err"] = serve_trained(booster, Xv, dev,
                                              "fused_model.txt")
    return out, rec


def phase_fused_main_inputs(rec: FusedRecorder) -> list:
    """K2 against its plain version on the main path's last inputs at each
    of its (nslots, precision, mode) keys."""
    return [check_k2(f"main path nslots={ns} {prec} {mode}", binned, g3, kw)
            for (ns, prec, mode), (binned, g3, kw) in sorted(rec.last.items())]


def phase_fused_timing(rec: FusedRecorder, trained: dict, checks: list
                       ) -> list:
    """K2 at each slot bucket of the main path and K3, on their last
    inputs, beside their plain versions and bounds by bytes."""
    rows, buckets = [], []
    n_trees = trained["trees"]
    for (ns, prec, mode), (binned, g3, kw) in sorted(rec.last.items()):
        Fn, N = binned.shape
        B = kw["num_bins"]
        S = ns if mode == "sub" else ns // 2
        ms = time_ms(lambda: fc.fused_round(binned, g3, **kw), 10)
        plain_ms = time_ms(
            lambda: fc.fused_round_ref(binned, g3, **plain_kw(kw)), 2)
        _, _, _, label = fc.fused_round(binned, g3, **kw)
        live = int((label < ns).sum())
        hist = S * Fn * B * 3 * 4
        # bins, rows, old leaf ids read; label and new leaf ids written;
        # parents read and hsmall written (subtraction mode); the
        # children's mask and sums read, the residue written
        nbytes = (Fn * N + N * 12 + N * 4 + 2 * N * 4
                  + (2 * hist if mode == "sub" else 0)
                  + 2 * S * (Fn + 12) + 2 * S * Fn * wf.RES_COLS * 4)
        ops = ((2 if prec == "bf16x2" else 1) * 3 * live * Fn
               + 2 * S * Fn * B * 2 * 12)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        launches = trained["k2_launches_by_bucket"].get(f"{ns}:{prec}:{mode}",
                                                         0)
        b = {"nslots": ns, "S": S, "precision": prec, "mode": mode, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": nbytes, "ops": ops, "launches": launches,
             "launches_per_tree": launches / n_trees}
        buckets.append(b)
        log(f"  K2 S={S} {mode} ({prec}): {ms:.3f} ms (plain {plain_ms:.1f} "
            f"ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}), "
            f"{b['launches_per_tree']:.2f} launches a tree")
    top = max(buckets, key=lambda b: b["nslots"])
    rows.append({
        "name": "fused_round", "route": "cuda", "source": FUSED_SRC,
        "replaces": "lightgbmv1_tpu/ops/wave_fused.py:238",
        "launches": int(trained["k2_launches"]),
        "max_abs_err": max(max(c["max_gain_err"], c["max_left_err"])
                           for c in checks),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None, "library_note": "none: no single PyTorch call "
        "computes a route + histogram + split scan",
        "at": f"S={top['S']} {top['precision']} {top['mode']}",
        "residue_bitwise_cpu_plain": all(c["residue_bitwise_cpu_plain"]
                                         for c in checks),
        "buckets": buckets, "checks": checks})
    binned, lids, feats, rmeta, num_leaves = rec.route
    N = binned.shape[1]
    ms = time_ms(lambda: fc.route_rows(binned, lids, feats, rmeta,
                                       num_leaves), 20)
    plain_ms = time_ms(lambda: fc.route_rows_ref(binned, lids, feats, rmeta,
                                                 num_leaves), 2)
    # one decision byte and one leaf id read, one leaf id written a row;
    # the round's splits read once
    nbytes = N * (1 + 4 + 4) + rmeta.numel() * 4 + feats.numel() * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rows.append({
        "name": "route_rows", "route": "cuda", "source": FUSED_SRC,
        "replaces": "lightgbmv1_tpu/ops/wave_fused.py:558",
        "launches": int(trained["k3_launches"]), "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bytes,
        "bound_by": "bytes", "library_ms": None,
        "library_note": "none: no single PyTorch call routes rows through "
        "a tree's splits", "rows": N, "slots": int(rmeta.shape[0])})
    log(f"  K3 on {N} valid rows, {rmeta.shape[0]} slots: {ms:.4f} ms (plain "
        f"{plain_ms:.2f} ms, bound {t_bytes:.5f} ms by bytes)")
    return rows


# ---------------------------------------------------------------------------
# the persistent wave loop (K6)
# ---------------------------------------------------------------------------


class LoopRecorder:
    """Keeps the inputs of the second and the last K6 call of a run (the
    main path's own state, for the checks and the timing after it) and
    every call's split counts.  With ``k2_rounds`` the loop runs as R
    launches of K2 with the PyTorch pick and replay
    (``loop_cuda.loop_rounds``): single rounds, no K6.  It counts
    nothing; the wrappers count their launches."""

    def __init__(self, k2_rounds=False):
        self.k2_rounds = k2_rounds
        self.n_split = []
        self.second = self.last = None

    def __enter__(self):
        self._orig = lc.fused_wave_loop

        def wrapped(binned, g3, leaf_id, ft12, num_leaves, **kw):
            if self.k2_rounds:
                kw.pop("fmeta", None)
                out = lc.loop_rounds(binned, g3, leaf_id, ft12, num_leaves,
                                     round_fn=fc.fused_round, **kw)
            else:
                out = self._orig(binned, g3, leaf_id, ft12, num_leaves, **kw)
            self.last = (binned, g3, leaf_id, ft12, num_leaves, kw)
            if len(self.n_split) == 1:
                self.second = self.last
            self.n_split.append(out[3])
            return out

        lc.fused_wave_loop = wrapped
        return self

    def __exit__(self, *exc):
        lc.fused_wave_loop = self._orig


def loop_call(args, **over):
    """K6's keyword arguments of a recorded call, with ``over``."""
    binned, g3, leaf_id, ft12, num_leaves, kw = args
    kw = dict(kw, **over)
    kw.pop("fmeta", None)
    return (binned, g3, leaf_id, ft12, num_leaves), kw


class RoundRecorder:
    """A K2 round function for ``loop_rounds`` that keeps each round's
    inputs and outputs: the children's histograms and the bounds of
    phase 14 come from them."""

    def __init__(self):
        self.rounds = []

    def __call__(self, binned, g3, **kw):
        out = fc.fused_round(binned, g3, **kw)
        self.rounds.append((kw, out))
        return out


def children_of(binned, g3, kw, out):
    """A recorded K2 round's (2S, F, B, 3) children histograms: K1's
    histogram of the label (K2's, bit for bit), subtracted from the
    parents in subtraction mode."""
    _, hsm, _, label = out
    if hsm is not None:
        return wf.subtract_children(hsm, kw["parent"], kw["sml"])
    return hc.hist_leaves(binned, g3, label, kw["nslots"] + 1,
                          kw["num_bins"], kw["precision"])[:kw["nslots"]]


def check_k6(tag, args, rounds, meta, params) -> dict:
    """K6 on one segment's inputs against R launches of K2 with the
    PyTorch pick and replay (bit for bit) and against its plain version
    on the card (split counts exact; round by round, the picks identical
    outside the tie band and the values within phase 14's gain bound; the
    leaf ids exact while every pick agrees).

    The two sides sum each histogram cell in other f32 orders, and a
    larger child is its parent minus the smaller, so by round r a cell may
    carry r + 1 such differences: each within 2 (n + 1) 2^-24 of the
    absolute sum of the n rows of its leaf at the segment's start (phase
    9's bound).  A child's left sums then differ by at most those cells'
    bounds summed over the bins, plus the prefix's own 2 B 2^-24 of its
    absolute sum; the gains by what ``gain_bound`` carries from that."""
    pos, kw = args
    got = lc.fused_wave_loop(*pos, **kw)
    again = lc.fused_wave_loop(*pos, **kw)
    rec = RoundRecorder()
    k2 = lc.loop_rounds(*pos, round_fn=rec, **kw)
    plain = lc.fused_wave_loop_ref(*pos, **kw)
    names = ("packed rows", "new leaf ids", "pool", "split counts")
    for a, b, c, what in zip(got, again, k2, names):
        check(a is None or bool(same_value(a, b).all()),
              f"K6 {tag}: two launches differ in {what}")
        check(a is None or bool(same_value(a, c).all()),
              f"K6 {tag}: {what} differ from R K2 rounds")
    packed, n_split = got[0], got[3].tolist()
    check(n_split == plain[3].tolist(), f"K6 {tag}: split counts {n_split} "
          f"against the plain version's {plain[3].tolist()}")
    live = [n for n in n_split if n > 0]
    check(len(live) == len(rec.rounds) and len(live) >= 2,
          f"K6 {tag}: {len(live)} live rounds, {len(rec.rounds)} K2 rounds")
    binned, g3, lid0 = pos[0], pos[1], pos[2].long()
    B, L = kw["num_bins"], pos[3].shape[0]
    absum0 = hc.index_add_hist(binned, [g3.abs()], lid0, L, B)
    before = lid0
    err_g = err_s = 0.0
    diverged = None
    for r, (n, (rkw, out)) in enumerate(zip(live, rec.rounds)):
        ch = children_of(binned, g3, rkw, out)[:2 * n]
        csums, mask = rkw["csums"][:2 * n], rkw["mask"][:2 * n]
        left2 = scan_left_sums(ch, meta)
        gains, shift = scan_direction_gains(left2, csums, meta, mask, params)
        # each child's leaf at the segment's start, through its parent
        anc = torch.zeros(L + 1, dtype=torch.long, device=binned.device)
        anc[before] = lid0
        a0 = absum0[anc[rkw["route"]["rmeta"][:n, 0].long()]
                    .repeat_interleave(2)]                # (2n, F, B, 3)
        cell = (r + 1) * 2 * (a0[..., 2:3] + 1) * 2.0 ** -24 * a0
        lbound = (cell.sum(dim=2) + 2 * B * 2.0 ** -24 * ch.abs().sum(dim=2)
                  + 1e-6)
        gbound = gain_bound(left2, csums, gains, shift, lbound, params)
        before = out[2].long()
        pk, pp = packed[r, :2 * n], plain[0][r, :2 * n]
        fk = pk[:, 1].long()
        ci = torch.arange(2 * n, device=pk.device)
        same = (pk[:, 1:4] == pp[:, 1:4]).all(dim=1)
        if not bool(same.all()):
            # a pick inside the tie band: the plain version's gain there
            # must be within the band of K6's; later rounds split other
            # leaves and are not compared
            band = TIE_RTOL * (shift.abs() + pk[:, 0].abs())
            check(bool(((pk[:, 0] - pp[:, 0]).abs()[~same]
                        <= 4 * band[~same]).all()),
                  f"K6 {tag}: round {r} picks differ outside the tie band")
            diverged = r
            break
        fin = torch.isfinite(pk[:, 0])
        eg = torch.where(fin, (pk[:, 0] - pp[:, 0]).abs(),
                         torch.zeros_like(pk[:, 0]))
        check(bool((eg <= gbound[ci, fk]).all()), f"K6 {tag}: round {r} "
              f"gains off by {float(eg.max()):.3e} past phase 14's bound")
        lb = lbound[ci, fk]
        es = torch.where(fin[:, None], (pk[:, 4:] - pp[:, 4:]).abs(),
                         torch.zeros_like(pk[:, 4:]))
        rb = lb + 2.0 ** -23 * csums.abs()
        check(bool((es <= torch.cat([lb, rb], dim=1)).all()),
              f"K6 {tag}: round {r} sums off by {float(es.max()):.3e}")
        err_g, err_s = max(err_g, float(eg.max())), max(err_s,
                                                       float(es.max()))
    if diverged is None:
        check(torch.equal(got[1], plain[1]), f"K6 {tag}: leaf ids differ "
              "from the plain version")
    out = {"case": tag, "n_split": n_split, "max_gain_err": err_g,
           "max_sum_err": err_s, "plain_diverged_at_round": diverged,
           "buckets": [rkw["nslots"] for rkw, _ in rec.rounds]}
    log(f"  K6 {tag}: split counts {n_split}; packed rows, leaf ids and "
        f"pool bitwise equal to {len(live)} K2 rounds and across two "
        f"launches; vs the plain version: "
        + ("picks identical, " if diverged is None else
           f"a tie-band pick at round {diverged}, ")
        + f"max gain err {err_g:.2e}, sums {err_s:.2e}")
    return out


LOOP_PARAMS = dict(FUSED_PARAMS, hist_dtype_deep="bf16x2",
                   wave_loop_rounds=4)


def phase_loop_kernels(binned, meta, rng) -> list:
    """K6 against R K2 rounds and its plain version on the headline bins
    with phase 14's signed, varied rows, from a frontier captured after
    the root and two single rounds of a headline tree grown on those rows:
    R = 4, subtraction and pool-free, bf16x2 and f32."""
    N = binned.shape[1]
    config = Config.from_dict(dict(LOOP_PARAMS, wave_loop_rounds=2))
    params = SplitParams(min_data_in_leaf=float(config.min_data_in_leaf))
    grow = build_trainer(config, meta, params, 64, binned.device,
                         num_data=N)
    with LoopRecorder(k2_rounds=True) as cap:
        grow(binned, signed_rows(rng, N, binned.device), meta.usable)
    check(cap.second is not None, "one segment in a tree")
    seg = cap.second
    out = []
    for prec in ("bf16x2", "f32"):
        for sub in (True, False):
            args = loop_call(seg, rounds=4, precision=prec,
                             pool=seg[5]["pool"] if sub else None)
            out.append(check_k6(f"R=4 {'sub' if sub else 'pool-free'} "
                                f"{prec}", args, 4, meta, params))
    return out


def phase_loop_train(ds, dv, Xv, iters, dev):
    """The looped training main path (counts reset before, read after),
    then the single round with the same knobs in the same phase: the
    model texts byte-identical; the looped model served through K4."""
    reset_counts()
    ev = {}
    with LoopRecorder() as rec:
        t0 = time.perf_counter()
        booster = train(LOOP_PARAMS, ds, iters, valid_sets=[dv],
                        evals_result=ev, **_on(dev))
        _sync(dev)
        secs = time.perf_counter() - t0
    k6 = lc.launch_counts["fused_wave_loop"]
    k2 = fc.launch_counts["fused_round"]
    k3 = fc.launch_counts["route_rows"]
    k1 = hc.launch_counts["hist_leaves"]
    plain = {**{f"hist.{k}": v for k, v in hc.plain_counts.items()},
             **{f"fused.{k}": v for k, v in fc.plain_counts.items()},
             **{f"loop.{k}": v for k, v in lc.plain_counts.items()}}
    trees = booster.num_trees()
    replayed = sum(int((c > 0).sum()) for c in rec.n_split)
    log(f"  launches on the looped path: K6 {k6} "
        f"({json.dumps({str(k): v for k, v in lc.bucket_launch_counts.items()})}"
        f"), K2 {k2}, K3 {k3} ({replayed} replayed rounds), K1 {k1}; "
        f"plain-version calls: {plain}")
    check(trees == iters, f"{trees} trees for {iters} iterations")
    check(k6 == len(rec.n_split) and k6 >= trees,
          f"K6 launched {k6} times, {len(rec.n_split)} calls, {trees} trees")
    check(k2 == 0, f"K2 launched {k2} times on the looped path")
    check(k3 == replayed, f"K3 launched {k3} times for {replayed} rounds")
    check(k1 == trees, f"K1 launched {k1} times for {trees} root passes")
    check(not any(plain.values()), "a plain version ran on the looped path")
    auc = ev["valid_0"]["auc"][-1]
    n = ds.num_data()
    ev1 = {}
    t0 = time.perf_counter()
    single = train(dict(LOOP_PARAMS, wave_loop_rounds=1), ds, iters,
                   valid_sets=[dv], evals_result=ev1, **_on(dev))
    _sync(dev)
    secs1 = time.perf_counter() - t0
    text, text1 = booster.model_to_string(), single.model_to_string()
    check(text == text1, "the looped model text differs from the single "
          "round's")
    check(ev == ev1, "the looped metrics differ from the single round's")
    out = {"seconds": secs, "iters": iters, "s_per_iter": secs / iters,
           "M_row_trees_per_s": n * trees / secs / 1e6,
           "single_round_s_per_iter": secs1 / iters,
           "single_round_M_row_trees_per_s": n * trees / secs1 / 1e6,
           "valid_auc": auc, "trees": trees, "k6_launches": k6,
           "k6_launches_per_tree": k6 / trees, "k3_launches": k3,
           "k1_launches": k1, "replayed_rounds": replayed,
           "model_text_identical": True, **text_hash(text, "looped")}
    log(f"  {iters} looped iterations of {n} rows in {secs:.2f} s: "
        f"{out['s_per_iter']:.3f} s/iter, {out['M_row_trees_per_s']:.2f} M "
        f"row-trees/s; single round, same knobs: {secs1 / iters:.3f} s/iter"
        f", {out['single_round_M_row_trees_per_s']:.2f} M row-trees/s (one "
        f"run each); model text byte-identical ({len(text)} bytes), valid "
        f"AUC {auc:.5f}; K6 {out['k6_launches_per_tree']:.2f} launches a "
        "tree")
    check(auc > 0.90, f"valid AUC {auc} <= 0.90")
    out["served_max_abs_err"] = serve_trained(booster, Xv, dev,
                                              "loop_model.txt")
    return out, rec


def loop_plan(ds, dev) -> dict:
    """``plan_wave_loop`` at the headline shape on this card."""
    meta = make_feature_meta(ds._binned, dev)
    fn = wf.make_fused_wave_loop(
        meta=meta, params=SplitParams(), num_bins=64, precision="bf16x2",
        deep_precision="bf16x2", rounds=LOOP_PARAMS["wave_loop_rounds"])
    return fn.plan(N=ds.num_data(), F=F, K=63, L=255, use_sub=True,
                   slot_buckets=(4, 16, 63), device=dev)


def phase_loop_timing(rec: LoopRecorder, trained: dict, checks: list
                      ) -> dict:
    """K6 on the main path's last inputs (CUDA events over 10 launches
    after a warm-up) beside its plain version, R K2 rounds on the same
    inputs and its bound by bytes; returns the kernels-line row."""
    spos, skw = loop_call(rec.second)
    full_ms = time_ms(lambda: lc.fused_wave_loop(*spos, **skw), 10)
    full_k2_ms = time_ms(lambda: lc.loop_rounds(
        *spos, round_fn=fc.fused_round, **skw), 3)
    # one round alone (R = 1) at the first round's bucket of each segment,
    # K6 against K2 with the PyTorch pick: the cost of the loop's grid
    one_round = []
    for name, call in (("second", rec.second), ("last", rec.last)):
        opos, okw = loop_call(call, rounds=1)
        n = int(lc.fused_wave_loop(*opos, **okw)[3][0])
        one_round.append({
            "segment": name, "n_split": n,
            "S": okw["slot_buckets"][sum(n > b for b in
                                         okw["slot_buckets"][:-1])],
            "k6_ms": time_ms(lambda: lc.fused_wave_loop(*opos, **okw), 10),
            "k2_ms": time_ms(lambda: lc.loop_rounds(
                *opos, round_fn=fc.fused_round, **okw), 10)})
    pos, kw = loop_call(rec.last)
    ms = time_ms(lambda: lc.fused_wave_loop(*pos, **kw), 10)
    plain_ms = time_ms(lambda: lc.fused_wave_loop_ref(*pos, **kw), 2)
    k2_ms = time_ms(lambda: lc.loop_rounds(*pos, round_fn=fc.fused_round,
                                           **kw), 3)
    rr = RoundRecorder()
    _, _, _, n_split = lc.loop_rounds(*pos, round_fn=rr, **kw)
    binned, g3 = pos[0], pos[1]
    Fn, N = binned.shape
    B, L = kw["num_bins"], pos[3].shape[0]
    nbytes = ops = 0
    rounds = []
    for n, (rkw, out) in zip([n for n in n_split.tolist() if n > 0],
                             rr.rounds):
        ns, sub = rkw["nslots"], rkw.get("parent") is not None
        S = ns if sub else ns // 2
        live = int((out[3] < ns).sum())
        row = Fn * B * 3 * 4
        # K2's round: bins, rows, old leaf ids read, label and new leaf
        # ids written, parents read (subtraction), children's mask and
        # sums read, residue written; then the packed rows, the
        # children's frontier rows and (subtraction) pool rows written
        nbytes += (Fn * N + N * 12 + N * 4 + 2 * N * 4
                   + (S * row if sub else 0)
                   + 2 * S * (Fn + 12) + 2 * S * Fn * wf.RES_COLS * 4
                   + 2 * S * wf.PACK_COLS * 4 + 2 * n * 12 * 4
                   + (2 * n * row if sub else 0))
        ops += ((2 if kw["precision"] == "bf16x2" else 1) * 3 * live * Fn
                + 2 * S * Fn * B * 2 * 12)
        rounds.append({"S": S, "n_split": n, "live_rows": live})
    nbytes += L * 12 * 4 * 2          # the frontier read once, written once
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    n_trees = trained["trees"]
    row = {"name": "fused_wave_loop", "route": "cuda", "source": LOOP_SRC,
           "replaces": "lightgbmv1_tpu/ops/wave_fused.py:904",
           "launches": int(trained["k6_launches"]),
           "max_abs_err": max(max(c["max_gain_err"], c["max_sum_err"])
                              for c in checks),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "library_note": "none: no single PyTorch "
           "call runs a wave round", "k2_rounds_ms": k2_ms,
           "rounds": rounds, "R": len(n_split), "bytes": nbytes, "ops": ops,
           "launches_per_tree": trained["k6_launches"] / n_trees,
           "precision": kw["precision"],
           "mode": "sub" if kw.get("pool") is not None else "pool",
           "ms_second_segment": full_ms,
           "k2_rounds_ms_second_segment": full_k2_ms,
           "n_split_second_segment": rec.n_split[1].tolist(),
           "one_round": one_round, "checks": checks}
    log(f"  K6 ({row['precision']}, {row['mode']}, rounds "
        f"{[r['S'] for r in rounds]} of R={row['R']}): {ms:.3f} ms a launch "
        f"(plain {plain_ms:.1f} ms, {len(rounds)} K2 rounds + PyTorch pick "
        f"and replay {k2_ms:.3f} ms, bound {row['bound_ms']:.4f} ms by "
        f"{row['bound_by']}), {row['launches_per_tree']:.2f} launches a "
        f"tree; on the run's second segment (tree 1, rounds 5-8, split "
        f"counts {row['n_split_second_segment']}) {full_ms:.3f} ms, its K2 "
        f"rounds + PyTorch pick and replay {full_k2_ms:.3f} ms")
    for o in one_round:
        log(f"  one round alone, {o['segment']} segment's first (S="
            f"{o['S']}, {o['n_split']} splits): K6 {o['k6_ms']:.3f} ms, K2 + "
            f"PyTorch pick and replay {o['k2_ms']:.3f} ms")
    return row


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--train-rows", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this runs "
              "the port on a CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.RandomState(args.seed)

    log("== phase 1: device")
    card = nvidia_smi()
    log(card)
    log(f"  torch {torch.__version__} CUDA {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    log("== phase 2: build")
    secs = _build.build(["predict_walk", "hist", "wave_fused", "wave_loop"])
    for name, rec in _build.build_log.items():
        log(f"  nvcc {name}.cu: {rec['seconds']:.1f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    log(f"  built: {sorted(secs) or 'already built'}")

    log("== phase 3: model")
    t0 = time.perf_counter()
    text_a, trees_a = make_model(args.seed)
    text_b, trees_b = make_model(args.seed + 1, n_grid=13)   # packed codes
    text_c, trees_c = make_model(args.seed + 2, n_trees=60, num_class=3)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "smoke_model.txt")
    with open(path, "w") as fh:
        fh.write(text_a)
    booster = Booster(model_file=path)
    booster_b = Booster(model_str=text_b)
    trees = booster._all_trees()
    check(len(trees) == 500 and booster.num_feature() == F, "model shape")
    check(str(booster.device) == "cuda", f"booster on {booster.device}")
    depth = max(int(leaf_depths(trees, 255).max()), 0)
    log(f"  {len(trees)} trees x 255 leaves, {F} features, depth {depth}, "
        f"{len(text_a) / 1e6:.1f} MB of text, {time.perf_counter() - t0:.1f} s")

    log("== phase 4: kernels against their plain versions")
    errs = phase_kernels({
        "A(u8,K=1)": (text_a, trees_a, 1, {}),
        "B(packed,K=1)": (text_b, trees_b, 1, {}),
        "C(u8,K=3)": (text_c, trees_c, 3, {}),
    }, dev, 1 << 17, rng)          # the bulk path's chunk shape

    log("== phase 5: bulk predict (main path; launch counts reset)")
    pc.reset_launch_counts()
    bulk = phase_bulk(booster, trees, args.rows, rng)
    log("== phase 6: server")
    snap = phase_server(booster, booster_b, args.requests, rng, dev)
    torch.cuda.synchronize()
    launches = dict(pc.launch_counts)

    log("== phase 7: launches, timing, bounds")
    log(f"  launches on the main path: {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the main path")
    bp = booster._device_predictor(trees, 1, 0, "fused", {})
    check(bp.fused_plan["eligible"], f"fused plan: {bp.fused_plan}")
    log(f"  fused plan: {json.dumps(bp.fused_plan)}")
    rows = phase_timing(booster, trees, dev, launches, errs, rng)

    log("== phase 8: training data")
    t0 = time.perf_counter()
    X, y = make_data(args.train_rows, args.seed)
    Xv, yv = make_data(VALID_ROWS, args.seed + 1)
    ds = Dataset(X, label=y, params=TRAIN_PARAMS)
    dv = Dataset(Xv, label=yv, reference=ds)
    ds.construct()
    dv.construct()
    bin_s = time.perf_counter() - t0
    log(f"  {args.train_rows} + {VALID_ROWS} rows x {F} made and binned "
        f"in {bin_s:.1f} s (bin axis {ds._binned.padded_bin})")
    check(ds._binned.padded_bin == 64, "bin axis is not 64")

    log("== phase 9: K1 against its plain version")
    binned = torch.as_tensor(ds._binned.binned, device=dev).contiguous()
    k1_checks = phase_hist_kernel(binned, dev, rng)
    del binned

    log("== phase 10: training (main path; launch counts reset)")
    trained, rec = phase_train(ds, dv, Xv, args.iters, dev)
    log("  K1 against its plain version on the main path's last inputs")
    k1_checks += phase_hist_main_inputs(rec)

    log("== phase 11: f32 parity, card vs CPU")
    parity = phase_parity(args.seed, dev)

    log("== phase 12: K1 timing at the main path's buckets")
    k1_row = phase_hist_timing(rec, trained, k1_checks)
    del rec

    log("== phase 13: where a training iteration's time goes")
    prof = phase_profile(ds, 5, dev)

    log("== phase 14: K2 and K3 against their plain versions")
    binned = torch.as_tensor(ds._binned.binned, device=dev).contiguous()
    k2_checks = phase_fused_kernels(binned, make_feature_meta(ds._binned,
                                                              dev), rng)
    del binned

    log("== phase 15: fused training (main path; launch counts reset)")
    fused, frec = phase_fused_train(ds, dv, Xv, args.iters, dev, trained)
    log("  K2 against its plain version on the main path's last inputs")
    k2_checks += phase_fused_main_inputs(frec)

    log("== phase 16: f32 parity on the card, fused vs staged")
    fparity = same_splits(args.seed, 65536, {
        "fused": (dict(PARITY_PARAMS, hist_method="fused"), dev),
        "staged": (PARITY_PARAMS, dev)})

    log("== phase 17: K2 and K3 timing at the main path's buckets")
    fused_rows = phase_fused_timing(frec, fused, k2_checks)
    del frec

    log("== phase 18: where a fused training iteration's time goes")
    fprof = phase_profile(ds, 5, dev, FUSED_PARAMS)

    log("== phase 19: K6 against R K2 rounds and its plain version")
    plan = loop_plan(ds, dev)
    log(f"  plan at the headline: {json.dumps(plan)}")
    check(plan["eligible"], f"the loop's plan refuses: {plan['reason']}")
    binned = torch.as_tensor(ds._binned.binned, device=dev).contiguous()
    k6_checks = phase_loop_kernels(binned, make_feature_meta(ds._binned,
                                                             dev), rng)
    del binned

    log("== phase 20: looped training (main path; launch counts reset)")
    looped, lrec = phase_loop_train(ds, dv, Xv, args.iters, dev)

    log("== phase 21: K6 timing and where a looped iteration's time goes")
    k6_row = phase_loop_timing(lrec, looped, k6_checks)
    k6_row["plan"] = plan
    del lrec
    lprof = phase_profile(ds, 5, dev, LOOP_PARAMS)
    log(json.dumps({"rows_per_s": {m: bulk[m]["rows_per_s"]
                                   for m in ("fused", "pallas")},
                    "host_prebin_s": bulk["encode_s"],
                    "predictor_build_s": bulk["build_fused_s"],
                    "server": {k: snap[k] for k in (
                        "qps", "p50_ms", "p99_ms", "batches",
                        "batch_occupancy", "steady")},
                    "train": trained,
                    "train_binning_s": bin_s, "parity": parity,
                    "train_profile": prof, "fused_train": fused,
                    "fused_parity": fparity, "fused_profile": fprof,
                    "loop_train": looped, "loop_profile": lprof,
                    "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": [k1_row] + fused_rows + [k6_row] + rows}),
          flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
