#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--rows 1048576] [--requests 500]

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
              bound, and the ``kernels`` line is printed.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from lightgbmv1_tpu_torch import Booster
from lightgbmv1_tpu_torch.io.binning import (K_ZERO_THRESHOLD, MISSING_NAN,
                                             MISSING_ZERO)
from lightgbmv1_tpu_torch.io.model_text import model_to_string
from lightgbmv1_tpu_torch.models.predict import BatchPredictor
from lightgbmv1_tpu_torch.models.tree import HostTree
from lightgbmv1_tpu_torch.ops import _build, predict_cuda as pc
from lightgbmv1_tpu_torch.serve import ServeConfig, Server

F = 28                      # features of the bench headline model
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
# 4-byte shared-memory / L1 gathers a second: 132 SMs x 32 banks x
# 1.98 GHz boost clock (Hopper: 32 banks of 4 B per SM per clock)
GATHERS_PER_S = 132 * 32 * 1.98e9
SRC = "lightgbmv1_tpu_torch/csrc/predict_walk.cu"


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
    secs = _build.build(["predict_walk"])
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
    log(json.dumps({"rows_per_s": {m: bulk[m]["rows_per_s"]
                                   for m in ("fused", "pallas")},
                    "host_prebin_s": bulk["encode_s"],
                    "predictor_build_s": bulk["build_fused_s"],
                    "server": {k: snap[k] for k in (
                        "qps", "p50_ms", "p99_ms", "batches",
                        "batch_occupancy", "steady")},
                    "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
