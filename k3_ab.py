#!/usr/bin/env python3
"""K3, the valid routing, and the round-to-nearest quantize kernel of two
checkouts of the port, timed on one NVIDIA card in the order A, B, B, A
(``ab_driver.py``).

    python3 k3_ab.py A_ROOT B_ROOT [--iters 50] [--train-rows 1048576]

Each checkout runs in a process of its own, its package first on the
path, with its own ``chip_smoke.py`` helpers: phase 8's rows
(``make_data``, ``VALID_ROWS`` valid rows), then

* a recorded tree's valid routing: a two-iteration fused training
  (``FUSED_PARAMS``) records every call of the valid router in the last
  tree (a checkout that routes a round a call: each round's
  ``fused_route_rows``; one that routes once a tree: its
  ``grower_wave.route_valid_sets``, the store's split rows, the offsets
  and the one K3 launch), and the whole routing of that tree is timed
  again on those inputs by CUDA events
  (``chip_smoke.time_ms`` over 20 trees, three times), host ops
  included, and on the device (torch.profiler, K3's kernels), warm
  (back to back) and with the L2 cleared before each tree (``cold``);
* the staged, fused and looped headline trainings of phases 10, 15 and 20
  (``TRAIN_PARAMS``, ``FUSED_PARAMS``, ``LOOP_PARAMS``), ``--iters``
  iterations each with the valid set, after a two-iteration warm-up each:
  s/iteration, K3's launches, the model text's sha256 and the valid
  metrics;
* ``rn_quantize`` on 1,048,576 bagged rows (``bagged_rows``) at each row
  tile T: by events (20 launches, three times) and on the device, warm
  and with the L2 cleared before each launch.

Each process prints one JSON line; the last line is the summary, each
number the two runs of a checkout side by side, with the card's name and
power limit.  Exits 1 if the checkouts' model texts or valid metrics
differ, or a checkout's recorded routing differs from the tree walk of
its tree, 2 without a card.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import ab_driver

LIBS = ["hist", "wave_fused", "wave_loop", "quantize", "split_scan"]
REPEATS = 3
QUANT_ROWS = 1 << 20
L2_FLUSH_BYTES = 256 << 20     # five times the H100's 50 MB L2


def cold(fn):
    """``fn`` after a write of L2_FLUSH_BYTES on the same stream, so its
    kernels read their inputs from HBM (the write's kernel is not one of
    the names timed)."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def flushed():
        flush.zero_()
        return fn()
    return flushed


def child(root: str, iters: int, rows: int) -> dict:
    """One checkout's routing, training and quantize times."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from lightgbmv1_tpu_torch import Dataset, train
    from lightgbmv1_tpu_torch.models import grower_wave as gw
    from lightgbmv1_tpu_torch.models.tree import tree_leaf_index_binned
    from lightgbmv1_tpu_torch.ops import _build
    from lightgbmv1_tpu_torch.ops import fused_cuda as fc
    from lightgbmv1_tpu_torch.ops import quantize as qz
    from lightgbmv1_tpu_torch.ops import wave_fused as wf

    t0 = time.perf_counter()
    _build.build(LIBS)
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    X, y = cs.make_data(rows, 0)
    Xv, yv = cs.make_data(cs.VALID_ROWS, 1)
    ds = Dataset(X, label=y, params=cs.TRAIN_PARAMS)
    dv = Dataset(Xv, label=yv, reference=ds)
    ds.construct()
    dv.construct()

    # ---- the recorded tree's valid routing -------------------------------
    calls = []
    tree_end = hasattr(gw, "route_valid_sets")   # routes once a tree
    if tree_end:
        orig_route = gw.route_valid_sets

        def route(*args, **kw):
            calls.append((args, kw))
            return orig_route(*args, **kw)

        gw.route_valid_sets = route
    else:
        orig_route = wf.fused_route_rows

        def route(binned, lids, **kw):
            calls.append((binned, lids, kw))
            return orig_route(binned, lids, **kw)

        wf.fused_route_rows = route
    bst = train(cs.FUSED_PARAMS, ds, 2, valid_sets=[dv])
    torch.cuda.synchronize()
    if tree_end:
        gw.route_valid_sets = orig_route
        args, kw = calls[-1]

        def tree_routing():
            return orig_route(*args, **kw)[0]
        rounds = len(args[2])
    else:
        wf.fused_route_rows = orig_route
        # the last tree's rounds: from its last call with root leaf ids
        first = max(i for i, (_, lids, _) in enumerate(calls)
                    if int(lids.max()) == 0)
        tree_calls = calls[first:]

        def tree_routing():
            out = None
            for binned, lids, kw in tree_calls:
                out = orig_route(binned, lids if out is None else out, **kw)
            return out
        rounds = len(tree_calls)
    gbdt = bst._gbdt
    vbin = gbdt._valid_binned[0]
    walk = tree_leaf_index_binned(gbdt._device_trees[-1], vbin,
                                  gbdt.meta.nan_bin, gbdt.meta.missing_type,
                                  gbdt.meta.zero_bin, gbdt._packed)
    exact = torch.equal(tree_routing(), walk.to(torch.int32))
    names = ("route_kernel", "route_global_kernel", "route_tables_kernel")
    routing = {
        "rounds": rounds, "exact_vs_tree_walk": exact,
        "ms": [cs.time_ms(tree_routing, 20) for _ in range(REPEATS)],
        "device_ms": [sum(cs.kernel_device_ms(tree_routing, names).values())
                      for _ in range(REPEATS)],
        "cold_device_ms": [sum(cs.kernel_device_ms(
            cold(tree_routing), names).values())
            for _ in range(REPEATS)]}

    # ---- the headline trainings ------------------------------------------
    trainings = {}
    for name, params in (("staged", cs.TRAIN_PARAMS),
                         ("fused", cs.FUSED_PARAMS),
                         ("looped", cs.LOOP_PARAMS)):
        train(params, ds, 2, valid_sets=[dv])
        torch.cuda.synchronize()
        fc.reset_launch_counts()
        ev = {}
        t0 = time.perf_counter()
        bst = train(params, ds, iters, valid_sets=[dv], evals_result=ev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        trainings[name] = {
            "s_per_iter": secs / iters,
            "k3_launches": fc.launch_counts["route_rows"],
            "text_sha256": hashlib.sha256(
                bst.model_to_string().encode()).hexdigest(),
            "valid": ev["valid_0"]}

    # ---- rn_quantize at each row tile ------------------------------------
    g3 = cs.bagged_rows(np.random.RandomState(3), QUANT_ROWS, dev)
    quant = {}
    for T in qz.ROW_TILES:
        def fn(T=T):
            return qz.rn_quantize(g3, T)
        name = ("rn_quantize_kernel",)
        quant[T] = {
            "ms": [cs.time_ms(fn, 20) for _ in range(REPEATS)],
            "device_ms": [cs.kernel_device_ms(fn, name)[name[0]]
                          for _ in range(REPEATS)],
            "cold_device_ms": [cs.kernel_device_ms(cold(fn), name)
                               [name[0]] for _ in range(REPEATS)]}
    return {"root": root, "build_s": build_s, "tree_end": tree_end,
            "routing": routing, "trainings": trainings, "rn_quantize": quant}


def add_args(ap) -> None:
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--train-rows", type=int, default=1 << 20)


def summarize(res, pair):
    """The routing, s/iteration and quantize times side by side; ok: one
    model text and one metric history a path across the runs, and every
    recorded routing the tree walk's."""
    paths = res[0]["trainings"]
    keys = {
        "routing": {k: pair(lambda r: r["routing"][k])
                    for k in ("rounds", "ms", "device_ms", "cold_device_ms",
                              "exact_vs_tree_walk")},
        "s_per_iter": {p: pair(lambda r: r["trainings"][p]["s_per_iter"])
                       for p in paths},
        "k3_launches": {p: pair(lambda r: r["trainings"][p]["k3_launches"])
                        for p in paths},
        "rn_quantize": {T: {k: pair(lambda r: r["rn_quantize"][T][k])
                            for k in ("ms", "device_ms", "cold_device_ms")}
                        for T in res[0]["rn_quantize"]},
        "text_sha256": {p: res[0]["trainings"][p]["text_sha256"]
                        for p in paths}}
    same = all(r["trainings"][p]["text_sha256"] == keys["text_sha256"][p]
               and r["trainings"][p]["valid"]
               == res[0]["trainings"][p]["valid"]
               for r in res for p in paths)
    exact = all(r["routing"]["exact_vs_tree_walk"] for r in res)
    keys["texts_and_metrics_equal"] = same
    return keys, same and exact


if __name__ == "__main__":
    sys.exit(ab_driver.main(
        __file__, __doc__, "K3 and rn_quantize",
        lambda root, args: child(root, args.iters, args.train_rows),
        summarize, add_args))
