#!/usr/bin/env python3
"""The split scan and the fused round's pick of two checkouts of the port,
timed on one NVIDIA card in the order A, B, B, A
(``ab_driver.py``).

    python3 scan_ab.py A_ROOT B_ROOT [--iters 50] [--train-rows 1048576]

Each checkout runs in a process of its own, its package first on the
path, with its own ``chip_smoke.py`` helpers: phase 8's rows
(``make_data``), then the staged training of phase 10 (``TRAIN_PARAMS``)
and the fused training of phase 15 (``FUSED_PARAMS``), ``--iters``
iterations each, recording the growers' last ``find_best_split`` call at
each child count C and the last K2 call at each slot bucket.  On those
inputs the whole ``find_best_split`` at C = 1, 8, 32 and 126 is timed by
CUDA events (``chip_smoke.time_ms`` over 50 calls, five times, the
median), with the device kernels one call runs and their device time
(torch.profiler); then K2's round with the checkout's pick (the pick
kernel where the checkout has one, else ``gain_shift`` + ``pick_pack``),
K2 alone and the pick alone, with the pick's device kernels.  Then the
split-scan kernel's device time on the first k features of the C = 8
and 126 inputs (k = 1, 4, 7, 14, 28: the warps a child's block runs), and
the registers and spills ptxas reports for its instances when the
process built them.  Each process prints one JSON line; the last line is the summary, each number
the two runs of a checkout side by side, with the card's name and power
limit.  Exits 1 if the checkouts' staged or fused model texts differ (or
a checkout's staged text differs from its fused text), 2 without a card.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import ab_driver

LIBS = ["hist", "wave_fused", "split_scan"]
REPEATS = 5
SCAN_C = (1, 8, 32, 126)
BY_FEATURES = ((8, 126), (1, 4, 7, 14, 28))


def child(root: str, iters: int, rows: int) -> dict:
    """One checkout's trainings and its scan and pick times."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from lightgbmv1_tpu_torch import Dataset, train
    from lightgbmv1_tpu_torch.models import grower, grower_wave
    from lightgbmv1_tpu_torch.ops import _build
    from lightgbmv1_tpu_torch.ops import fused_cuda as fc
    from lightgbmv1_tpu_torch.ops import scan_cuda as sc
    from lightgbmv1_tpu_torch.ops import split

    def device_kernels(fn):
        """(names, device ms) of the device work of one ``fn()``."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.time_range.elapsed_us() for e in ev)
        return [e.name for e in ev], us / 1e3

    def scan_device_ms(fn, reps=20):
        """Mean device ms of the split-scan kernels one ``fn()`` runs,
        over ``reps`` calls."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "split_scan" in e.name) / reps / 1e3

    def median_ms(fn, reps=50):
        return float(np.median([cs.time_ms(fn, reps)
                                for _ in range(REPEATS)]))

    built = _build.build(LIBS)
    X, y = cs.make_data(rows, 0)
    ds = Dataset(X, label=y, params=cs.TRAIN_PARAMS)
    ds.construct()
    last = {}

    def record(fn):
        def wrapped(hist, *a, **kw):
            last[hist.shape[0]] = (hist, a, kw)
            return fn(hist, *a, **kw)
        return wrapped

    orig = grower.find_best_split, grower_wave.find_best_split
    grower.find_best_split = record(orig[0])
    grower_wave.find_best_split = record(orig[1])
    out = {"root": root}
    try:
        t0 = time.perf_counter()
        staged = train(cs.TRAIN_PARAMS, ds, iters, device="cuda")
        torch.cuda.synchronize()
        out["staged_s_per_iter"] = (time.perf_counter() - t0) / iters
    finally:
        grower.find_best_split, grower_wave.find_best_split = orig
    with cs.FusedRecorder() as frec:
        t0 = time.perf_counter()
        fused = train(cs.FUSED_PARAMS, ds, iters, device="cuda")
        torch.cuda.synchronize()
        out["fused_s_per_iter"] = (time.perf_counter() - t0) / iters
    for name, bst in (("staged", staged), ("fused", fused)):
        out[f"{name}_sha256"] = hashlib.sha256(
            bst.model_to_string().encode()).hexdigest()
    out["find_best_split"] = {}
    for C in SCAN_C:
        if C not in last:
            continue
        hist, a, kw = last[C]

        def fbs():
            return split.find_best_split(hist, *a, **kw)

        names, dev_ms = device_kernels(fbs)
        scan_dev = [n for n in names if "split_scan" in n]
        out["find_best_split"][str(C)] = {
            "ms": median_ms(fbs), "kernels": len(names),
            "device_ms": dev_ms, "scan_kernels": len(scan_dev)}
    out["scan_device_ms_by_features"] = {}
    for C in BY_FEATURES[0]:
        if C not in last:
            continue
        hist, a, kw = last[C]
        parent_sum, meta, mask, params = a[:4]
        for k in BY_FEATURES[1]:
            if k > hist.shape[1]:
                continue
            sub = split.FeatureMeta(*(None if x is None
                                      else x[:k].contiguous()
                                      for x in tuple(meta)[:7]))
            if hasattr(split, "with_tables"):
                sub = split.with_tables(sub)
            h, m = hist[:, :k].contiguous(), mask[:, :k].contiguous()

            def fbs_k(h=h, m=m, sub=sub):
                return split.find_best_split(h, parent_sum, sub, m, params,
                                             **kw)

            out["scan_device_ms_by_features"][f"C={C} F={k}"] = \
                scan_device_ms(fbs_k)
    if "split_scan" in built and hasattr(cs, "ptxas_kernels"):
        out["ptxas"] = [k for k in cs.ptxas_kernels(
            _build.build_log["split_scan"]["log"])
            if "split_scan" in k["kernel"]]
    out["pick"] = {}
    has_pick = hasattr(sc, "split_pick")
    for (ns, prec, mode), (binned, g3, kw) in sorted(frec.last.items()):
        res = fc.fused_round(binned, g3, **kw)[0]
        csums, B = kw["csums"], kw["num_bins"]
        pout = kw.get("parent_output")

        if has_pick:
            def pick(r=res):
                return sc.split_pick(r, csums, meta=kw["meta"],
                                     params=kw["params"],
                                     parent_output=pout, num_bins=B)
        else:
            def pick(r=res):
                return split.pick_pack(r, split.gain_shift(
                    csums, kw["params"], pout), csums, kw["meta"], B)

        def round_pick():
            return pick(fc.fused_round(binned, g3, **kw)[0])

        names, dev_ms = device_kernels(pick)
        out["pick"][f"{ns}:{prec}:{mode}"] = {
            "round_with_pick_ms": median_ms(round_pick, 10),
            "k2_ms": median_ms(lambda: fc.fused_round(binned, g3, **kw), 10),
            "pick_ms": median_ms(pick), "pick_kernels": len(names),
            "pick_device_ms": dev_ms}
    return out


def add_args(ap) -> None:
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--train-rows", type=int, default=1 << 20)


def summarize(res, pair):
    """The times side by side; ok: one staged and one fused text across
    the checkouts, each checkout's staged text its fused one."""
    shas = {(r["staged_sha256"], r["fused_sha256"]) for r in res}
    ok = len(shas) == 1 and all(r["staged_sha256"] == r["fused_sha256"]
                                for r in res)
    keys = {"staged_s_per_iter": pair(lambda r: r["staged_s_per_iter"]),
            "fused_s_per_iter": pair(lambda r: r["fused_s_per_iter"])}
    for C in res[0]["find_best_split"]:
        for k in res[0]["find_best_split"][C]:
            keys[f"find_best_split C={C} {k}"] = pair(
                lambda r: r["find_best_split"][C][k])
    for key in res[0]["pick"]:
        for k in res[0]["pick"][key]:
            keys[f"pick {key} {k}"] = pair(lambda r: r["pick"][key][k])
    for key in res[0]["scan_device_ms_by_features"]:
        keys[f"scan device ms {key}"] = pair(
            lambda r: r["scan_device_ms_by_features"].get(key))
    for name, r in (("A", res[0]), ("B", res[1])):
        if "ptxas" in r:
            keys[f"ptxas {name}"] = r["ptxas"]
    return keys, ok


if __name__ == "__main__":
    sys.exit(ab_driver.main(
        __file__, __doc__, "the split scan",
        lambda root, args: child(root, args.iters, args.train_rows),
        summarize, add_args))
