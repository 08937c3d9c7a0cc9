#!/usr/bin/env python3
"""K5, the serving leaf walk, of two checkouts of the port, timed on one
NVIDIA card in the order A, B, B, A
(``ab_driver.py``).

    python3 k5_ab.py A_ROOT B_ROOT [--rows 131072] [--plans]

Each checkout runs in a process of its own, its package first on the
path, with its own ``chip_smoke.py`` helpers: phase 3's headline serving
model (``make_model(0)``: 500 trees of 255 leaves, 28 features) and
``make_rows``' codes (u8).  K5 is first held to its plain version at u8,
u16 and i32 codes, then timed at 256, 512, 1,024 and ``--rows`` rows by
CUDA events (``chip_smoke.time_ms``: 100 launches at the buckets, 20 at
``--rows``, three times) and on the device (torch.profiler, the kernel
``serving_leaf_kernel``), beside K4's leaf mode on the same codes (its
walk kernel's device time).  With ``--plans``, a checkout whose
``serving_leaf`` takes ``plan=`` also runs each plan of ``PLANS`` (group,
row tile) at 1,001 rows against the plain version and times it at 256,
512, 1,024 and ``--rows`` rows.  Each process prints one JSON line with the
registers and spills ptxas reports for ``predict_walk.cu``; the last line
is the summary, each number the two runs of a checkout side by side, with
the card's name and power limit.  Exits 1 if a checkout's leaf ids
differ from its plain version's, 2 without a card.
"""

from __future__ import annotations

import inspect
import os
import sys

import ab_driver

SIZES = (256, 512, 1024)
REPEATS = 3
# (group, rows a block) of the launch plans --plans times
PLANS = ((4, 128), (4, 256), (8, 64), (8, 128), (8, 256), (16, 128),
         (16, 256), (32, 256))


def child(root: str, rows: int, plans: bool) -> dict:
    """One checkout's checks and K5 / K4-leaf times."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from lightgbmv1_tpu_torch.models.predict import BatchPredictor
    from lightgbmv1_tpu_torch.ops import _build
    from lightgbmv1_tpu_torch.ops import predict_cuda as pc

    _build.build(["predict_walk"])
    regs = [line.strip() for line in
            _build.build_log.get("predict_walk", {}).get("log", "")
            .splitlines() if "registers" in line or "spill" in line]
    dev = torch.device("cuda")
    _, trees = cs.make_model(0)
    bp = BatchPredictor(trees, 1, cs.F, method="fused", device=dev)
    codes = torch.from_numpy(bp.binner.prebin(
        cs.make_rows(np.random.RandomState(1), rows))).to(dev)
    tables, nr = pc.walk_tables(bp.arrays), bp._fused_tables
    kw = dict(n_steps=bp.depth, zero_code=bp.binner.zero_code,
              nan_code=bp.binner.nan_code)
    want = pc.serving_leaf_ref(tables, codes, **kw)
    exact = all(torch.equal(pc.serving_leaf(tables, codes.to(dt), **kw),
                            want)
                for dt in (torch.uint8, torch.uint16, torch.int32))

    def k5(sub, **extra):
        return lambda: pc.serving_leaf(tables, sub, **kw, **extra)

    def k4_leaf(sub):
        return lambda: pc.serving_fused(nr, sub, mode="leaf", K=1, **kw)

    def device_ms(fn, name):
        return cs.kernel_device_ms(fn, (name,))[name]

    out = {"root": root, "exact": exact, "predict_walk_ptxas": regs,
           "sizes": {}}
    for m in SIZES + (rows,):
        sub = codes[:m]
        reps = 20 if m == rows else 100
        out["sizes"][m] = {
            "k5_ms": [cs.time_ms(k5(sub), reps) for _ in range(REPEATS)],
            "k5_device_ms": device_ms(k5(sub), "serving_leaf_kernel"),
            "k4_leaf_ms": [cs.time_ms(k4_leaf(sub), reps)
                           for _ in range(REPEATS)],
            "k4_leaf_device_ms": device_ms(k4_leaf(sub),
                                           "serving_fused_kernel")}
    if plans and "plan" in inspect.signature(pc.serving_leaf).parameters:
        out["plans"] = {}
        stride = 4 * (-(-codes.shape[1] // 4) | 1)
        for group, r in PLANS:
            plan = dict(group=group, rows=r, threads=r, stride_bytes=stride)
            ok = torch.equal(pc.serving_leaf(tables, codes[:1001], plan=plan,
                                             **kw), want[:1001])
            exact = exact and ok
            out["plans"][f"{group}x{r}"] = {
                "exact": ok,
                "ms": {m: min(cs.time_ms(k5(codes[:m], plan=plan),
                                         20 if m == rows else 100)
                              for _ in range(REPEATS))
                       for m in SIZES + (rows,)},
                "device_ms": {m: device_ms(k5(codes[:m], plan=plan),
                                           "serving_leaf_kernel")
                              for m in SIZES + (rows,)}}
        out["default_plan"] = pc.plan_leaf_walk(
            T=len(trees), L1=tables.split_feature.shape[1],
            F=codes.shape[1], code_bytes=1)
    out["exact"] = exact
    return out


def add_args(ap) -> None:
    ap.add_argument("--rows", type=int, default=1 << 17)
    ap.add_argument("--plans", action="store_true")


def summarize(res, pair):
    """Each size's times side by side; ok: every checkout's leaf ids
    equal its plain version's."""
    keys = {"exact": {"A": res[0]["exact"] and res[3]["exact"],
                      "B": res[1]["exact"] and res[2]["exact"]},
            "sizes": {m: {key: pair(lambda r: r["sizes"][m][key])
                          for key in res[0]["sizes"][m]}
                      for m in res[0]["sizes"]}}
    return keys, all(keys["exact"].values())


if __name__ == "__main__":
    sys.exit(ab_driver.main(
        __file__, __doc__, "K5",
        lambda root, args: child(root, args.rows, args.plans),
        summarize, add_args))
