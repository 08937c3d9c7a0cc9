#!/usr/bin/env python3
"""The persistent wave loop (K6) of two checkouts of the port, timed on one
NVIDIA card in the order A, B, B, A
(``ab_driver.py``).

    python3 k6_ab.py A_ROOT B_ROOT [--iters 50] [--train-rows 1048576]

Each checkout runs in a process of its own, its package first on the
path, with its own ``chip_smoke.py`` helpers: phase 8's rows
(``make_data``), then the looped training of phase 20 (``LOOP_PARAMS``:
the headline configuration at bf16x2, ``wave_loop_rounds=4``) and of
phase 29 (``INT8SR_PARAMS`` looped: the 16- and 63-slot rounds
quantized), ``--iters`` iterations each.  K6 is then timed on each
training's last launch inputs by CUDA events (``chip_smoke.time_ms``, 20
launches, three times); the int8sr launch also with its quantized buckets
dropped, so the same inputs run an unquantized ladder.  Each process
prints one JSON line (model text sha256, s/iteration, the K6 times and
nvcc's register lines for ``wave_loop.cu``); the last line is the summary,
each number the two runs of a checkout side by side.  Exits 1 if the two
checkouts write different model texts, 2 without a card.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import ab_driver

LIBS = ["hist", "wave_fused", "wave_loop", "quantize"]


def child(root: str, iters: int, rows: int) -> dict:
    """One checkout's trainings and K6 times."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from lightgbmv1_tpu_torch import Dataset, train
    from lightgbmv1_tpu_torch.ops import _build
    from lightgbmv1_tpu_torch.ops import loop_cuda as lc

    _build.build(LIBS)
    regs = [line.strip() for line in
            _build.build_log.get("wave_loop", {}).get("log", "").splitlines()
            if "registers" in line or "spill" in line]
    X, y = cs.make_data(rows, 0)
    ds = Dataset(X, label=y, params=cs.TRAIN_PARAMS)
    ds.construct()
    out = {"root": root, "wave_loop_ptxas": regs}
    runs = (("bf16x2", cs.LOOP_PARAMS),
            ("int8sr", dict(cs.INT8SR_PARAMS, hist_method="fused",
                            wave_loop_rounds=4)))
    for name, params in runs:
        with cs.LoopRecorder() as rec:
            t0 = time.perf_counter()
            booster = train(params, ds, iters, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        pos, kw = cs.loop_call(rec.last)
        r = {"sha256": hashlib.sha256(
                 booster.model_to_string().encode()).hexdigest(),
             "s_per_iter": secs / iters,
             "quant_buckets": list(kw.get("quant_buckets", ())),
             "ms": [cs.time_ms(lambda: lc.fused_wave_loop(*pos, **kw), 20)
                    for _ in range(3)]}
        if kw.get("quant_buckets"):
            ukw = dict(kw, quant_buckets=())
            r["unquantized_ms"] = [
                cs.time_ms(lambda: lc.fused_wave_loop(*pos, **ukw), 20)
                for _ in range(3)]
        out[name] = r
    return out


def add_args(ap) -> None:
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--train-rows", type=int, default=1 << 20)


def summarize(res, pair):
    """Each training's texts equal across the checkouts, and its times."""
    keys, same = {}, True
    for name in ("bf16x2", "int8sr"):
        shas = {r[name]["sha256"] for r in res}
        same &= len(shas) == 1
        keys[name] = {"texts_equal": len(shas) == 1, "sha256": sorted(shas)}
        for key in ("ms", "unquantized_ms", "s_per_iter"):
            if key in res[0][name]:
                keys[name][key] = pair(lambda r: r[name][key])
    return keys, same


if __name__ == "__main__":
    sys.exit(ab_driver.main(
        __file__, __doc__, "K6",
        lambda root, args: child(root, args.iters, args.train_rows),
        summarize, add_args))
