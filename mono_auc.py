#!/usr/bin/env python3
"""Held-out AUC of the headline configuration under chip_smoke.py phase
32's monotone constraints, trained by the JAX package and by the port on
the CPU.

    JAX_PLATFORMS=cpu python3 mono_auc.py [--rows 262144] [--iters 50]
                                          [--package jax|port|both]

The data is chip_smoke.py's copy of bench.py:42 make_data (``--rows``
training rows, 131,072 valid rows); the configuration is chip_smoke's
TRAIN_PARAMS with no constraint, then ``monotone_constraints = [1, -1,
0, 0, 1] + [0] * 23`` in ``basic`` and in ``intermediate`` mode.  Prints
one line a training: package, mode, valid AUC after ``--iters``
iterations, seconds.  It is the reference for phase 32's AUC gate: the
monotone bounds cost the model accuracy by design, in the JAX package as
in the port.
"""

import argparse
import time

import chip_smoke as cs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=262144)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--package", default="both",
                    choices=("jax", "port", "both"))
    args = ap.parse_args()
    X, y = cs.make_data(args.rows, 0)
    Xv, yv = cs.make_data(cs.VALID_ROWS, 1)
    packages = ("jax", "port") if args.package == "both" else (args.package,)
    for package in packages:
        for mode in ("none", "basic", "intermediate"):
            p = dict(cs.TRAIN_PARAMS)
            if mode != "none":
                p.update(monotone_constraints=cs.MONO,
                         monotone_constraints_method=mode)
            ev = {}
            t0 = time.perf_counter()
            if package == "jax":
                import lightgbmv1_tpu as lj
                lj.train(p, lj.Dataset(X, label=y), args.iters,
                         valid_sets=[lj.Dataset(Xv, label=yv)],
                         evals_result=ev, verbose_eval=False)
            else:
                cs.train(p, cs.Dataset(X, label=y), args.iters,
                         valid_sets=[cs.Dataset(Xv, label=yv)],
                         evals_result=ev, device="cpu")
            print(f"{package} {mode} valid AUC {ev['valid_0']['auc'][-1]:.6f}"
                  f" ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
