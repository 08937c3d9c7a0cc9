#!/usr/bin/env python3
"""Held-out metric of each objective the breadth slice ports, trained by
the JAX package (and, to compare, by the port) on the CPU: the figures
chip_smoke.py phase 43 prints beside the card's (``JAX_OBJECTIVE_METRIC``).

    JAX_PLATFORMS=cpu python3 objective_levels.py [--rows 1048576]
        [--iters 15] [--package jax|port|both] [--objectives l1,...]

The data is phase 43's: chip_smoke.py's copy of bench.py:42 make_data
(``--rows`` training rows, 131,072 valid rows) with the labels of
``chip_smoke.objective_label`` (phase 22's regression target, the exp of
its half, its sigmoid) under ``chip_smoke.OBJ_PARAMS`` (the headline
knobs, each objective's default metric), and phase 25's rank data
(bench.py:68) under ``chip_smoke.RANK_PARAMS`` for rank_xendcg.  Each
package trains with its CPU default histogram method.  Prints one line
an objective and package: the valid metric after ``--iters`` iterations
and the seconds (about 20 minutes a package at the defaults).
"""

import argparse
import time

import chip_smoke as cs


def _train(package, params, X, y, Xv, yv, iters, group=None, vgroup=None):
    ev = {}
    if package == "jax":
        import lightgbmv1_tpu as lj
        lj.train(params, lj.Dataset(X, label=y, group=group), iters,
                 valid_sets=[lj.Dataset(Xv, label=yv, group=vgroup)],
                 evals_result=ev, verbose_eval=False)
    else:
        cs.train(params, cs.Dataset(X, label=y, group=group), iters,
                 valid_sets=[cs.Dataset(Xv, label=yv, group=vgroup)],
                 evals_result=ev, device="cpu")
    (metric, values), = ev["valid_0"].items()
    return metric, values[-1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=cs.OBJ_ITERS)
    ap.add_argument("--package", default="jax",
                    choices=("jax", "port", "both"))
    ap.add_argument("--objectives", default=",".join(cs.BREADTH_OBJECTIVES))
    args = ap.parse_args()
    X, _ = cs.make_data(args.rows, 0)
    Xv, _ = cs.make_data(cs.VALID_ROWS, 1)
    target = cs.regression_target(X, 2)
    vtarget = cs.regression_target(Xv, 3)
    packages = ("jax", "port") if args.package == "both" else (args.package,)
    for objective in args.objectives.split(","):
        for package in packages:
            t0 = time.perf_counter()
            if objective == "rank_xendcg":
                Xr, yr, gr = cs.make_rank_data(2000, 100, 20)
                Xrv, yrv, grv = cs.make_rank_data(400, 100, 21)
                metric, value = _train(
                    package, dict(cs.RANK_PARAMS, objective=objective), Xr,
                    yr, Xrv, yrv, args.iters, gr, grv)
            else:
                metric, value = _train(
                    package, dict(cs.OBJ_PARAMS, objective=objective), X,
                    cs.objective_label(objective, target), Xv,
                    cs.objective_label(objective, vtarget), args.iters)
            print(f"{package} {objective} valid {metric} {value!r} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
