"""The A, B, B, A driver of the ``*_ab.py`` scripts: two checkouts of the
port timed on one NVIDIA card, each run in a process of its own.

A script gives ``main`` its ``child(root, args)`` (one checkout's checks
and times, a JSON-able dict; it puts ``root`` first on the path itself),
its options (``add_args``) and ``summarize(res, pair)``, which reads the
four children's dicts (A, B, B, A) and returns the summary's keys and
whether the checks passed; ``pair(get)`` sets a value of each checkout's
two runs side by side.  ``main`` re-runs the script with ``--child ROOT``
and the same options for each of A, B, B, A, prints each child's JSON
line, then the summary (with both roots and the card's name and power
limit) as the last line.  It exits 1 if the checks failed, 2 without a
card, and a child's own code if a child failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main(script, doc, what, child, summarize, add_args=None,
         argv=None) -> int:
    name = os.path.splitext(os.path.basename(script))[0]
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--child", default=None)
    if add_args is not None:
        add_args(ap)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print(f"{name}: torch.cuda.is_available() is False — this times "
              f"{what} on a CUDA card", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(child(args.child, args)), flush=True)
        return 0
    if len(args.roots) != 2:
        ap.error("expected two checkout roots, A and B")
    a, b = args.roots
    opts = list(argv)
    for root in (a, b):
        opts.remove(root)
    res = []
    for root in (a, b, b, a):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), "--child", root]
            + opts, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"{name}: {root} exited {proc.returncode}",
                  file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        res.append(json.loads(line))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)

    def pair(get):
        return {"A": [get(res[0]), get(res[3])],
                "B": [get(res[1]), get(res[2])]}

    keys, ok = summarize(res, pair)
    summary = {"A": a, "B": b, "ok": ok, "card": card.stdout.strip()}
    summary.update(keys)
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1
