"""Gloo ranks of the port on the CPU, as subprocesses: the tests' helper.

``run_ranks(job, tmp_path, world=2)`` writes ``job`` (a dict) as JSON,
starts ``world`` processes of ``tests/torch_rank_worker.py`` on a free
port (each ``python torch_rank_worker.py <rank> <world> <port> <job>
<outdir>``), waits for them all and returns each rank's result (the JSON
it wrote).  A failed rank fails the caller with every rank's output; a
port taken between the pick and the bind is retried on a fresh one.  To
run two ranks by hand::

    python tests/torch_rank_worker.py 0 2 29500 job.json out &
    python tests/torch_rank_worker.py 1 2 29500 job.json out
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from lightgbmv1_tpu_torch.parallel.cluster import find_free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_rank_worker.py")
_BIND_RACE = ("address already in use", "errno 98", "eaddrinuse")


def rank_env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def spawn(argv_of_rank, world: int, timeout: float = 240.0,
          attempts: int = 3):
    """Run ``argv_of_rank(rank, port)`` (an argv list) for every rank at
    once; ``[(returncode, output)]`` by rank."""
    for attempt in range(attempts):
        port = find_free_port()
        procs = [subprocess.Popen(argv_of_rank(r, port), cwd=REPO,
                                  env=rank_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, _ = p.communicate()
                out = (out or "") + "\n[timed out]"
            outs.append((p.returncode, out or ""))
        race = any(rc != 0 and any(s in out.lower() for s in _BIND_RACE)
                   for rc, out in outs)
        if not race or attempt + 1 == attempts:
            return outs
    return outs


def run_ranks(job: dict, tmp_path, world: int = 2, timeout: float = 240.0):
    """``job`` run by ``world`` ranks; each rank's result dict."""
    tmp = str(tmp_path)
    path = os.path.join(tmp, f"job_{job['mode']}_{world}.json")
    with open(path, "w") as fh:
        json.dump(job, fh)
    outs = spawn(lambda r, port: [sys.executable, WORKER, str(r),
                                  str(world), str(port), path, tmp],
                 world, timeout)
    if any(rc != 0 for rc, _ in outs):
        raise AssertionError("a rank failed:\n" + "\n".join(
            f"--- rank {r} (exit {rc}) ---\n{out[-4000:]}"
            for r, (rc, out) in enumerate(outs)))
    res = []
    for r in range(world):
        with open(os.path.join(tmp, f"result_{job['mode']}_{r}.json")) as fh:
            res.append(json.load(fh))
    return res
