"""One gloo rank of the port on the CPU (tests/torch_ranks.py starts them).

``python torch_rank_worker.py <rank> <world> <port> <job.json> <outdir>``
joins the group at ``127.0.0.1:<port>`` (``cluster.init_cluster``; the
``discover`` job through its machine list instead) and runs the job's
``mode``, writing ``<outdir>/result_<mode>_<rank>.json``:

* ``train``: each of ``runs`` (``{"name", "data", "params", "iters"}``)
  trains on the rows of its ``data`` (an .npz of X, y and optionally w),
  every rank given the whole set (the trainer takes its rows), and
  records the model text (a file), the gathered raw training scores
  (rank 0, a .npy), the collectives' counts and each call's payload;
* ``bins``: ``find_bins_distributed`` on this rank's half of ``data``'s
  sample, the mappers' bounds;
* ``load``: ``load_distributed`` of each of ``loads`` (``{"name",
  "path", "params"}``; ``{rank}`` in a path is the rank; a block cache
  directory too), the local rows' labels, weights and bins;
* ``discover``: the rank ``init_cluster`` finds from ``machines`` and
  this rank's ``local_listen_port`` (``ports[rank]``);
* ``api_file``: ``load_distributed`` + ``Dataset.from_binned`` +
  ``train``, the model text.
"""

import json
import os
import sys

import numpy as np

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
with open(sys.argv[4]) as fh:
    job = json.load(fh)
out = sys.argv[5]

import torch  # noqa: E402

torch.set_num_threads(1)

from lightgbmv1_tpu_torch.config import Config  # noqa: E402
from lightgbmv1_tpu_torch.parallel import cluster, collectives  # noqa: E402

result = {"rank": rank}
mode = job["mode"]
if mode == "discover":
    ports = job["ports"]
    cfg = Config.from_dict({
        "machines": ",".join(f"127.0.0.1:{p}" for p in ports),
        "num_machines": world, "local_listen_port": ports[rank],
        "verbosity": -1})
    group = cluster.init_cluster(cfg)
    result.update(found=group.rank, world=group.world,
                  backend=group.backend)
else:
    group = cluster.init_cluster(
        coordinator_address=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank, device="cpu")
    result.update(world=group.world, backend=group.backend)

if mode == "train":
    from lightgbmv1_tpu_torch import Dataset, train

    runs = {}
    for run in job["runs"]:
        d = np.load(run["data"])
        w = d["w"] if "w" in d.files else None
        collectives.reset_counts()
        collectives.call_log = []
        ds = Dataset(d["X"], label=d["y"], weight=w)
        bst = train(run["params"], ds, run["iters"], device="cpu")
        path = os.path.join(out, f"{run['name']}.rank{rank}.txt")
        with open(path, "w") as fh:
            fh.write(bst.model_to_string())
        scores = bst._gbdt.raw_train_scores()
        if rank == 0:
            np.save(os.path.join(out, f"{run['name']}.scores.npy"), scores)
        runs[run["name"]] = {
            "text": path,
            "counts": {k: dict(v) for k, v in collectives.counts.items()},
            "part_bytes": dict(collectives.part_bytes),
            "calls": [list(c[:2]) + [list(c[2]), c[3]]
                      for c in collectives.call_log]}
        collectives.call_log = None
    result["runs"] = runs
elif mode == "bins":
    from lightgbmv1_tpu_torch.parallel.dist_data import find_bins_distributed

    d = np.load(job["data"])
    S = d["S"]                                  # (F, n) joined sample
    half = np.array_split(np.arange(S.shape[1]), world)[rank]
    cfg = Config.from_dict(job["params"])
    mappers = find_bins_distributed(
        [S[j, half] for j in range(S.shape[0])], len(half),
        [cfg.max_bin] * S.shape[0], set(), cfg, num_data=len(half))
    result["bounds"] = [np.asarray(m.bin_upper_bound).tolist()
                        for m in mappers]
    result["num_bin"] = [int(m.num_bin) for m in mappers]
elif mode == "load":
    from lightgbmv1_tpu_torch.parallel.dist_data import load_distributed

    result["loads"] = {}
    for ld in job["loads"]:
        path = ld["path"].replace("{rank}", str(rank))
        ds = load_distributed(path, Config.from_dict(ld["params"]))
        meta = ds.metadata
        result["loads"][ld["name"]] = dict(
            num_data=int(ds.num_data),
            local_rows=int(getattr(ds, "local_rows", ds.num_data)),
            row_valid=(np.asarray(ds.row_valid).tolist()
                       if getattr(ds, "row_valid", None) is not None
                       else None),
            label=np.asarray(meta.label).tolist(),
            weight=(None if meta.weight is None
                    else np.asarray(meta.weight).tolist()),
            binned=np.asarray(ds.binned).tolist(),
            bounds=[np.asarray(m.bin_upper_bound).tolist()
                    for m in ds.bin_mappers])
elif mode == "api_file":
    from lightgbmv1_tpu_torch import Dataset, train
    from lightgbmv1_tpu_torch.parallel.dist_data import load_distributed

    cfg = Config.from_dict(job["params"])
    ds = Dataset.from_binned(load_distributed(job["path"], cfg),
                             params=job["params"])
    bst = train(job["params"], ds, job["iters"], device="cpu")
    result["text"] = bst.model_to_string()

group.barrier()
with open(os.path.join(out, f"result_{mode}_{rank}.json"), "w") as fh:
    json.dump(result, fh)
cluster.shutdown()
