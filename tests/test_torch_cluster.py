"""The port's cluster bring-up (parallel/cluster.py), collectives
(parallel/collectives.py) and comm accounting (obs/metrics.py) on the
CPU: the machine list, rank discovery by ``local_listen_port`` with two
processes on one host, the backend rule, the analytic tables number for
number the JAX package's, and the CLI's ``task=train tree_learner=data
num_machines=2`` over two processes writing the Python API's model."""

import socket
import sys

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks, spawn

from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.obs import metrics as tmetrics
from lightgbmv1_tpu_torch.parallel import cluster, collectives
from lightgbmv1_tpu_torch.parallel.collectives import Group, backend_for
from lightgbmv1_tpu_torch.utils.log import LightGBMError


@pytest.mark.parametrize("spec,want", [
    ("127.0.0.1:12400,127.0.0.1:12401",
     ["127.0.0.1:12400", "127.0.0.1:12401"]),
    ("a:1\nb:2\n", ["a:1", "b:2"]),
    (" a:1 , , b:2 ", ["a:1", "b:2"]),
    ("10.0.0.1 12400\n10.0.0.2 12400", ["10.0.0.1:12400", "10.0.0.2:12400"]),
])
def test_parse_machine_list(spec, want):
    assert cluster.parse_machine_list(spec) == want


def test_parse_machine_list_matches_the_jax_packages_host_port_form():
    from lightgbmv1_tpu.parallel.cluster import parse_machine_list as j_parse

    spec = "h1:1,h2:2\nh3:3"
    assert cluster.parse_machine_list(spec) == j_parse(spec)


def test_machine_list_file(tmp_path):
    f = tmp_path / "mlist.txt"
    f.write_text("127.0.0.1 12400\n127.0.0.1 12401\n")
    cfg = Config.from_dict({"machine_list_filename": str(f)})
    assert cluster._machines_of(cfg) == ["127.0.0.1:12400",
                                         "127.0.0.1:12401"]


def test_rank_discovery_two_processes_on_one_host(tmp_path):
    """Two processes of one host, the same machine list, each its own
    local_listen_port: distinct ranks, the one its port names, and a
    group of two over gloo."""
    ports = [cluster.find_free_port(), cluster.find_free_port()]
    res = run_ranks({"mode": "discover", "ports": ports}, tmp_path,
                    world=2)
    assert [r["found"] for r in res] == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" for r in res)


def test_discover_rank_refuses_a_port_held_elsewhere():
    """The claim binds the port: a second process of the same rank (here,
    a socket holding it) fails instead of sharing the rank."""
    with socket.socket() as held:
        held.bind(("", 0))
        port = held.getsockname()[1]
        with pytest.raises(LightGBMError, match="is taken"):
            cluster.discover_rank([f"127.0.0.1:{port}", "127.0.0.1:1"],
                                  port)


def test_discover_rank_finds_its_port_and_keeps_it():
    port = cluster.find_free_port()
    rank, claim = cluster.discover_rank(
        ["10.255.0.1:5", f"127.0.0.1:{port}"], port)
    try:
        assert rank == 1
        with socket.socket() as other, pytest.raises(OSError):
            other.bind(("", port))
    finally:
        claim.close()


def test_discover_rank_without_a_local_entry():
    with pytest.raises(LightGBMError, match="Could not find the local"):
        cluster.discover_rank(["10.255.0.1:5", "10.255.0.2:6"], 5)


def test_init_cluster_num_machines_mismatch():
    cfg = Config.from_dict({"machines": "127.0.0.1:1,127.0.0.1:2",
                            "num_machines": 3})
    with pytest.raises(LightGBMError, match="num_machines=3"):
        cluster.init_cluster(cfg)


@pytest.mark.parametrize("world,cards,on_cuda,want", [
    (2, 0, False, "gloo"),     # the CPU
    (2, 1, True, "gloo"),      # two ranks sharing one card
    (2, 2, True, "nccl"),      # a card a rank
    (4, 4, True, "nccl"),
    (4, 2, True, "gloo"),
    (1, 1, True, "nccl"),
    (2, 8, False, "gloo"),     # cards present, training on the CPU
])
def test_backend_rule(world, cards, on_cuda, want):
    assert backend_for(world, cards, on_cuda) == want


def test_group_of_one_is_identity():
    g = Group.solo()
    t = torch.arange(12.0).reshape(4, 3)
    collectives.reset_counts()
    assert g.all_reduce(t) is t
    assert g.reduce_scatter(t, dim=0) is t
    assert g.all_gather(t).shape == (1, 4, 3)
    assert g.all_gather_object({"a": 1}) == [{"a": 1}]
    assert all(c["calls"] == 0 for c in collectives.counts.values())
    assert (g.rank, g.world) == (0, 1)
    assert collectives.current_group().world == 1


def test_make_mesh_is_the_group():
    g = Group.solo()
    assert cluster.make_mesh(0, g) is g
    assert cluster.make_mesh(1, g) is g
    with pytest.raises(ValueError, match="num_shards=2"):
        cluster.make_mesh(2, g)


_TABLE_CASES = [
    (learner, coll, k, F, B, ndev, sel_k, int8sr)
    for learner, coll in (("data", "reduce_scatter"), ("data", "allreduce"),
                          ("voting", "reduce_scatter"),
                          ("voting", "allreduce"), ("feature", "allreduce"))
    for k, F, B, ndev in ((63, 28, 64, 2), (7, 7, 256, 2), (1, 11, 32, 3),
                          (0.5, 5, 16, 4), (16, 28, 64, 1))
    for sel_k, int8sr in ((None, False), (4, True))]


@pytest.mark.parametrize("learner,coll,k,F,B,ndev,sel_k,int8sr",
                         _TABLE_CASES)
def test_comm_tables_equal_the_jax_packages(learner, coll, k, F, B, ndev,
                                            sel_k, int8sr):
    from lightgbmv1_tpu.parallel.cluster import \
        comm_table_per_round as j_table

    kw = dict(k=k, F=F, B=B, ndev=ndev, sel_k=sel_k, int8sr=int8sr)
    assert tmetrics.comm_table_per_round(learner, coll, **kw) == \
        j_table(learner, coll, **kw)


@pytest.mark.parametrize("B", [16, 32, 33, 64, 256, 511])
def test_split_pack_floats_and_collective_bytes(B):
    from lightgbmv1_tpu.parallel import cluster as jc

    assert tmetrics.split_pack_floats(B) == jc.split_pack_floats(B)
    for kind in ("psum", "psum_scatter", "all_gather"):
        for ndev in (1, 2, 8):
            assert tmetrics.collective_bytes(B * 12, ndev, kind) == \
                jc.collective_bytes(B * 12, ndev, kind)


def test_publish_comm_metrics():
    table = tmetrics.comm_table_per_round("voting", "reduce_scatter", k=7,
                                          F=7, B=64, ndev=2, sel_k=4)
    tmetrics.publish_comm_metrics("voting", table)
    snap = tmetrics.default_registry().snapshot()
    got = {k: v for k, v in snap.items()
           if k.startswith("comm_bytes_per_round") and "voting" in k}
    assert float(table["hist_bytes"]) in got.values()
    assert float(table["vote_bytes"]) in got.values()


def test_cli_train_data_parallel_equals_the_python_api(tmp_path):
    """``task=train tree_learner=data num_machines=2`` over two processes
    of the CLI (machines found by local_listen_port), rank 0 writing the
    model, against two ranks of the Python API loading the same file with
    ``load_distributed``: one model text."""
    rng = np.random.RandomState(5)
    X = rng.randn(1201, 6)
    y = (X[:, 0] - X[:, 2] + 0.5 * rng.randn(1201) > 0).astype(float)
    data = tmp_path / "train.tsv"
    np.savetxt(data, np.column_stack([y, X]), fmt="%.7g", delimiter="\t")
    params = {"objective": "binary", "tree_learner": "data",
              "num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1}
    p1 = cluster.find_free_port()
    model = tmp_path / "model.txt"

    def cli(rank, port):
        return [sys.executable, "-m", "lightgbmv1_tpu_torch", "task=train",
                f"data={data}", "num_iterations=4", "num_machines=2",
                f"machines=127.0.0.1:{port},127.0.0.1:{p1}",
                f"local_listen_port={[port, p1][rank]}",
                f"output_model={model}", "device_type=cpu"] + \
            [f"{k}={v}" for k, v in params.items()]

    outs = spawn(cli, 2)
    assert all(rc == 0 for rc, _ in outs), "\n".join(o[-3000:]
                                                     for _, o in outs)
    res = run_ranks({"mode": "api_file", "path": str(data),
                     "params": params, "iters": 4}, tmp_path, world=2)
    assert res[0]["text"] == res[1]["text"]
    assert model.read_text() == res[0]["text"]
