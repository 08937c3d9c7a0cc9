"""The CUDA kernels' plain versions against the Pallas kernels they replace.

On the CPU the port's wrappers (ops/predict_cuda.serving_fused / K4 and
serving_leaf / K5) compute their plain PyTorch versions; here those are
held to ``serving_fused_pallas`` / ``serving_leaf_pallas`` run in Pallas
interpret mode on the same numpy tables and codes.  The CUDA kernels
themselves are held to the plain versions on the card by chip_smoke.py.

Tolerances: leaf ids exact; raw f32 scores within
``1e-6 * sum_t max_l |leaf_value[t, l]| + 1e-7`` (the two packages sum in
different orders); sigmoid/softmax outputs within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbmv1_tpu.io.model_text import model_from_string as jax_load
from lightgbmv1_tpu.models import predict as jax_predict
from lightgbmv1_tpu.models.tree import pad_tree_axis as jax_pad
from lightgbmv1_tpu.ops import predict_pallas

import chip_smoke
from lightgbmv1_tpu_torch.models import predict as port_predict
from lightgbmv1_tpu_torch.models.tree import pad_tree_axis
from lightgbmv1_tpu_torch.ops import predict_cuda as pc

F = chip_smoke.F
N = 64
TREE_TILE = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw_tol(trees):
    return 1e-6 * sum(float(np.abs(t.leaf_value).max()) for t in trees) + 1e-7


@pytest.fixture(scope="module", params=[1, 3], ids=["K1", "K3"])
def ens(request):
    """A small synthetic ensemble (<= 13 thresholds a feature, so its codes
    pack) as port tables and JAX tables, plus seeded rows' codes."""
    K = request.param
    text, trees = chip_smoke.make_model(10 + K, n_trees=7 if K == 1 else 9,
                                        n_leaves=15, n_grid=6, num_class=K)
    binner = port_predict.build_serving_binner(trees, F)
    assert binner.ok and binner.packed_ok
    parr, depth = port_predict.build_serving_arrays(trees, binner, F, "cpu")
    jtrees = jax_load(text).trees
    jarr, jdepth = jax_predict.build_serving_arrays(
        jtrees, jax_predict.build_serving_binner(jtrees, F), F)
    assert depth == jdepth
    T = len(trees)
    t_pad = -(-T // TREE_TILE) * TREE_TILE
    assert t_pad > T                         # the tiling pads in both cases
    codes = binner.prebin(chip_smoke.make_rows(np.random.RandomState(K), N))
    return dict(K=K, trees=trees, parr=parr, jarr=jarr, depth=depth,
                t_pad=t_pad, codes=codes, zc=binner.zero_code,
                nc=binner.nan_code)


def _codes(e, layout):
    c = e["codes"]
    if layout == "u16":
        return c.astype(np.uint16)
    if layout == "packed":
        return port_predict.pack_serving_codes(c)
    return c


@pytest.mark.parametrize("layout", ["u8", "u16", "packed"])
@pytest.mark.parametrize("mode", ["raw", "transform", "leaf"])
def test_fused_plain_matches_pallas(ens, layout, mode):
    e = ens
    K = e["K"]
    codes = _codes(e, layout)
    transform = None if mode != "transform" else (
        "sigmoid" if K == 1 else "softmax")
    kw = dict(n_steps=e["depth"], zero_code=e["zc"], nan_code=e["nc"], K=K,
              tree_tile=TREE_TILE, mode="leaf" if mode == "leaf" else
              "scores", packed=layout == "packed", transform=transform)
    want = np.asarray(predict_pallas.serving_fused_pallas(
        jax_pad(e["jarr"], e["t_pad"]), jnp.asarray(codes), interpret=True,
        **kw))
    before = dict(pc.launch_counts)
    got = pc.serving_fused(
        pad_tree_axis(pc.walk_tables(e["parr"]), e["t_pad"]),
        torch.from_numpy(codes), **kw).numpy()
    assert pc.launch_counts == before       # the CPU computes, never counts
    assert got.shape == want.shape
    if mode == "leaf":
        np.testing.assert_array_equal(got, want)
        assert (got[:, len(e["trees"]):] == 0).all()   # pad trees: leaf 0
    else:
        atol = _raw_tol(e["trees"]) if transform is None else 1e-6
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("layout", ["u8", "u16"])
def test_leaf_plain_matches_pallas(ens, layout):
    e = ens
    codes = _codes(e, layout)
    kw = dict(n_steps=e["depth"], zero_code=e["zc"], nan_code=e["nc"])
    want = np.asarray(predict_pallas.serving_leaf_pallas(
        e["jarr"], jnp.asarray(codes), interpret=True, **kw))
    got = pc.serving_leaf(pc.walk_tables(e["parr"]), torch.from_numpy(codes),
                          **kw).numpy()
    np.testing.assert_array_equal(got, want)
    # the host oracle agrees with both on the nodes reached
    X = chip_smoke.make_rows(np.random.RandomState(e["K"]), N)
    host = np.stack([t.predict_leaf_index(X) for t in e["trees"]], axis=1)
    np.testing.assert_array_equal(got, host)


def test_smoke_load_count_matches_the_paths_walked(ens):
    """chip_smoke.walk_loads, which prices the kernels' bound, reaches the
    plain K5's leaves, and its step and load counts equal those of the
    root-to-leaf paths: 5 loads a node, 6 where a NaN/zero code is not
    missing there (the zero-bin load)."""
    e = ens
    tables = pc.walk_tables(e["parr"])
    codes = torch.from_numpy(e["codes"])
    kw = dict(n_steps=e["depth"], zero_code=e["zc"], nan_code=e["nc"])
    leaf, steps, loads = chip_smoke.walk_loads(tables, codes, chunk=24, **kw)
    assert torch.equal(leaf, pc.serving_leaf_ref(tables, codes, **kw))
    want_steps = want_loads = 0
    for ti, t in enumerate(e["trees"]):
        up = {}                                 # child code -> parent node
        for i in range(t.num_leaves - 1):
            up[int(t.left_child[i])] = up[int(t.right_child[i])] = i
        for r in range(N):
            node = up.get(~int(leaf[r, ti]))    # None: a one-leaf tree
            while node is not None:
                b = int(e["codes"][r, t.split_feature[node]])
                is_nan, special = b == e["nc"], b in (e["nc"], e["zc"])
                missing = (is_nan if t.missing_type[node] == 2 else
                           t.missing_type[node] == 1 and special)
                want_steps += 1
                want_loads += 6 if special and not missing else 5
                node = up.get(node)
    assert (steps, loads) == (want_steps, want_loads)
    assert 5 * steps < loads                    # the zero-bin case occurs


def test_wrappers_refuse_other_devices_and_bad_tiles(ens):
    e = ens
    tables = pc.walk_tables(e["parr"])
    meta = torch.empty((4, F), dtype=torch.uint8, device="meta")
    kw = dict(n_steps=e["depth"], zero_code=e["zc"], nan_code=e["nc"])
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        pc.serving_leaf(tables, meta, **kw)
    padded = pad_tree_axis(tables, e["t_pad"])
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        pc.serving_fused(padded, meta, K=e["K"], tree_tile=TREE_TILE, **kw)
    with pytest.raises(ValueError, match="multiple of the tree tile"):
        pc.serving_fused(tables, torch.from_numpy(e["codes"]), K=e["K"],
                         tree_tile=TREE_TILE, **kw)


# ---------------------------------------------------------------------------
# plan_predict_tiles: shared-memory pricing, eligibility, refusals
# ---------------------------------------------------------------------------

FULL = dict(T=500, L1=254, L=255, F=28, K=1, depth=23)


def test_plan_full_width_model():
    plan = pc.plan_predict_tiles(**FULL)
    assert plan["eligible"] and plan["reason"] == ""
    per_tree = (7 * 254 + 255 + 1) * 4
    assert per_tree == 8136
    assert plan["tree_tile"] == 8 and plan["t_pad"] == 504
    assert plan["n_tree_tiles"] == 63
    assert plan["table_tile_bytes"] == 8 * per_tree
    assert plan["codes_tile_bytes"] == pc.ROW_TILE * 28
    assert plan["acc_bytes"] == 0                    # K = 1: a register
    assert plan["total_bytes"] <= plan["smem_budget"] <= 227 * 1024


def test_plan_prices_packed_codes_and_class_accumulator():
    packed = pc.plan_predict_tiles(**FULL, packed=True)
    assert packed["codes_tile_bytes"] == pc.ROW_TILE * 14
    wide = pc.plan_predict_tiles(**FULL, code_bytes=2)
    assert wide["codes_tile_bytes"] == pc.ROW_TILE * 28 * 2
    k3 = pc.plan_predict_tiles(**dict(FULL, K=3))
    assert k3["acc_bytes"] == pc.ROW_TILE * 3 * 4
    assert k3["total_bytes"] <= k3["smem_budget"]


@pytest.mark.parametrize("kw,reason", [
    (dict(prebin=False), "raw-feature walk"),
    (dict(has_cat=True), "categorical bitset"),
    (dict(L1=9999, L=10000), "shared-memory budget"),
])
def test_plan_refusal_reasons(kw, reason):
    plan = pc.plan_predict_tiles(**{**FULL, **kw})
    assert not plan["eligible"]
    assert reason in plan["reason"]
    if "shared-memory" in reason:
        assert plan["tree_tile"] == 1
    else:   # the same reason line as the JAX package's planner
        jplan = predict_pallas.plan_predict_tiles(**{**FULL, **kw})
        assert plan["reason"] == jplan["reason"]
