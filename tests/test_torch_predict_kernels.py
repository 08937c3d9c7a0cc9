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


def _records(e, tree_tile=TREE_TILE):
    tables = pc.walk_tables(e["parr"])
    t_pad = -(-len(e["trees"]) // tree_tile) * tree_tile
    return pc.node_records(pad_tree_axis(tables, t_pad), tree_tile)


def _codes(e, layout):
    c = e["codes"]
    if layout == "u16":
        return c.astype(np.uint16)
    if layout == "i32":
        return c.astype(np.int32)
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
    kw.pop("tree_tile")                       # the port's is in the records
    got = pc.serving_fused(_records(e), torch.from_numpy(codes), **kw).numpy()
    assert pc.launch_counts == before       # the CPU computes, never counts
    assert got.shape == want.shape
    if mode == "leaf":
        np.testing.assert_array_equal(got, want)
        assert (got[:, len(e["trees"]):] == 0).all()   # pad trees: leaf 0
    else:
        atol = _raw_tol(e["trees"]) if transform is None else 1e-6
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("layout", ["u8", "u16", "i32"])
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


@pytest.mark.parametrize("tree_tile", [3, 4, 8])
@pytest.mark.parametrize("layout", ["u8", "packed"])
def test_fused_plain_is_the_group_order_loop(ens, layout, tree_tile):
    """K4's order of f32 adds, written out per (row, group, tree) in
    Python: a group's partial of class c adds its trees t with t % K == c
    in tree order from 0, and the groups' partials add in group order
    from 0.  The plain version equals it bit for bit; tree tiles that are
    no multiple of K start groups on every class."""
    e = ens
    K, trees = e["K"], e["trees"]
    nr = _records(e, tree_tile)
    got = pc.serving_fused(
        nr, torch.from_numpy(_codes(e, layout)), n_steps=e["depth"],
        zero_code=e["zc"], nan_code=e["nc"], K=K,
        packed=layout == "packed").numpy()
    X = chip_smoke.make_rows(np.random.RandomState(K), N)
    leaf = np.stack([t.predict_leaf_index(X) for t in trees], axis=1)
    f32 = np.float32
    t_pad = nr.records.shape[0]
    want = np.zeros((N, K), np.float32)
    for r in range(N):
        acc = [f32(0.0)] * K
        for g0 in range(0, t_pad, tree_tile):
            part = [f32(0.0)] * K
            for t in range(g0, g0 + tree_tile):
                v = (f32(trees[t].leaf_value[leaf[r, t]]) if t < len(trees)
                     else f32(0.0))              # a pad tree: leaf 0, 0.0
                part[t % K] = f32(part[t % K] + v)
            acc = [f32(a + p) for a, p in zip(acc, part)]
        want[r] = acc
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _random_tables(rng, T, L1, F):
    """Seven node tables spanning each record field's whole range."""
    L = L1 + 1
    i32 = np.iinfo(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    nl = rng.randint(0, L + 1, size=T)
    nl[:2] = [0, L]
    return pc.WalkTables(
        num_leaves=t(nl),
        split_feature=t(rng.randint(0, F, size=(T, L1))),
        threshold_bin=t(rng.randint(i32.min, i32.max, size=(T, L1))),
        zero_bin=t(rng.randint(i32.min, i32.max, size=(T, L1))),
        default_left=t(rng.randint(0, 2, size=(T, L1))),
        missing_type=t(rng.randint(0, 3, size=(T, L1))),
        left_child=t(rng.randint(-L, L1, size=(T, L1))),
        right_child=t(rng.randint(-L, L1, size=(T, L1))),
        leaf_value=torch.from_numpy(rng.randn(T, L).astype(np.float32)),
        max_feature=F - 1)


def _largest_l1(F=1):
    """The largest node count a tree may have for the plan to accept it."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        ok = pc.plan_predict_tiles(**dict(FULL, T=2, L1=mid, L=mid + 1,
                                          F=F))["eligible"]
        lo, hi = (mid, hi) if ok else (lo, mid - 1)
    return lo


@pytest.mark.parametrize("case", ["ensemble", "largest_l1"])
def test_node_records_round_trip(ens, case):
    """The 16-byte records give back the seven node tables exactly, the
    parked flag says num_leaves <= 1, and the leaf values are kept; at
    the largest L1 the plan accepts too, with every field at its
    extremes (children across the int16 halves, 32-bit bins)."""
    if case == "ensemble":
        tables = pad_tree_axis(pc.walk_tables(ens["parr"]), ens["t_pad"])
        tree_tile = TREE_TILE
    else:
        L1 = _largest_l1()
        assert L1 > 11000          # 16 L1 + 4 Lp + the codes <= 227 KB
        assert not pc.plan_predict_tiles(
            **dict(FULL, T=2, L1=L1 + 1, L=L1 + 2, F=1))["eligible"]
        tables = _random_tables(np.random.RandomState(L1), 4, L1, F)
        tree_tile = 2
    nr = pc.node_records(tables, tree_tile)
    T, L1 = tables.split_feature.shape
    L = tables.leaf_value.shape[1]
    assert nr.records.shape == (T, L1, 4) and nr.records.dtype == torch.int32
    assert nr.leaf_value.shape == (T, -(-L // 4) * 4)
    assert nr.max_feature == tables.max_feature
    back = pc.decode_records(nr)
    for name in ("split_feature", "threshold_bin", "zero_bin",
                 "default_left", "missing_type", "left_child",
                 "right_child"):
        assert torch.equal(getattr(back, name), getattr(tables, name)), name
    assert torch.equal(back.num_leaves > 1, tables.num_leaves > 1)
    assert torch.equal(back.leaf_value[:, :L], tables.leaf_value)
    assert (back.leaf_value[:, L:] == 0).all()


def test_group_size_does_not_follow_the_batch(ens):
    """The plan takes no batch size, so BatchPredictors with other
    buckets and chunks plan the same groups; and a row's scores have the
    same bits whichever batch it is scored in."""
    import inspect
    assert not {"N", "n", "rows", "n_rows"} & set(
        inspect.signature(pc.plan_predict_tiles).parameters)
    e = ens
    plans = [port_predict.BatchPredictor(
        e["trees"], e["K"], F, method="fused", device="cpu",
        bucket_min=b, chunk_rows=c).fused_plan
        for b, c in ((16, 64), (256, 1 << 17), (1024, 4096))]
    assert plans[0] == plans[1] == plans[2]
    nr = _records(e)
    kw = dict(n_steps=e["depth"], zero_code=e["zc"], nan_code=e["nc"],
              K=e["K"])
    codes = torch.from_numpy(e["codes"])
    whole = pc.serving_fused(nr, codes, **kw)
    for lo, hi in ((0, 1), (5, 37), (17, N)):
        part = pc.serving_fused(nr, codes[lo:hi].contiguous(), **kw)
        assert torch.equal(part.view(torch.int32),
                           whole[lo:hi].view(torch.int32))


@pytest.mark.parametrize("layout", ["u8", "packed"])
def test_codes_narrower_than_the_split_features_raise(ens, layout):
    """Both wrappers refuse codes without a column for the largest split
    feature (F columns, ceil(F/2) packed), on the CPU as on the card;
    the exact width is accepted."""
    e = ens
    packed = layout == "packed"
    tables = pc.walk_tables(e["parr"])
    mf = tables.max_feature
    assert 0 <= mf < F
    need = -(-(mf + 1) // 2) if packed else mf + 1
    codes = torch.from_numpy(_codes(e, layout))
    kw = dict(n_steps=e["depth"], zero_code=e["zc"], nan_code=e["nc"])
    narrow, exact = codes[:, :need - 1], codes[:, :need].contiguous()
    with pytest.raises(ValueError, match="too narrow"):
        pc.serving_fused(_records(e), narrow, K=e["K"], packed=packed, **kw)
    want = pc.serving_fused(_records(e), codes, K=e["K"], packed=packed,
                            **kw)
    assert torch.equal(pc.serving_fused(_records(e), exact, K=e["K"],
                                        packed=packed, **kw), want)
    if not packed:
        with pytest.raises(ValueError, match="too narrow"):
            pc.serving_leaf(tables, narrow, **kw)
        assert torch.equal(pc.serving_leaf(tables, exact, **kw),
                           pc.serving_leaf(tables, codes, **kw))


def test_launch_shape_fills_the_card(ens, monkeypatch):
    """One row tile a block for a server batch (4 tiles x 63 groups of
    the full-width model fill a 132-SM card); several tiles a block for
    a 131,072-row chunk, so each group's records are staged once a
    chunk of tiles; never more blocks than the grid's y axis holds."""
    monkeypatch.setattr(pc, "_sm_count", lambda index: 132)
    plan = pc.plan_predict_tiles(**FULL)
    T, tt = plan["t_pad"], plan["tree_tile"]
    nr = pc.NodeRecords(records=torch.zeros((T, 254, 4), dtype=torch.int32),
                        leaf_value=torch.zeros((T, 256)), tree_tile=tt,
                        max_feature=27)
    dev = torch.device("cuda", 0)
    assert pc.fused_smem_bytes(nr, 28) == plan["total_bytes"]
    assert [pc.launch_shape(n, nr, 28, dev) for n in (1, 256, 512, 1024)] \
        == [1, 1, 1, 1]
    m = pc.launch_shape(1 << 17, nr, 28, dev)
    n_tiles = (1 << 17) // pc.ROW_TILE
    blocks = -(-n_tiles // m) * (T // tt)
    assert m > 1
    assert 2 * 528 <= blocks <= (pc.LAUNCH_WAVES + 1) * 528
    assert -(-(1 << 30) // pc.ROW_TILE // pc.launch_shape(
        1 << 30, nr, 28, dev)) <= 65535


def test_smoke_load_count_matches_the_paths_walked(ens):
    """chip_smoke.walk_loads, which prices the kernels' bound, reaches the
    plain K5's leaves, and its step and load counts equal those of the
    root-to-leaf paths: 4 loads a node (feature, code, threshold or
    default-left, child), 5 where a NaN/zero code is missing there (its
    missing type), 6 where it is not (also the zero bin)."""
    e = ens
    tables = pc.walk_tables(e["parr"])
    codes = torch.from_numpy(e["codes"])
    kw = dict(n_steps=e["depth"], zero_code=e["zc"], nan_code=e["nc"])
    leaf, steps, loads = chip_smoke.walk_loads(tables, codes, chunk=24, **kw)
    assert torch.equal(leaf, pc.serving_leaf_ref(tables, codes, **kw))
    want_steps = want_loads = 0
    kinds = {4: 0, 5: 0, 6: 0}
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
                n = 4 + special + (special and not missing)
                want_steps += 1
                want_loads += n
                kinds[n] += 1
                node = up.get(node)
    assert (steps, loads) == (want_steps, want_loads)
    assert all(kinds.values())                  # every kind of step occurs


def test_wrappers_refuse_other_devices_and_bad_tiles(ens):
    e = ens
    tables = pc.walk_tables(e["parr"])
    meta = torch.empty((4, F), dtype=torch.uint8, device="meta")
    kw = dict(n_steps=e["depth"], zero_code=e["zc"], nan_code=e["nc"])
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        pc.serving_leaf(tables, meta, **kw)
    with pytest.raises(ValueError, match="expected cpu or cuda"):
        pc.serving_fused(_records(e), meta, K=e["K"], **kw)
    with pytest.raises(ValueError, match="multiple of the tree tile"):
        pc.node_records(tables, TREE_TILE)


# ---------------------------------------------------------------------------
# plan_predict_tiles: shared-memory pricing, eligibility, refusals
# ---------------------------------------------------------------------------

FULL = dict(T=500, L1=254, L=255, F=28, K=1, depth=23)


def test_plan_full_width_model():
    plan = pc.plan_predict_tiles(**FULL)
    assert plan["eligible"] and plan["reason"] == ""
    # a 16-byte record a node and the leaf values padded to 4 columns
    per_tree = 16 * 254 + 4 * 256
    assert per_tree == plan["per_tree_bytes"] == 5088
    codes = 2 * pc.ROW_TILE * 28                 # two u8 code buffers
    assert plan["codes_tile_bytes"] == codes
    # the most trees under the budget, cut to whole sets of WALKS trees
    most = (pc.SMEM_BUDGET - codes) // per_tree
    assert plan["tree_tile"] == most - most % pc.WALKS == 8
    assert plan["n_tree_tiles"] == 63 and plan["t_pad"] == 504
    assert plan["table_tile_bytes"] == 8 * per_tree
    assert plan["acc_bytes"] == 0                # partials: registers
    assert plan["total_bytes"] == 8 * per_tree + codes
    assert plan["total_bytes"] <= plan["smem_budget"] <= 227 * 1024
    # four blocks share an SM's 228 KB (1 KB of it reserved a block)
    assert 4 * (plan["total_bytes"] + 1024) <= 228 * 1024


def test_plan_prices_packed_codes_and_class_accumulator():
    packed = pc.plan_predict_tiles(**FULL, packed=True)
    assert packed["codes_tile_bytes"] == 2 * pc.ROW_TILE * 14
    wide = pc.plan_predict_tiles(**FULL, code_bytes=2)
    assert wide["codes_tile_bytes"] == 2 * pc.ROW_TILE * 28 * 2
    k3 = pc.plan_predict_tiles(**dict(FULL, K=3))
    # the class partials go to a (G, N, K) buffer, not shared memory; a
    # group holds whole classes when it cannot hold WALKS trees of each
    assert k3["acc_bytes"] == 0
    assert k3["tree_tile"] % 3 == 0
    assert k3["total_bytes"] <= k3["smem_budget"]


def _seven_table_plan_serves(T, L1, L, F, K, packed=False, code_bytes=1):
    """The seven-table design's refusal line, priced as its plan priced one
    tree: seven int32 node tables, the leaf values and num_leaves, 256
    rows of codes and, for K > 1, a (K, 256) f32 accumulator, under
    96 KiB."""
    Fc = -(-F // 2) if packed else F
    one = ((7 * L1 + L + 1) * 4 + 256 * Fc * (1 if packed else code_bytes)
           + (256 * K * 4 if K > 1 else 0))
    return one <= 96 * 1024


def test_plan_refuses_nothing_the_seven_table_plan_served():
    """Every shape the seven-table plan served is still eligible: over
    node counts, widths, code widths and class counts up to its
    refusal line and past it."""
    served = 0
    for L1 in (1, 2, 254, 1000, 2000, 3000, 3400, 3500, 4000, 6000):
        for F in (1, 28, 100, 200, 300, 360, 380):
            for cb, packed in ((1, False), (2, False), (4, False),
                               (1, True)):
                for K in (1, 3, 10):
                    kw = dict(T=500, L1=L1, L=L1 + 1, F=F, K=K)
                    if not _seven_table_plan_serves(**kw, packed=packed,
                                               code_bytes=cb):
                        continue
                    served += 1
                    plan = pc.plan_predict_tiles(
                        **kw, depth=20, packed=packed, code_bytes=cb)
                    assert plan["eligible"], (kw, cb, packed,
                                              plan["reason"])
                    assert plan["total_bytes"] <= pc.SMEM_LIMIT
    assert served > 200


@pytest.mark.parametrize("kw,reason", [
    (dict(prebin=False), "raw-feature walk"),
    (dict(has_cat=True), "categorical bitset"),
    (dict(L1=19999, L=20000), "shared-memory budget"),
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


# ---------------------------------------------------------------------------
# plan_leaf_walk: K5's groups and row tiles
# ---------------------------------------------------------------------------

# the headline serving model: 500 trees of 255 leaves (254 node slots)
LEAF_FULL = dict(T=500, L1=254, F=F, code_bytes=1)


def test_leaf_plan_full_width_model():
    """Eight trees a group (their seven tables, 56,896 B, fill the L1
    budget), so a last group of four; 256 rows a block, one thread a row;
    28 B rows keep their 7-word stride (odd)."""
    p = pc.plan_leaf_walk(**LEAF_FULL)
    assert p == dict(group=8, rows=256, threads=256, stride_bytes=28)
    assert 500 % p["group"] == 4
    assert 8 * 7 * 4 * 254 <= pc.LEAF_TABLE_BUDGET < 9 * 7 * 4 * 254


def test_leaf_plan_takes_no_batch_size():
    """The plan is decided from the model and the card: no row count."""
    import inspect
    assert set(inspect.signature(pc.plan_leaf_walk).parameters) == {
        "T", "L1", "F", "code_bytes", "smem_limit"}


@pytest.mark.parametrize("code_bytes", [1, 2, 4])
def test_leaf_plan_refuses_no_width_served_before(code_bytes):
    """Every row of up to 48 KB of codes (the old kernel's static window)
    plans, at any tree count and tree size: whole warps of rows where
    they fit the block budget, else fewer rows within the card's shared
    memory, and a row stride of an odd word count that holds the row."""
    for F_ in sorted({1, 2, 3, 27, 28, 29, 255, 1000, 4097,
                      48 * 1024 // code_bytes}):
        for T, L1 in ((1, 1), (3, 14), (7, 254), (500, 254),
                      (100_000, 30), (2, 1 << 15)):
            p = pc.plan_leaf_walk(T=T, L1=L1, F=F_, code_bytes=code_bytes)
            row_bytes = F_ * code_bytes
            assert p["stride_bytes"] >= row_bytes
            assert p["stride_bytes"] % 8 == 4          # odd word count
            assert 1 <= p["group"] <= min(T, pc.LEAF_GROUP_MAX)
            assert 1 <= p["rows"] <= pc.LEAF_ROWS
            assert p["rows"] % 32 == 0 or p["rows"] < 32
            assert p["rows"] <= p["threads"] < p["rows"] + 32
            assert p["threads"] <= pc.LEAF_ROWS
            assert p["threads"] % 32 == 0
            smem = p["rows"] * (p["stride_bytes"] + 4 * (p["group"] + 1))
            assert smem <= pc.SMEM_LIMIT
            assert smem <= pc.SMEM_BUDGET or p["rows"] <= 32
    wide = pc.plan_leaf_walk(T=500, L1=254, F=48 * 1024 // code_bytes,
                             code_bytes=code_bytes)
    assert wide["rows"] == 4
    assert wide["rows"] * wide["stride_bytes"] > 48 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        pc.plan_leaf_walk(T=500, L1=254, F=pc.SMEM_LIMIT // code_bytes,
                          code_bytes=code_bytes)


@pytest.mark.parametrize("T", [1, 4, 7, 13, 500])
def test_leaf_plan_groups_small_trees_by_their_bytes(T):
    """Smaller trees take larger groups (up to LEAF_GROUP_MAX, at most
    T): 15-leaf trees' tables are 392 B, so 32 fit the budget; a tree of
    4,096 leaves walks alone."""
    p = pc.plan_leaf_walk(T=T, L1=14, F=F, code_bytes=1)
    assert p["group"] == min(T, pc.LEAF_GROUP_MAX)
    big = pc.plan_leaf_walk(T=T, L1=4095, F=F, code_bytes=1)
    assert big["group"] == 1


def test_smoke_leaf_lane_efficiency_counts_warp_steps():
    """chip_smoke.leaf_lane_efficiency: thread steps over 32 x the warp
    steps of K5's mapping, each warp (32 neighbouring rows; the last one
    padded) running a tree until its deepest lane is done."""
    rng = np.random.RandomState(7)
    steps = torch.from_numpy(rng.randint(0, 12, (70, 5)).astype(np.int16))
    steps[:, 2] = 0                             # a tree of one leaf
    warp_steps = sum(int(steps[w: w + 32, t].max())
                     for w in range(0, 70, 32) for t in range(5))
    assert chip_smoke.leaf_lane_efficiency(steps) == \
        int(steps.sum()) / (32 * warp_steps)
