"""Plain int8 histograms (``hist_dtype=int8`` / ``hist_dtype_deep=int8``)
of the port against the JAX package, on the CPU.

The JAX package's ``hist_pallas._kernel`` at ``precision="int8"`` rounds
each row tile's gradients to nearest under one scale a channel (``amax /
127``, the count under 1/64), sums the tile's integers exactly and adds
``float(sum) * scale`` into its f32 output tile after tile; on the CPU
XLA compiles the division by 127 as a product with fl(1/127) and the
product and add as one fma.  The port's quantize leg
(``ops/quantize.rn_quantize``) and the int8 leg of K1's plain version in
the Pallas kernel's order (``hist_cuda.hist_leaves_ref``) give those bits;
the row-order version (the kernel's order: the plan's row chunks, added in
chunk order) gives them where the plan has one chunk and else differs by
the association of the chunks' sums.  K2's and K6's plain versions, and
whole trainings on the wave grower, are held to the JAX package's fused
round, loop and training (Pallas in interpret mode).

Tolerances, each with its reason:

* the rounded rows, the scales, the Pallas-order histograms, K2's hsmall
  and leaf ids: bit for bit (the same formula, the same order);
* the row-order histograms past one chunk: 2 (tiles + chunks) 2^-24
  (1 + 1/254) of the cell's absolute row sum (one rounding a tile and a
  chunk on each side);
* trainings: every split identical, leaf values within 2e-5 (the port's
  training tolerance: the two split scans sum in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.models import grower_wave as jgw
from lightgbmv1_tpu.ops import hist_pallas as jhp
from lightgbmv1_tpu.ops import split as jsplit
from lightgbmv1_tpu.ops import wave_fused as jwf

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.ops import hist_cuda, loop_cuda
from lightgbmv1_tpu_torch.ops import quantize as tq
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops import wave_fused as twf
from lightgbmv1_tpu_torch.ops.split import (FeatureMeta, SplitParams,
                                            with_tables)
from lightgbmv1_tpu_torch.parallel.trainer import build_trainer

from test_torch_fused import _round
from test_torch_wave_loop import _check_against_jax, _jax_loop, _segment

PARAMS = dict(min_data_in_leaf=5.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def low_buckets():
    """Both growers bucket their slots from 1 row, so the 4-slot ramp,
    the 16-slot ramp and the sustained rounds run at these sizes."""
    saved = jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N
    jgw._BUCKET_MIN_N = tgw._BUCKET_MIN_N = 1
    yield
    jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N = saved


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _rows(n, seed, zero_tile=None):
    """Signed gradients, positive hessians and a count, with about a fifth
    of the rows out of the bag (all three channels 0) and, with
    ``zero_tile`` (start, stop), a run of all-zero rows (amax 0)."""
    rng = np.random.RandomState(seed)
    g3 = np.stack([rng.randn(n) * 1.7, rng.rand(n) * 0.3, np.ones(n)],
                  axis=1).astype(np.float32)
    g3 *= (rng.rand(n) < 0.8).astype(np.float32)[:, None]
    if zero_tile is not None:
        g3[zero_tile[0]:zero_tile[1]] = 0.0
    return g3


@jax.jit
def _jax_tile(g):
    """The Pallas kernel's quantization of one (3, T) tile, its own
    lines (hist_pallas.py:144-154) compiled by XLA: (q3, scale3)."""
    amax = jnp.max(jnp.abs(g[:2]), axis=1, keepdims=True)
    inv = jnp.where(amax > 0, 127.0 / amax, 0.0)
    scale = jnp.where(amax > 0, amax / 127.0, 0.0)
    inv3 = jnp.concatenate([inv, jnp.full((1, 1), 64.0, jnp.float32)])
    scale3 = jnp.concatenate(
        [scale, jnp.full((1, 1), 1.0 / 64.0, jnp.float32)])
    return jnp.round(g * inv3), scale3[:, 0]


# ---------------------------------------------------------------------------
# the quantize leg
# ---------------------------------------------------------------------------


# the row counts N of a quantize case, from its tile T
QUANT_ROWS = {"3T+77": lambda T: 3 * T + 77, "1": lambda T: 1,
              "3": lambda T: 3, "T-1": lambda T: T - 1,
              "T+1": lambda T: T + 1, "4T+3": lambda T: 4 * T + 3}


@pytest.mark.parametrize("n", list(QUANT_ROWS))
@pytest.mark.parametrize("T", [128, 256, 512, 1024])
def test_quantize_matches_jax(T, n):
    """The rounded rows and the per-tile scales equal the Pallas kernel's
    own lines bit for bit, tile by tile, with N not a multiple of T, an
    all-zero tile (scale 0, rows 0) where N reaches past 2T, and
    out-of-bag zero rows; the tails N = 1, 3, T - 1, T + 1 and 4T + 3 are
    those the CUDA kernel's 16-byte loads and stores mask."""
    N = QUANT_ROWS[n](T)
    nt = -(-N // T)
    g3 = _rows(N, T, zero_tile=(T, 2 * T) if N >= 2 * T else None)
    q, scale = tq.rn_quantize(torch.from_numpy(g3), T)
    assert q.shape == (N, 3) and scale.shape == (nt, 3)
    pad = np.zeros((nt * T, 3), np.float32)
    pad[:N] = g3
    for t in range(nt):
        jq, js = _jax_tile(jnp.asarray(pad[t * T:(t + 1) * T].T))
        rows = slice(t * T, min(N, (t + 1) * T))
        np.testing.assert_array_equal(
            _bits(q.numpy()[rows]), _bits(np.asarray(jq).T[:rows.stop
                                                          - rows.start]))
        np.testing.assert_array_equal(_bits(scale.numpy()[t]), _bits(js))
    if N >= 2 * T:
        assert not scale[1, :2].any() and not q[T:2 * T].any()
    if N > 3:
        assert float(q[:, :2].abs().max()) == 127.0
    nr = tq.NearestRows(torch.from_numpy(g3))
    assert nr(T) is nr(T) and torch.equal(nr(T)[0], q)


@pytest.mark.parametrize("T", [128, 256, 512, 1024])
@pytest.mark.parametrize("L", [1, 3])
def test_k1_int8_pallas_order_matches_pallas(L, T):
    """K1's int8 plain version in the Pallas kernel's order equals
    ``hist_leaves_pallas(precision="int8")`` bit for bit at every scale
    tile (N not a multiple of T, an all-zero tile, bagged rows, a row of
    no slot)."""
    rng = np.random.RandomState(7 + L)
    F, B, N = 4, 16, 2 * T + 300
    binned = rng.randint(0, B, (F, N)).astype(np.uint8)
    lid = rng.randint(0, L + 1, N).astype(np.int32)      # slot L: no slot
    g3 = _rows(N, T + L, zero_tile=(T, T + T // 2))
    jh = np.asarray(jhp.hist_leaves_pallas(
        jnp.asarray(binned), jnp.asarray(g3), jnp.asarray(lid), L, B,
        precision="int8", row_tile=T, interpret=True))
    th = hist_cuda.hist_leaves(torch.from_numpy(binned), torch.from_numpy(g3),
                               torch.from_numpy(lid), L, B, "int8",
                               row_tile=T)
    np.testing.assert_array_equal(_bits(th.numpy()), _bits(jh))


@pytest.mark.parametrize("N", [900, 5000], ids=["one chunk", "chunks"])
@pytest.mark.parametrize("packed", [False, True], ids=["u8", "packed"])
def test_k1_int8_row_order(packed, N):
    """K1's row-order int8 version (the kernel's order) against the Pallas
    kernel at its own scale tile: counts exact; values bit for bit where
    the plan has one chunk, else within the order bound; the packed leg's
    plain versions the u8 leg's (F even: one scale tile)."""
    rng = np.random.RandomState(N)
    F, B, L = 6, 16, 5
    binned = rng.randint(0, B, (F, N)).astype(np.uint8)
    lid = rng.randint(0, L, N).astype(np.int32)
    g3 = _rows(N, 3)
    T = hist_cuda.hist_row_tile(L, F, B, packed)
    assert T == jhp._row_tile_for(24, (F + F % 2 if packed else F) * B, B)
    jb = jhp.pack4bit(jnp.asarray(binned)) if packed else jnp.asarray(binned)
    jh = np.asarray(jhp.hist_leaves_pallas(
        jb, jnp.asarray(g3), jnp.asarray(lid), L, B, precision="int8",
        interpret=True, packed=packed, num_features=F))
    tb = torch.from_numpy(binned)
    tb = hist_cuda.pack4bit(tb) if packed else tb
    kw = dict(packed=packed, num_features=F)
    args = (tb, torch.from_numpy(g3), torch.from_numpy(lid), L, B, "int8")
    row = hist_cuda.hist_leaves_roworder_ref(*args, **kw).numpy()
    n_chunks = hist_cuda.plan(N, F, L, B, "int8", T)["n_chunks"]
    assert (n_chunks == 1) == (N == 900)
    np.testing.assert_array_equal(row[..., 2], jh[..., 2])
    if n_chunks == 1:
        np.testing.assert_array_equal(_bits(row), _bits(jh))
    else:
        absum = np.zeros((L, F, B, 3))
        for f in range(F):
            np.add.at(absum, (lid, f, binned[f]), np.abs(g3))
        steps = 2 * (-(-N // T) + n_chunks)
        bound = steps * 2.0 ** -24 * (1 + 1 / 254) * absum + 1e-30
        assert (np.abs(row - jh) <= bound).all()
        assert not np.array_equal(row, jh)     # the orders do differ here
    u8 = hist_cuda.hist_leaves_roworder_ref(
        torch.from_numpy(binned), torch.from_numpy(g3),
        torch.from_numpy(lid), L, B, "int8", row_tile=T).numpy()
    np.testing.assert_array_equal(_bits(row), _bits(u8))


def test_k1_int8_dead_slot_and_plan():
    """The dead slot's rows add nothing (its cells 0, the live cells
    unchanged), the plan keeps every scale tile in one chunk, and a
    plan without its scale tile is refused."""
    rng = np.random.RandomState(5)
    F, B, L, N = 3, 16, 4, 3000
    binned = torch.from_numpy(rng.randint(0, B, (F, N)).astype(np.uint8))
    lid = torch.from_numpy(rng.randint(0, L, N).astype(np.int32))
    g3 = torch.from_numpy(_rows(N, 9))
    full = hist_cuda.hist_leaves_roworder_ref(binned, g3, lid, L, B, "int8")
    dead = hist_cuda.hist_leaves_roworder_ref(binned, g3, lid, L, B, "int8",
                                              L - 1)
    assert torch.equal(dead[:L - 1], full[:L - 1]) and not dead[L - 1].any()
    for T in (128, 256, 512, 1024):
        p = hist_cuda.plan(1 << 20, 28, 64, 64, "int8", T)
        assert p["chunk_rows"] % T == 0 and p["chunk_rows"] % 256 == 0
        assert p["ls_max"] == hist_cuda.HIST_SMEM_BUDGET // (64 * 6 * 4)
    with pytest.raises(ValueError, match="scale tile"):
        hist_cuda.plan(N, F, L, B, "int8")


def test_int8_cell_words():
    """An int8 cell takes 6 shared words, as a bf16x2 one: the int32 sums
    of its warp's current scale tile and the f32 sums (no per-cell tile)."""
    assert hist_cuda.cell_words("int8") == 6
    assert hist_cuda.cell_words("bf16x2") == 6
    assert hist_cuda.cell_words("int8sr") == 3


@pytest.mark.parametrize("T", [128, 256, 512, 1024])
def test_int8_headline_plans_one_group(T):
    """At the headline width (F = 28, B = 64) K1 at L = 64, and K2's and
    K6's plans at nslots + 1 = 64 slots, hold every slot in one group, so
    each row is read once, at every scale tile."""
    N, F, B = 1 << 20, 28, 64
    k1 = hist_cuda.plan(N, F, 64, B, "int8", T)
    assert (k1["ls_max"], k1["groups"]) == (64, 1)
    assert k1["ls_max"] * k1["nb"] * hist_cuda.cell_words("int8") * 4 \
        <= hist_cuda.HIST_SMEM_BUDGET
    assert hist_cuda.plan(N, F, 63 + 1, B, "int8", T)["groups"] == 1
    # K6's subtraction ladder at the headline: every bucket one group
    for p in loop_cuda.bucket_plans(N, F, B, "int8", (4, 16, 63), True):
        assert p["groups"] == 1


def test_int8_staged_and_fused_plans_agree():
    """K1's plan at L = 64 and K2's at nslots + 1 = 64, each at its own
    scale tile, agree chunk for chunk at the headline's N, F and T: the
    staged and fused int8 trainings sum the same rows in the same chunks,
    so they write one model text."""
    N, F, B = 1 << 20, 28, 64
    T1 = hist_cuda.hist_row_tile(64, F, B)
    T2 = hist_cuda.round_row_tile(63, F, B)
    assert T1 == T2 == 512
    k1 = hist_cuda.plan(N, F, 64, B, "int8", T1)
    k2 = hist_cuda.plan(N, F, 63 + 1, B, "int8", T2)
    assert k1 == k2
    assert (k1["groups"], k1["n_chunks"]) == (1, 19)
    assert k1["chunk_rows"] % T1 == 0


# ---------------------------------------------------------------------------
# the fused round (K2) and the loop (K6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [4, 16])
@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_fused_round_int8_matches_jax(sub, S):
    """``make_fused_round`` at int8 against the JAX package's (interpret
    mode): leaf ids exact; hsmall bit for bit (the same tile sums in the
    same order, the scales over all of a tile's rows); picks identical,
    sums bit for bit pool-free and within 4e-6 of the children's
    absolute mass with subtraction, gains within the bound."""
    r = _round(71 + S + sub, 5, 16, 1777, S, 2 * S + 3, sub)
    t, j = torch.from_numpy, jnp.asarray
    r["g3"] = r["g3"] * (np.random.RandomState(S).rand(1777) < 0.8)[:, None]
    r["g3"] = r["g3"].astype(np.float32)
    tfn = twf.make_fused_round(meta=r["tmeta"], params=tsplit.SplitParams(
        **PARAMS), num_bins=r["B"], precision="int8", deep_precision="int8")
    route = dict(leaf_id=t(r["lids"]), feats=t(r["feats"]),
                 thrs=t(r["thrs"]), dls=t(r["dls"]), leafs=t(r["leafs"]),
                 nls=t(r["nls"]), num_leaves=r["num_leaves"])
    rows8 = tq.NearestRows(t(r["g3"]))
    ptab, hsm, nleaf = tfn(
        t(r["binned"]), t(r["g3"]), r["S"], mask=t(r["mask"]),
        csums=t(r["csums"]), sml=t(r["sml"]) if sub else None,
        parent=t(r["parent"]) if sub else None, route=route, rows8=rows8)
    jfn = jwf.make_fused_round(meta=r["jmeta"], params=jsplit.SplitParams(
        **PARAMS), num_bins=r["B"], precision="int8", deep_precision="int8",
        interpret=True)
    C = 2 * r["S"]
    jroute = dict(leaf_id=j(r["lids"]), feats=j(r["feats"]),
                  thrs=j(r["thrs"]), dls=j(r["dls"]), leafs=j(r["leafs"]),
                  nls=j(r["nls"]), num_leaves=r["num_leaves"])
    jtab, jhsm, _, jleaf = jfn(
        j(r["binned"]), j(r["g3"]), None, r["S"], mask=j(r["mask"]),
        csums=j(r["csums"]),
        constr=jnp.tile(jnp.asarray(jsplit.NO_CONSTRAINT, jnp.float32),
                        (C, 1)),
        depth=jnp.ones(C, jnp.int32), pout=jnp.zeros(C, jnp.float32),
        sml=j(r["sml"]) if sub else None,
        parent=j(r["parent"]) if sub else None, route=jroute)
    np.testing.assert_array_equal(nleaf.numpy(), np.asarray(jleaf))
    if sub:
        np.testing.assert_array_equal(_bits(hsm.numpy()), _bits(jhsm))
    p, q = ptab.numpy(), np.asarray(jtab)
    np.testing.assert_array_equal(p[:, 1:4], q[:, 1:4])
    fin = np.isfinite(q[:, 0])
    np.testing.assert_array_equal(np.isfinite(p[:, 0]), fin)
    tol_s = 4e-6 * np.concatenate([r["child_absum"]] * 2, 1) + 1e-6
    assert (np.abs(p[:, 4:] - q[:, 4:]) <= tol_s)[fin].all()
    lg, lh = q[fin, 4].astype(np.float64), q[fin, 5].astype(np.float64)
    rg, rh = q[fin, 7].astype(np.float64), q[fin, 8].astype(np.float64)
    gb = 4e-6 * (lg ** 2 / lh + rg ** 2 / rh
                 + np.abs((lg + rg) ** 2 / (lh + rh))) + 1e-6
    assert (np.abs(p[fin, 0] - q[fin, 0]) <= gb).all()
    # the int8 round is not the f32 one
    f32 = twf.make_fused_round(meta=r["tmeta"], params=tsplit.SplitParams(
        **PARAMS), num_bins=r["B"], precision="f32", deep_precision="f32")(
        t(r["binned"]), t(r["g3"]), r["S"], mask=t(r["mask"]),
        csums=t(r["csums"]), sml=t(r["sml"]) if sub else None,
        parent=t(r["parent"]) if sub else None, route=route)
    assert not np.array_equal(f32[0].numpy()[fin, 4:], p[fin, 4:])


@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_loop_int8_matches_jax(sub):
    """The port's loop at int8 against the JAX package's (its planner
    engages it: one row tile for the ladder), with the f32 loop test's
    checks (``_check_against_jax``: leaf ids, split counts and picks
    exact, gains and sums within 4e-6 of the mass that cancels in them),
    and the pool bit for bit: the same int8 histograms, subtracted in the
    same order."""
    s = _segment(sum(map(ord, f"int8-loop-{sub}")), 6, 16, 1000, 8, 32, 3,
                 sub, (4, 8))
    rounds, _, pool = _check_against_jax(s, 4, "int8")
    assert len(rounds) >= 3
    if sub:
        jpool = _jax_loop(s, 4, "int8")[2]
        np.testing.assert_array_equal(_bits(pool), _bits(jpool))


@pytest.mark.parametrize("sub", [True, False], ids=["sub", "pool-free"])
def test_loop_int8_is_its_single_rounds(sub):
    """The loop at int8 on a ladder whose buckets price different scale
    tiles (which the JAX planner refuses) equals R single rounds, each at
    its bucket's own tile, bit for bit: K6's rounds are K2's."""
    s = _segment(sum(map(ord, f"int8-rounds-{sub}")), 28, 64, 2000, 16, 48,
                 1, sub, (4, 16) if sub else (2, 16))
    tiles = {hist_cuda.round_row_tile(S if sub else 2 * S, 28, 64)
             for S in s["ladder"]}
    assert len(tiles) > 1
    t = torch.from_numpy
    kw = dict(rounds=4, K=s["K"], slot_buckets=s["ladder"],
              max_depth=s["max_depth"], base_mask=t(s["mask"]),
              num_bins=s["B"], precision="int8", meta=s["tmeta"],
              params=tsplit.SplitParams(**PARAMS),
              pool=t(s["pool"]) if sub else None,
              rows8=tq.NearestRows(t(s["g3"])))
    pos = (t(s["binned"]), t(s["g3"]), t(s["lids"]), t(s["ft"]), s["nl"])
    got = loop_cuda.fused_wave_loop(*pos, **kw)
    calls = []

    def round_fn(binned, g3, **rkw):
        calls.append(rkw["nslots"])
        return loop_cuda.fused_cuda.fused_round(binned, g3, **rkw)

    want = loop_cuda.loop_rounds(*pos, round_fn=round_fn, **kw)
    assert len(set(calls)) > 1
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def test_loop_int8_refusals():
    """The loop's plan keeps the JAX planner's refusals in its words: a
    deep int8 drop under bf16x2 with a reachable 32-slot bucket, and
    int8sr buckets beside an int8 base."""
    plan = dict(rounds=4, N=1 << 17, F=6, num_bins=64, K=32, L=64,
                use_sub=True, slot_buckets=(4, 16, 32))
    drop = twf.plan_wave_loop(precision="bf16x2", deep_precision="int8",
                              **plan)
    assert drop["reason"] == ("deep-precision drop would change the "
                              "accumulate dtype mid-loop")
    both = twf.plan_wave_loop(precision="int8", deep_precision="int8",
                              quant_buckets=(16, 32), **plan)
    assert both["reason"] == ("int8sr-in-loop needs the exact-integer f32 "
                              "accumulate (hist_dtype=f32)")
    assert twf.plan_wave_loop(precision="int8", deep_precision="int8",
                              **plan)["eligible"]
    meta = with_tables(FeatureMeta(*(torch.zeros(2, dtype=torch.int64),) * 4,
                                   usable=torch.ones(2, dtype=torch.bool)))
    cfg = Config.from_dict({"objective": "binary", "num_leaves": 255,
                            "hist_method": "fused", "wave_loop_rounds": 4,
                            "hist_dtype_deep": "int8"})
    with pytest.raises(NotImplementedError, match="deep-precision drop"):
        build_trainer(cfg, meta, SplitParams(), 64, torch.device("cpu"),
                      num_data=1 << 17)


# ---------------------------------------------------------------------------
# whole trainings against the JAX package
# ---------------------------------------------------------------------------

# tests/test_torch_train.py's sizes: 15 leaves in waves of 8 (buckets 4
# and 8), and for the deep rounds 33 leaves in waves of 32 (the 32-slot
# bucket deep); two trees of 2,048 rows.  Past the first tree the two
# packages' gradients may differ in an ulp, and a rounding to 255 levels
# turns an ulp into another integer: the trees stay identical here.
INT8 = {"objective": "binary", "num_leaves": 15, "leafwise_wave_size": 8,
        "min_data_in_leaf": 5, "verbosity": -1, "seed": 7,
        "hist_method": "pallas", "max_bin": 63, "hist_dtype": "int8"}
DEEP = {"hist_dtype": "bf16x2", "hist_dtype_deep": "int8", "num_leaves": 33,
        "leafwise_wave_size": 32, "min_data_in_leaf": 3}


def _problem(n):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 8)
    y = (X[:, 0] * 1.5 - X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _assert_trees_match(tb, jb, rounds):
    jtrees = jax.device_get(jb._gbdt._device_trees)
    ttrees = tb._gbdt._device_trees
    assert len(jtrees) == len(ttrees) == rounds
    for jt, tt in zip(jtrees, ttrees):
        c = tree_arrays_from_numpy(jt._asdict())
        n = int(c.num_leaves)
        assert n == int(tt.num_leaves) > 2
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child"):
            assert torch.equal(getattr(c, f)[:n - 1],
                               getattr(tt, f)[:n - 1]), f
        assert torch.equal(c.leaf_count[:n], tt.leaf_count[:n])
        np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                   c.leaf_value[:n].numpy(), rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("extra", [
    {}, {"hist_method": "fused"},
    {"hist_method": "fused", "wave_loop_rounds": 2}, DEEP,
    dict(DEEP, hist_method="fused")],
    ids=["staged", "fused", "looped", "deep staged", "deep fused"])
def test_int8_trees_match_jax(low_buckets, extra):
    """hist_dtype=int8 (staged, fused, looped) and hist_dtype_deep=int8
    under bf16x2 (staged, fused; waves of 32, so the sustained bucket runs
    int8) train the JAX package's trees: every split identical, leaf
    values within 2e-5, predictions within 2e-5."""
    params = dict(INT8, **extra)
    rounds = 2
    X, y = _problem(2048)
    tb = lt.train(params, lt.Dataset(X, label=y), rounds, device="cpu")
    jb = lj.train(params, lj.Dataset(X, label=y), rounds,
                  verbose_eval=False)
    _assert_trees_match(tb, jb, rounds)
    np.testing.assert_allclose(tb.predict(X, raw_score=True),
                               jb.predict(X, raw_score=True), rtol=0,
                               atol=2e-5)


def test_int8_staged_fused_looped_one_text(low_buckets):
    """Staged, fused and looped int8 trainings write one model text byte
    for byte (K1's and K2's scale tiles agree on byte bins), a second
    staged training the same, and the text is not the f32 one."""
    X, y = _problem(2000)
    texts = [lt.train(dict(INT8, **extra), lt.Dataset(X, label=y), 2,
                      device="cpu").model_to_string()
             for extra in ({}, {}, {"hist_method": "fused"},
                           {"hist_method": "fused", "wave_loop_rounds": 4})]
    assert texts[0] == texts[1] == texts[2] == texts[3]
    f32 = lt.train(dict(INT8, hist_dtype="f32"), lt.Dataset(X, label=y), 2,
                   device="cpu").model_to_string()
    assert f32 != texts[0]


def test_int8_packed_trains_the_u8_text(low_buckets):
    """At max_bin=15 with packed bins (an even feature count: one scale
    tile for both legs) the int8 training writes the u8 text."""
    X, y = _problem(2000)
    p = dict(INT8, max_bin=15)
    u8 = lt.train(dict(p, bin_layout="u8"), lt.Dataset(X, label=y), 2,
                  device="cpu")
    pk = lt.train(dict(p, bin_layout="packed4"), lt.Dataset(X, label=y), 2,
                  device="cpu")
    assert pk._gbdt._packed and not u8._gbdt._packed
    assert pk.model_to_string() == u8.model_to_string()
