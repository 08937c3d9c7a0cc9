"""The one-hot histogram, ``hist_method=bench`` and the forced build
strategies of the port against the JAX package, on the CPU.

``ops/histogram.hist_leaves_onehot`` is the JAX package's one-hot
product (``hist_leaves_onehot``, XLA's matrix product there,
``torch.matmul`` here): the same leaf-masked rows times the same one-hot,
chunk by chunk, at f32, bf16 and bf16x2.  Both sum the same rounded
parts in f32, in other orders.

Tolerances: counts exact; each cell against the JAX package's within
twice its rows' count of f32 roundings of the cell's absolute sum
(``2 (n + 1) 2^-24 |sum|``, + 1e-6), as tests/test_torch_hist.py holds K1
to its plain version; against the scatter of the f32 rows also the
parts' own rounding (2^-16 of the absolute sum at bf16x2, 2^-8 at bf16).
f32 onehot trainings: every split identical, leaves within 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbmv1_tpu as lj
from lightgbmv1_tpu.config import Config as JConfig
from lightgbmv1_tpu.models import grower_wave as jgw
from lightgbmv1_tpu.ops import histogram as jhist

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.models import grower_wave as tgw
from lightgbmv1_tpu_torch.models.convert import tree_arrays_from_numpy
from lightgbmv1_tpu_torch.ops import hist_cuda
from lightgbmv1_tpu_torch.ops import histogram as th
from lightgbmv1_tpu_torch.parallel import trainer as ttrainer

PART_REL = {"f32": 0.0, "bf16x2": 2.0 ** -16, "bf16": 2.0 ** -8}
BASE = {"objective": "binary", "verbosity": -1, "seed": 7, "max_bin": 63,
        "num_leaves": 15, "min_data_in_leaf": 20, "hist_dtype": "f32"}


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
    saved = jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N
    jgw._BUCKET_MIN_N = tgw._BUCKET_MIN_N = 1
    yield
    jgw._BUCKET_MIN_N, tgw._BUCKET_MIN_N = saved


def _inputs(seed, F, B, N, L, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, (F, N)).astype(dtype)
    g3 = np.stack([rng.randn(N), np.abs(rng.randn(N)) * 0.25 + 0.01,
                   np.ones(N)], axis=1).astype(np.float32)
    leaf = rng.randint(0, L + 1, N).astype(np.int32)     # L: dead rows
    return binned, g3, leaf


def _tol(binned, g3, leaf, L, B):
    absum = hist_cuda.index_add_hist(
        torch.from_numpy(binned), [torch.from_numpy(np.abs(g3))],
        torch.from_numpy(leaf), L, B).numpy()
    return 2.0 * (absum[..., 2:3] + 1.0) * 2.0 ** -24 * absum + 1e-6, absum


@pytest.mark.parametrize("prec", ["f32", "bf16", "bf16x2"])
@pytest.mark.parametrize("L,chunk", [(1, 16384), (5, 700)],
                         ids=["one slot", "5 slots, chunks of 700"])
def test_onehot_matches_jax(prec, L, chunk):
    """The port's one-hot product against the JAX package's
    ``hist_leaves_onehot`` on the same inputs (one chunk, and several
    with a ragged last one): counts exact, values within the order
    bound; against the scatter of the f32 rows within it plus the parts'
    rounding."""
    B = 32
    binned, g3, leaf = _inputs(3, 6, B, 3000, L)
    got = th.hist_leaves_onehot(torch.from_numpy(binned),
                                torch.from_numpy(g3),
                                torch.from_numpy(leaf), L, B, prec,
                                row_chunk=chunk).numpy()
    want = np.asarray(jhist.hist_leaves_onehot(
        jnp.asarray(binned), jnp.asarray(g3), jnp.asarray(leaf), L, B,
        prec, chunk))
    assert got.shape == want.shape == (L, 6, B, 3)
    tol, absum = _tol(binned, g3, leaf, L, B)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert (np.abs(got - want) <= tol).all()
    exact = th.hist_leaves_scatter(torch.from_numpy(binned),
                                   torch.from_numpy(g3),
                                   torch.from_numpy(leaf), L, B).numpy()
    assert (np.abs(got - exact) <= tol + PART_REL[prec] * absum).all()


def test_onehot_sums_are_never_bf16():
    """A cell of 257 rows of 1.0: 257 is not a bf16 value (it rounds to
    256), and every leg returns 257 exactly: the products and the sums
    stay f32 (256 rows of slot 0 and one of slot 1 give 256 and 1); the
    live-slot limit zeroes the slots past it."""
    N = 257
    binned = np.zeros((2, N), np.uint8)
    g3 = np.ones((N, 3), np.float32)
    leaf = np.zeros(N, np.int32)
    leaf[-1] = 1
    for prec in ("f32", "bf16", "bf16x2"):
        h = th.hist_leaves_onehot(torch.from_numpy(binned),
                                  torch.from_numpy(g3),
                                  torch.from_numpy(leaf), 2, 8, prec)
        assert h.dtype == torch.float32
        assert h[0, 0, 0].tolist() == [256.0, 256.0, 256.0]
        assert h[1, 0, 0].tolist() == [1.0, 1.0, 1.0]
        h2 = th.hist_leaves_onehot(torch.from_numpy(binned),
                                   torch.from_numpy(g3),
                                   torch.from_numpy(np.zeros(N, np.int32)),
                                   2, 8, prec, live_slots=1)
        assert h2[0, 1, 0, 0].item() == 257.0
        assert not h2[1].any()


def test_f32_leg_runs_at_full_precision(monkeypatch):
    """The f32 leg multiplies at "highest" (never TF32) whatever the
    caller set, and the caller's setting comes back; on the CPU every
    leg is "highest", on the card the bf16 legs take TF32 (exact on their
    bf16-exact operands)."""
    seen = []
    orig = th._matmul_hist

    def spy(lg, onehot, precision):
        seen.append((precision, torch.get_float32_matmul_precision()))
        return orig(lg, onehot, precision)

    monkeypatch.setattr(th, "_matmul_hist", spy)
    binned, g3, leaf = _inputs(4, 3, 8, 600, 2)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        for prec in ("f32", "bf16x2"):
            th.hist_leaves_onehot(torch.from_numpy(binned),
                                  torch.from_numpy(g3),
                                  torch.from_numpy(leaf), 2, 8, prec)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen == [("f32", "highest"), ("bf16x2", "highest")]
    assert th.onehot_matmul_level("f32", "cuda") == "highest"
    assert th.onehot_matmul_level("bf16", "cuda") == "high"
    assert th.onehot_matmul_level("bf16x2", "cpu") == "highest"


def _assert_trees_match(tb, jb, rounds, leaf_tol=2e-5):
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
        if leaf_tol is not None:
            np.testing.assert_allclose(tt.leaf_value[:n].numpy(),
                                       c.leaf_value[:n].numpy(), rtol=0,
                                       atol=leaf_tol)


def _problem(n=2048, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    y = (X[:, 0] * 1.5 - X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


@pytest.mark.parametrize("extra", [
    {"hist_method": "onehot", "leafwise_wave_size": 4},
    {"hist_method": "onehot", "tree_growth": "levelwise"},
    {"force_row_wise": True, "leafwise_wave_size": 4}],
    ids=["onehot wave", "onehot level-wise", "force_row_wise"])
def test_onehot_trees_match_jax(low_buckets, extra):
    """f32 onehot trainings (named, or through force_row_wise) grow the
    JAX package's onehot trees: every split identical, leaves within
    2e-5; the port's path ran the one-hot product."""
    X, y = _problem()
    params = dict(BASE, **extra)
    before = th.matmul_counts["hist_leaves_onehot"]
    tb = lt.train(params, lt.Dataset(X, label=y), 4, device="cpu")
    assert th.matmul_counts["hist_leaves_onehot"] > before
    assert tb._gbdt._grow.hist_method == "onehot"
    jb = lj.train(params, lj.Dataset(X, label=y), 4, verbose_eval=False)
    _assert_trees_match(tb, jb, 4)


@pytest.mark.parametrize("col,row,method", [
    (False, False, "auto"), (True, False, "scatter"), (False, True, "onehot"),
    (True, True, None)])
def test_forced_strategies_map_as_jax(col, row, method):
    """force_col_wise maps hist_method=auto to scatter and force_row_wise
    to onehot, as the JAX config does; an explicit method stays; both at
    once raise ValueError in both packages."""
    kw = {"force_col_wise": col, "force_row_wise": row}
    if method is None:
        for cfg in (Config, JConfig):
            with pytest.raises(ValueError, match="force_col_wise and "
                                                 "force_row_wise"):
                cfg.from_dict(kw)
        return
    assert Config.from_dict(kw).hist_method == method
    assert JConfig.from_dict(kw).hist_method == method
    for m in ("pallas", "bench"):
        assert Config.from_dict(dict(kw, hist_method=m)).hist_method == m


def _jax_candidates(monkeypatch, backend, dtype, packed, must):
    """The methods the JAX ``benchmark_hist_methods`` times, in order, on
    a ``backend`` (its histogram pass replaced by a spy that returns
    zeros), or its untimed single pick."""
    calls = []

    def spy(binned, g3, label, nslots, num_bins, method="scatter", **kw):
        calls.append(method)
        return jnp.zeros((nslots, binned.shape[0], num_bins, 3))

    with monkeypatch.context() as m:
        m.setattr(jhist, "hist_wave", spy)
        m.setattr(jhist.jax, "default_backend", lambda: backend)
        pick = jhist.benchmark_hist_methods(
            np.zeros((3, 600), dtype), 16, "bf16x2", packed, 3,
            max_rows=600, must_include=must)
    return list(dict.fromkeys(calls)) or [pick]


@pytest.mark.parametrize("device,backend", [("cpu", "cpu"),
                                            ("cuda", "gpu")])
@pytest.mark.parametrize("dtype,packed", [(np.uint8, False),
                                          (np.int16, False),
                                          (np.uint8, True)],
                         ids=["u8", "int16", "packed"])
@pytest.mark.parametrize("must", [None, "scatter", "onehot", "pallas"])
def test_bench_candidates_match_jax(monkeypatch, device, backend, dtype,
                                    packed, must):
    """``bench_candidates`` is the list the JAX bench times, in its
    order, on each device, bin type and layout, with each forced
    method."""
    want = _jax_candidates(monkeypatch, backend, dtype, packed, must)
    tdtype = torch.from_numpy(np.zeros(1, dtype)).dtype
    got = th.bench_candidates(device, tdtype, packed, must)
    # no candidate: both benches return the static pick untimed
    assert (got or [th.default_hist_method("auto", device, tdtype)]) == want


def test_bench_trains_its_pick_and_raises_on_a_failing_candidate(
        monkeypatch):
    """hist_method=bench on the CPU times scatter and onehot and trains
    the model text of the method it picks; the pick and the candidates'
    times are on the grower.  A candidate that fails makes the training
    raise (the JAX bench drops it): nothing is caught."""
    X, y = _problem(1024)
    b = lt.train(dict(BASE, hist_method="bench"), lt.Dataset(X, label=y), 2,
                 device="cpu")
    pick = b._gbdt._grow.hist_method
    assert set(b._gbdt._grow.bench_times) == {"scatter", "onehot"}
    assert pick == min(b._gbdt._grow.bench_times,
                       key=b._gbdt._grow.bench_times.get)
    direct = lt.train(dict(BASE, hist_method=pick), lt.Dataset(X, label=y),
                      2, device="cpu")
    assert b.model_to_string() == direct.model_to_string()

    def broken(*a, **k):
        raise RuntimeError("candidate failed to launch")

    monkeypatch.setattr(th, "hist_leaves_onehot", broken)
    with pytest.raises(RuntimeError, match="candidate failed"):
        lt.train(dict(BASE, hist_method="bench"), lt.Dataset(X, label=y), 1,
                 device="cpu")


def test_auto_benches_past_256_features_on_the_card(monkeypatch):
    """hist_method=auto times the candidates on the card past 256 byte-bin
    features (the JAX trainer's ambiguous shape), and nowhere else;
    bench adds a forced strategy to its candidates."""
    seen = []

    def fake_bench(binned, num_bins, precision, packed, num_features,
                   must_include=None, times_out=None, **kw):
        seen.append((num_features, must_include))
        return "onehot"

    monkeypatch.setattr(ttrainer, "benchmark_hist_methods", fake_bench)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    wide = torch.zeros((1, 4), dtype=torch.uint8)
    auto = Config()
    assert ttrainer.resolve_hist_method(auto, cuda, torch.uint8, wide, 64,
                                        False, 257) == "onehot"
    assert ttrainer.resolve_hist_method(auto, cuda, torch.uint8, wide, 64,
                                        False, 256) == "pallas"
    assert ttrainer.resolve_hist_method(auto, cpu, torch.uint8, wide, 64,
                                        False, 300) == "scatter"
    assert ttrainer.resolve_hist_method(auto, cuda, torch.int16, wide, 512,
                                        False, 300) == "onehot"
    bench = Config.from_dict({"hist_method": "bench",
                              "force_col_wise": True})
    assert ttrainer.resolve_hist_method(bench, cpu, torch.uint8, wide, 64,
                                        False, 3) == "onehot"
    assert seen == [(257, None), (3, "scatter")]
