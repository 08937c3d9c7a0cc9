"""K1's plain version against the Pallas histogram kernel it replaces.

On the CPU the port's ``ops/hist_cuda.hist_leaves`` computes its plain
PyTorch version (``hist_leaves_ref``); here it is held to the JAX
package's ``hist_leaves_pallas`` run in Pallas interpret mode (as
tests/test_histogram.py runs it) on the same numpy inputs.  The CUDA
kernel itself is held to the plain version on the card by chip_smoke.py.

Tolerances: counts exact in every precision.  Both sides round each row
value to bf16 identically (round to nearest even) and differ only in the
order of their f32 sums (the Pallas kernel adds hi and lo per row tile,
the port at the end), so every cell agrees within
``4e-6 * sum(|v|) + 1e-7`` over the cell's rows — about 64 f32 ulps of
the cell's absolute mass — in all three precisions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbmv1_tpu.ops.hist_pallas import hist_leaves_pallas
from lightgbmv1_tpu.ops.histogram import hist_wave as jax_hist_wave

from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.ops import hist_cuda
from lightgbmv1_tpu_torch.ops.histogram import (default_hist_method,
                                                hist_frontier,
                                                hist_leaves_scatter,
                                                hist_wave)

N, F = 1777, 4          # ragged N: the kernels' row tiles do not divide it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, L):
    """Bins over the whole axis, signed grads, positive hess, a 0/1 count
    column, slot ids over [0, L) plus a few outside it (dropped by both)."""
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    g3 = rng.randn(N, 3).astype(np.float32)
    g3[:, 1] = np.abs(g3[:, 1]) * 0.25
    g3[:, 2] = (rng.rand(N) < 0.9).astype(np.float32)
    leaf = rng.randint(0, L, size=N).astype(np.int32)
    leaf[rng.rand(N) < 0.02] = L + 3
    leaf[rng.rand(N) < 0.02] = -1
    return binned, g3, leaf


def _tol(binned, g3, leaf, L, B):
    absum = hist_leaves_scatter(torch.from_numpy(binned),
                                torch.from_numpy(np.abs(g3)),
                                torch.from_numpy(leaf), L, B).numpy()
    return 4e-6 * absum + 1e-7


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x2"])
@pytest.mark.parametrize("B", [16, 64, 256])
def test_plain_matches_pallas(B, precision):
    L = 5
    binned, g3, leaf = _inputs(B, B, L)
    want = np.asarray(hist_leaves_pallas(
        jnp.asarray(binned), jnp.asarray(g3), jnp.asarray(leaf), L, B,
        precision=precision, interpret=True))
    before = hist_cuda.plain_counts["hist_leaves"]
    got = hist_cuda.hist_leaves(torch.from_numpy(binned),
                                torch.from_numpy(g3),
                                torch.from_numpy(leaf), L, B,
                                precision=precision).numpy()
    assert hist_cuda.plain_counts["hist_leaves"] == before + 1
    assert got.shape == want.shape == (L, F, B, 3)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    tol = _tol(binned, g3, leaf, L, B)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    # the slot ids outside [0, L) were dropped by both
    kept = ((leaf >= 0) & (leaf < L) & (g3[:, 2] > 0)).sum()
    assert got[..., 2].sum() == F * kept


@pytest.mark.parametrize("precision", ["f32", "bf16x2"])
def test_bins_off_the_rung_are_dropped(precision):
    """A padded bin axis between rungs (B = 32 runs on the 64 rung) and
    bins at or past B contribute nothing, as in the Pallas kernel."""
    L, B = 3, 32
    binned, g3, leaf = _inputs(7, 40, L)
    want = np.asarray(hist_leaves_pallas(
        jnp.asarray(binned), jnp.asarray(g3), jnp.asarray(leaf), L, B,
        precision=precision, interpret=True))
    got = hist_cuda.hist_leaves(torch.from_numpy(binned),
                                torch.from_numpy(g3),
                                torch.from_numpy(leaf), L, B,
                                precision=precision).numpy()
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert (np.abs(got - want) <= _tol(binned, g3, leaf, L, B)).all()


def test_plain_version_is_deterministic():
    binned, g3, leaf = map(torch.from_numpy, _inputs(3, 64, 5))
    a = hist_cuda.hist_leaves(binned, g3, leaf, 5, 64, "bf16x2")
    b = hist_cuda.hist_leaves(binned, g3, leaf, 5, 64, "bf16x2")
    assert torch.equal(a, b)


def test_precision_parts_round_to_nearest_even():
    """hi = bf16_rn(v), lo = bf16_rn(v - hi): the split the kernel and
    the Pallas kernel make, checked on values that sit on a tie; int8
    rounds half to even too, under its tile's scale (127 / amax = 1 here,
    so the rows' own ties)."""
    v = torch.tensor([[1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -2.5, 0.1]],
                     dtype=torch.float32).T.repeat(1, 3)
    hi, lo = hist_cuda.split_parts(v, "bf16x2")
    assert hi[0, 0] == 1.0 and hi[1, 0] == 1.0 + 2 ** -6
    assert torch.equal((hi + lo)[:3], v[:3])      # 16 bits hold these
    assert float((hi + lo - v)[3].abs().max()) <= 0.1 * 2 ** -15
    assert torch.equal(hist_cuda.split_parts(v, "bf16")[0], hi)
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -3.5, 127.0],
                        dtype=torch.float32)[:, None].repeat(1, 3)
    ties[:, 2] = 1.0
    q, scale = hist_cuda.int8_rows(ties, 128)
    assert q[:, 0].tolist() == [0.0, 2.0, 2.0, -0.0, -4.0, 127.0]
    assert q[:, 2].tolist() == [64.0] * 6
    assert scale[0, 2] == 1 / 64 and scale[0, 0] == np.float32(127 / 127)


@pytest.mark.parametrize("method", ["scatter", "pallas"])
def test_hist_wave_slices_the_dead_slot(method):
    """Rows labelled nslots are dead: they land in the sacrificial slot
    that hist_wave slices away, as the JAX package's hist_wave does."""
    nslots, B = 4, 64
    binned, g3, label = _inputs(11, B, nslots + 1)
    label[label > nslots] = nslots
    label[label < 0] = nslots
    tb, tg, tl = map(torch.from_numpy, (binned, g3, label))
    got = hist_wave(tb, tg, tl, nslots, B, method=method,
                    precision="f32").numpy()
    assert got.shape == (nslots, F, B, 3)
    full = hist_frontier(tb, tg, tl, nslots + 1, B, method=method,
                         precision="f32").numpy()
    np.testing.assert_array_equal(got, full[:nslots])
    live = label < nslots
    only_live = hist_leaves_scatter(tb[:, live], tg[live], tl[live], nslots,
                                    B).numpy()
    np.testing.assert_array_equal(got[..., 2], only_live[..., 2])
    np.testing.assert_allclose(got, only_live, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_hist_wave(
        jnp.asarray(binned), jnp.asarray(g3), jnp.asarray(label), nslots, B,
        method="pallas", precision="f32", interpret=True))
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert (np.abs(got - want) <= _tol(binned, g3, label, nslots, B)).all()


def test_default_hist_method_resolution():
    """auto is the CUDA kernel K1 (method pallas) for a CUDA device and
    the scatter oracle for the CPU; explicit methods stay; fused is its
    base method pallas (its root pass); the unported ones raise."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert default_hist_method("auto", cuda) == "pallas"
    assert default_hist_method("auto", "cuda:0") == "pallas"
    assert default_hist_method("auto", cpu) == "scatter"
    for m in ("scatter", "pallas"):
        assert default_hist_method(m, cuda) == m
        assert default_hist_method(m, cpu) == m
    for dev in (cuda, cpu):
        assert default_hist_method("fused", dev) == "pallas"
    for m in ("onehot", "bench"):
        with pytest.raises(NotImplementedError, match="onehot and bench"):
            default_hist_method(m, cuda)
    assert Config().hist_method == "auto"


def test_wrapper_refuses_other_devices_and_precisions():
    binned, g3, leaf = map(torch.from_numpy, _inputs(5, 16, 2))
    with pytest.raises(ValueError, match="cpu or cuda"):
        hist_cuda.hist_leaves(binned.to("meta"), g3, leaf, 2, 16)
    # int8 is a precision of the wrapper now: on a CPU tensor its plain
    # version, the Pallas kernel's order at K1's scale tile
    q, scale = hist_cuda.int8_rows(g3, hist_cuda.hist_row_tile(2, 5, 16))
    assert torch.equal(
        hist_cuda.hist_leaves(binned, g3, leaf, 2, 16, precision="int8"),
        hist_cuda.int8_hist(binned, q, scale, hist_cuda.hist_row_tile(
            2, 5, 16), leaf, 2, 16))
    with pytest.raises(ValueError):
        hist_cuda.hist_leaves(binned, g3, leaf, 2, 16, precision="int4")
    with pytest.raises(ValueError):
        hist_cuda.kernel_width(257)
    assert [hist_cuda.kernel_width(b) for b in (8, 16, 32, 64, 128, 256)] \
        == [16, 16, 64, 64, 256, 256]


def test_plan_is_a_function_of_the_shape():
    """The chunking (and so the merge order, and so the bits) depends on
    the shapes alone; at the headline shape a block holds all 64 slots of
    64 bins in the 96 KiB budget."""
    p = hist_cuda.plan(1 << 20, 28, 64, 64, "bf16x2")
    assert p == hist_cuda.plan(1 << 20, 28, 64, 64, "bf16x2")
    assert p["ls_max"] == 64 and p["groups"] == 1 and p["nb"] == 64
    assert p["n_chunks"] * p["chunk_rows"] >= 1 << 20
    assert (p["n_chunks"] - 1) * p["chunk_rows"] < 1 << 20
    assert p["ls_max"] * p["nb"] * p["nc"] * 4 <= hist_cuda.HIST_SMEM_BUDGET
    wide = hist_cuda.plan(1777, 6, 64, 256, "bf16x2")
    assert wide["groups"] == -(-64 // wide["ls_max"]) > 1
    assert hist_cuda.plan(0, 3, 2, 16, "f32")["n_chunks"] == 1


def test_plain_calls_are_counted_and_launch_counts_stay():
    """On the CPU both plain histograms count their calls under their own
    names, and neither the kernel's launch count nor its per-bucket
    counts move; a reset clears them all."""
    binned, g3, leaf = map(torch.from_numpy, _inputs(9, 16, 3))
    hist_cuda.reset_launch_counts()
    hist_cuda.bucket_launch_counts[(3, "f32")] = 1    # as a launch leaves it
    hist_cuda.reset_launch_counts()
    assert hist_cuda.bucket_launch_counts == {}
    hist_frontier(binned, g3, leaf, 3, 16, method="pallas")
    hist_wave(binned, g3, leaf, 2, 16, method="scatter")
    hist_cuda.hist_leaves_roworder_ref(binned, g3, leaf, 3, 16)
    assert hist_cuda.plain_counts == {"hist_leaves": 1,
                                      "hist_leaves_roworder": 1,
                                      "hist_leaves_scatter": 1}
    assert hist_cuda.launch_counts == {"hist_leaves": 0,
                                       "hist_leaves_packed": 0}
    assert hist_cuda.bucket_launch_counts == {}
    hist_cuda.reset_launch_counts()
    assert not any(hist_cuda.plain_counts.values())


# ---------------------------------------------------------------------------
# the row-order plain version (the kernel's order) and the dead slot
# ---------------------------------------------------------------------------


def _order_inputs(precision):
    """Two features, 700 rows (three 256-row chunks under the plan), three
    slots of 16 bins, with cells where the order of the adds decides the
    bits: 1e8, 1, -1e8 in one cell (1 is lost or kept by the order), a
    cell of -0.0 values only, and +-1e-3 noise elsewhere."""
    rng = np.random.RandomState(5)
    n, L = 700, 3
    binned = rng.randint(0, 16, size=(2, n)).astype(np.uint8)
    leaf = rng.randint(0, L, size=n).astype(np.int32)
    g3 = (rng.randn(n, 3) * 1e-3).astype(np.float32)
    g3[:, 2] = 1.0
    # rows 10, 20, 30 of chunk 0 and 300, 310 of chunk 1: slot 1, bin 7,
    # and no other row there
    big = [10, 20, 30, 300, 310]
    binned[:, leaf == 1] = np.where(binned[:, leaf == 1] == 7, 6,
                                    binned[:, leaf == 1])
    binned[:, big] = 7
    leaf[big] = 1
    g3[big, 0] = [1e8, 1.0, -1e8, 1.0, 3.0]
    g3[big, 1] = [1.0, 1e8, 1.0, -1e8, 1.0]
    # slot 2, bin 15: -0.0 rows only (a +0.0 cell, as the kernel's 0.f
    # start gives), and bin 15 nowhere else
    binned[binned == 15] = 14
    neg = [5, 6, 400]
    binned[:, neg] = 15
    leaf[neg] = 2
    g3[neg, :2] = -0.0
    return binned, g3, leaf, L, 16


def _per_cell_loop(binned, g3, leaf, L, B, precision, live=None):
    """The kernel's order written as a pure-Python loop over cells."""
    F, N = binned.shape
    p = hist_cuda.plan(N, F, L, B, precision)
    parts = [x.numpy() for x in hist_cuda.split_parts(torch.from_numpy(g3),
                                                       precision)]
    live = L if live is None else live
    out = np.zeros((L, F, B, 3), dtype=np.float32)
    for f in range(F):
        for s in range(L):
            for b in range(B):
                tot = [np.float32(0.0)] * (3 * len(parts))
                for ch in range(p["n_chunks"]):
                    r0 = ch * p["chunk_rows"]
                    rows = [r for r in range(r0, min(N, r0 + p["chunk_rows"]))
                            if leaf[r] == s and s < live and binned[f, r] == b]
                    for k, part in enumerate(parts):
                        for c in range(3):
                            acc = np.float32(0.0)
                            for r in rows:
                                acc = np.float32(acc + part[r, c])
                            tot[3 * k + c] = np.float32(tot[3 * k + c] + acc)
                for c in range(3):
                    v = tot[c]
                    if len(parts) == 2:
                        v = np.float32(v + tot[3 + c])
                    out[s, f, b, c] = v
    return out


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x2"])
def test_roworder_equals_per_cell_loop(precision):
    """hist_leaves_roworder_ref is the kernel's order: bit for bit a
    Python loop that adds each cell's rows in row order from 0 in f32 per
    chunk and sums the chunks in order, hi and lo apart — with more than
    one chunk, order-sensitive sums, and -0.0 rows (a +0.0 cell)."""
    binned, g3, leaf, L, B = _order_inputs(precision)
    assert hist_cuda.plan(binned.shape[1], 2, L, B, precision)["n_chunks"] \
        == 3
    got = hist_cuda.hist_leaves_roworder_ref(
        torch.from_numpy(binned), torch.from_numpy(g3),
        torch.from_numpy(leaf), L, B, precision).numpy()
    want = _per_cell_loop(binned, g3, leaf, L, B, precision)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the order mattered: 1e8 + 1 - 1e8 in chunk 0 is 0 in f32, and the
    # chunk sums 0 + 4 give 4, where the exact sum is 5
    assert got[1, 0, 7, 0] == 4.0 or precision != "f32"
    assert not np.signbit(got[2, :, 15, :2]).any()
    assert (got[2, :, 15, 2] == 3.0).all()


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x2"])
@pytest.mark.parametrize("B", [16, 64])
def test_roworder_within_tolerance(B, precision):
    """The row-order version against the index_add_ version (within the
    card check's K1 bound 2 (n + 1) 2^-24 of a cell's absolute sum, the
    f32 bound of two orders of n adds) and against the JAX Pallas kernel
    in interpret mode (within 4e-6 of the mass, as
    test_plain_matches_pallas); counts exact."""
    L = 5
    binned, g3, leaf = _inputs(B + 1, B, L)
    tb, tg, tl = map(torch.from_numpy, (binned, g3, leaf))
    got = hist_cuda.hist_leaves_roworder_ref(tb, tg, tl, L, B,
                                             precision).numpy()
    ref = hist_cuda.hist_leaves_ref(tb, tg, tl, L, B, precision).numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    absum = hist_leaves_scatter(tb, torch.from_numpy(np.abs(g3)), tl, L,
                                B).numpy()
    k1_tol = 2.0 * (absum[..., 2:3] + 1.0) * 2.0 ** -24 * absum + 1e-6
    assert (np.abs(got - ref) <= k1_tol).all()
    want = np.asarray(hist_leaves_pallas(
        jnp.asarray(binned), jnp.asarray(g3), jnp.asarray(leaf), L, B,
        precision=precision, interpret=True))
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    assert (np.abs(got - want) <= _tol(binned, g3, leaf, L, B)).all()


@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x2"])
def test_dead_slot_adds_nothing(precision):
    """With live_slots = L - 1 the last slot's rows add nothing: its cells
    are +0.0 and every live cell is bitwise the all-live result, in the
    row-order version, the wrapper's CPU path and the scatter oracle; the
    per-cell loop agrees."""
    L, B = 5, 16
    binned, g3, leaf = _inputs(21, B, L)
    tb, tg, tl = map(torch.from_numpy, (binned, g3, leaf))
    for fn in (hist_cuda.hist_leaves_roworder_ref, hist_cuda.hist_leaves):
        full = fn(tb, tg, tl, L, B, precision).numpy()
        dead = fn(tb, tg, tl, L, B, precision, live_slots=L - 1).numpy()
        np.testing.assert_array_equal(_bits(dead[:L - 1]),
                                      _bits(full[:L - 1]))
        assert (_bits(dead[L - 1]) == 0).all()
        assert full[L - 1, ..., 2].sum() > 0
    np.testing.assert_array_equal(
        _bits(hist_cuda.hist_leaves_roworder_ref(tb[:, :300], tg[:300],
                                                 tl[:300], L, B, precision,
                                                 live_slots=L - 1).numpy()),
        _bits(_per_cell_loop(binned[:, :300], g3[:300], leaf[:300], L, B,
                             precision, live=L - 1)))
    full = hist_leaves_scatter(tb, tg, tl, L, B).numpy()
    dead = hist_leaves_scatter(tb, tg, tl, L, B, live_slots=L - 1).numpy()
    np.testing.assert_array_equal(_bits(dead[:L - 1]), _bits(full[:L - 1]))
    assert (_bits(dead[L - 1]) == 0).all()


@pytest.mark.parametrize("L", [2, 5, 17, 64])
@pytest.mark.parametrize("precision", ["f32", "bf16", "bf16x2"])
def test_plan_of_the_wave_slots_is_kept(L, precision):
    """The headline's K1 plans at nslots + 1 = 2, 5, 17 and 64 slots are
    the ones the row chunks (so the merge order, so the bits) came from
    before the dead slot was dropped at the load: 19 chunks of 55,296
    rows, one slot group."""
    p = hist_cuda.plan(1 << 20, 28, L, 64, precision)
    assert p == {"nb": 64, "nc": 6 if precision == "bf16x2" else 3,
                 "ls_max": L, "groups": 1, "n_chunks": 19,
                 "chunk_rows": 55296}
