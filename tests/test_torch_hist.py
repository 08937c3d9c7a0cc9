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
    the Pallas kernel make, checked on values that sit on a tie."""
    v = torch.tensor([[1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, -2.5, 0.1]],
                     dtype=torch.float32).T.repeat(1, 3)
    hi, lo = hist_cuda.split_parts(v, "bf16x2")
    assert hi[0, 0] == 1.0 and hi[1, 0] == 1.0 + 2 ** -6
    assert torch.equal((hi + lo)[:3], v[:3])      # 16 bits hold these
    assert float((hi + lo - v)[3].abs().max()) <= 0.1 * 2 ** -15
    assert torch.equal(hist_cuda.split_parts(v, "bf16")[0], hi)
    with pytest.raises(ValueError):
        hist_cuda.split_parts(v, "int8")


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
    with pytest.raises(ValueError):
        hist_cuda.hist_leaves(binned, g3, leaf, 2, 16, precision="int8")
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
    assert hist_cuda.plain_counts == {"hist_leaves": 1,
                                      "hist_leaves_scatter": 1}
    assert hist_cuda.launch_counts == {"hist_leaves": 0}
    assert hist_cuda.bucket_launch_counts == {}
    hist_cuda.reset_launch_counts()
    assert not any(hist_cuda.plain_counts.values())
