"""The one-launch split scan of the port — the split-scan kernel's scan and
pick, the fused round's pick kernel and the feature meta's kernel tables
— held against the JAX package's.

On the CPU ``scan_cuda.split_scan_pick`` and ``scan_cuda.split_pick`` run
their plain versions (``split_pick_ref``: ``pick_pack`` on
``scan_residue``; ``pick_ref``: ``pick_pack`` with ``gain_shift``); here
they are held to the JAX package's ``find_best_split`` (vmapped over the
children, XLA on the CPU) and ``_pick_pack`` on the same numpy inputs.
The CUDA kernels are held to the plain versions bit for bit on the card
by chip_smoke.py (phases 14, 31).

Tolerances:
* picks (feature, threshold bin, default direction): identical — the tie
  band (``TIE_RTOL``) absorbs the f32 summation order;
* gains: within ``4e-6 * (|gain| + |shift|) + 1e-6`` of the JAX value, as
  tests/test_torch_constraints.py; left and right sums within ``4e-6`` of
  the absolute mass they add, plus 1e-6 (the port's cumulative sum rounds
  each prefix of a double accumulation, XLA's adds in f32);
* the pick alone on one residue: picks and sums identical (the same f32
  ops on the same values), gains within the gain tolerance (each side
  computes its own shift);
* the plain versions against their compositions: bit for bit.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from lightgbmv1_tpu.ops import split as jsplit
from lightgbmv1_tpu.ops import wave_fused as jwf

from lightgbmv1_tpu_torch.config import Config
from lightgbmv1_tpu_torch.io.dataset import BinnedDataset
from lightgbmv1_tpu_torch.ops import scan_cuda
from lightgbmv1_tpu_torch.ops import split as tsplit
from lightgbmv1_tpu_torch.ops import wave_fused as twf

CPU = torch.device("cpu")

# the scan options of each case: (monotone, penalty, contri, smooth, mds)
OPTIONS = {
    "none": (False, 0.0, False, 0.0, 0.0),
    "monotone": (True, 0.0, False, 0.0, 0.0),
    "penalty": (True, 1.0, False, 0.0, 0.0),
    "contri": (False, 0.0, True, 0.0, 0.0),
    "smooth": (False, 0.0, False, 1.0, 0.0),
    "max_output": (False, 0.0, False, 0.0, 0.7),
    "all": (True, 1.0, True, 1.0, 0.7),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny tensors here gain nothing from torch's intra-op pool, and
    beside other pytest workers its spinning threads starve them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metas(F, B, opts, rng):
    """The same feature meta for both packages (the port's with its
    kernel tables): NaN-, zero- and none-missing features, a 2-bin
    feature, a narrower bin axis, and the option's monotone types and
    contri multipliers."""
    mono_on, _, contri_on, _, _ = opts
    mt = np.array([1, 2, 0, 0, 0] * -(-F // 5))[:F]
    nb = np.full(F, B)
    nb[3] = 2
    nb[4] = max(2, B - 5)
    nan_bin = np.where(mt == 2, nb - 1, -1)
    zero_bin = np.where(mt == 1, np.minimum(3, nb - 1), 0)
    mono = np.array([1, -1, 0, 1, -1, 0] * -(-F // 6))[:F] if mono_on \
        else np.zeros(F, np.int64)
    contri = (0.5 + rng.rand(F)).astype(np.float32) if contri_on else None
    j = jsplit.FeatureMeta(
        num_bins=jnp.asarray(nb, jnp.int32),
        missing_type=jnp.asarray(mt, jnp.int32),
        nan_bin=jnp.asarray(nan_bin, jnp.int32),
        zero_bin=jnp.asarray(zero_bin, jnp.int32),
        is_categorical=jnp.zeros(F, bool), usable=jnp.ones(F, bool),
        monotone_type=jnp.asarray(mono, jnp.int32),
        contri=None if contri is None else jnp.asarray(contri))
    t = tsplit.with_tables(tsplit.FeatureMeta(
        num_bins=torch.as_tensor(nb, dtype=torch.int64),
        missing_type=torch.as_tensor(mt, dtype=torch.int64),
        nan_bin=torch.as_tensor(nan_bin, dtype=torch.int64),
        zero_bin=torch.as_tensor(zero_bin, dtype=torch.int64),
        usable=torch.ones(F, dtype=torch.bool),
        monotone_type=(torch.as_tensor(mono, dtype=torch.int64)
                       if mono_on else None),
        contri=None if contri is None else torch.from_numpy(contri)))
    return j, t


def _params(opts):
    _, pen, _, smooth, mds = opts
    common = dict(lambda_l1=0.1, lambda_l2=0.5, min_data_in_leaf=5.0,
                  max_delta_step=mds, path_smooth=smooth)
    return (jsplit.SplitParams(**common),
            tsplit.SplitParams(**common, monotone_penalty=pen), pen)


def _children(seed, F, B, C, opts, scaled=False):
    """C children's histograms binned from the same rows (every feature
    sums to the child's totals), their sums, binding bounds around each
    child's output (NO_CONSTRAINT on every fourth), depths 1..8, parent
    outputs and a feature mask; the last child dead as a round's dead
    slot (mask off, sums 1.0).  ``scaled``: integer sums and (C, 3)
    power-of-two scales (int8sr)."""
    rng = np.random.RandomState(seed)
    jmeta, tmeta = _metas(F, B, opts, rng)
    nb = np.asarray(jmeta.num_bins)
    N = 400 * C
    binned = (rng.randint(0, 1 << 16, (F, N)) % nb[:, None]).astype(np.int64)
    g3 = np.stack([rng.randn(N) + 0.2, rng.rand(N) * 0.3 + 0.1, np.ones(N)],
                  axis=1).astype(np.float32)
    child = rng.randint(0, C, N)
    hist = np.zeros((C, F, B, 3), np.float64)
    absum = np.zeros((C, 3), np.float64)
    for f in range(F):
        np.add.at(hist, (child, f, binned[f]), g3)
    np.add.at(absum, child, np.abs(g3))
    csums = hist[:, 0].sum(axis=1).astype(np.float32)
    hist = hist.astype(np.float32)
    hsc = None
    if scaled:
        hsc = np.tile(np.float32([2.0 ** -4, 2.0 ** -7, 1.0]), (C, 1))
        hist = np.round(hist / hsc[:, None, None, :]).astype(np.float32)
    out = -csums[:, 0] / (csums[:, 1] + 0.5)
    constr = np.stack([out - 0.05, out + 0.05], axis=1).astype(np.float32)
    constr[::4] = jsplit.NO_CONSTRAINT
    mask = np.ones((C, F), bool)
    mask[1, 2] = False
    mask[-1] = False
    csums[-1] = 1.0
    return dict(hist=hist, hsc=hsc, csums=csums, constr=constr,
                depth=(np.arange(C) % 8 + 1).astype(np.int64),
                pout=(out * 0.8).astype(np.float32), mask=mask,
                absum=absum, jmeta=jmeta, tmeta=tmeta)


def _gain_tol(gain, shift):
    return 4e-6 * (np.abs(gain) + np.abs(shift)) + 1e-6


def _legs(d, tp):
    t = torch.from_numpy
    return tsplit.scan_inputs(d["tmeta"], tp, d["hist"].shape[0], CPU,
                              t(d["constr"]), t(d["depth"]), t(d["pout"]))


@pytest.mark.parametrize("F", [28, 27])
@pytest.mark.parametrize("scaled", [False, True], ids=["f32", "hist_scale"])
@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_split_pick_ref_matches_jax(case, scaled, F):
    """The split-scan kernel's plain version (``split_pick_ref``, the
    packed rows of one launch) against the JAX package's
    ``find_best_split`` vmapped over the children, with and without
    int8sr scales."""
    opts = OPTIONS[case]
    C, B = 4, 16
    d = _children(11 + F, F, B, C, opts, scaled)
    jp, tp, pen = _params(opts)
    t = torch.from_numpy
    hsc = None if d["hsc"] is None else t(d["hsc"])
    before = scan_cuda.plain_counts["split_scan"]
    packed = scan_cuda.split_scan_pick(
        t(d["hist"]), t(d["mask"]), t(d["csums"]), meta=d["tmeta"],
        params=tp, hist_scale=hsc, **_legs(d, tp))
    assert scan_cuda.plain_counts["split_scan"] == before + 1
    res = tsplit.unpack_children(packed, B)

    def one(h, s, m, cst, dep, po, hs):
        return jsplit.find_best_split(
            h, s, d["jmeta"], m, jp, constraint=cst, depth=dep,
            monotone_penalty=pen, parent_output=po,
            hist_scale=hs if scaled else None)

    j = jax.vmap(one)(*(jnp.asarray(d[k]) for k in (
        "hist", "csums", "mask", "constr", "depth", "pout")),
        jnp.asarray(d["hsc"] if scaled else np.ones((C, 3), np.float32)))
    np.testing.assert_array_equal(res.feature.numpy(), np.asarray(j.feature))
    np.testing.assert_array_equal(res.threshold_bin.numpy(),
                                  np.asarray(j.threshold_bin))
    np.testing.assert_array_equal(res.default_left.numpy(),
                                  np.asarray(j.default_left))
    jg = np.asarray(j.gain)
    fin = np.isfinite(jg)
    np.testing.assert_array_equal(torch.isfinite(res.gain).numpy(), fin)
    shift = np.asarray(jax.vmap(lambda s, po: jsplit.gain_shift(s, po, jp))(
        jnp.asarray(d["csums"]), jnp.asarray(d["pout"])))
    assert (np.abs(res.gain.numpy()[fin] - jg[fin])
            <= _gain_tol(jg[fin], shift[fin])).all()
    tol = 4e-6 * d["absum"][fin] + 1e-6
    for got, want in ((res.left_sum, j.left_sum),
                      (res.right_sum, j.right_sum)):
        assert (np.abs(got.numpy()[fin] - np.asarray(want)[fin])
                <= tol).all()
    fin = int(fin.sum())
    assert fin >= C // 2


@pytest.mark.parametrize("F", [28, 27])
@pytest.mark.parametrize("case", ["none", "smooth", "max_output", "all"])
def test_split_pick_plain_matches_jax_pick_pack(case, F):
    """The fused round's pick (``scan_cuda.split_pick``, its plain version
    on the CPU) against the JAX package's ``_pick_pack`` on the same
    residue: a K2 round's, the JAX package's in-kernel scan
    (``child_scan_residue``) of the round's children, a dead child
    among them."""
    opts = OPTIONS[case]
    C, B = 6, 16
    d = _children(31 + F, F, B, C, opts)
    jp, tp, pen = _params(opts)
    residue = np.stack([np.asarray(jwf.child_scan_residue(
        jnp.asarray(d["hist"][c]), jnp.asarray(d["mask"][c]),
        jnp.asarray(d["csums"][c]), jnp.asarray(d["constr"][c]),
        jnp.asarray(d["depth"][c], jnp.int32), jnp.asarray(d["pout"][c]),
        jnp.ones(3, jnp.float32), meta_blk=d["jmeta"], params=jp,
        use_mc=opts[0], monotone_penalty=pen, child_scale=False,
        num_bins=B, fblk=F)) for c in range(C)]).astype(np.float32)
    t = torch.from_numpy
    legs = _legs(d, tp)
    before = scan_cuda.plain_counts["split_pick"]
    got = scan_cuda.split_pick(
        t(residue), t(d["csums"]), meta=d["tmeta"], params=tp,
        parent_output=legs["parent_output"], num_bins=B).numpy()
    assert scan_cuda.plain_counts["split_pick"] == before + 1
    for c in range(C):
        shift = jsplit.gain_shift(jnp.asarray(d["csums"][c]),
                                  float(d["pout"][c]), jp)
        want = np.asarray(jwf._pick_pack(
            jnp.asarray(residue[c]), shift, jnp.asarray(d["csums"][c]),
            d["jmeta"], B))
        np.testing.assert_array_equal(got[c, 1:], want[1:])
        assert np.isfinite(got[c, 0]) == np.isfinite(want[0])
        if np.isfinite(want[0]):
            assert abs(got[c, 0] - want[0]) <= _gain_tol(want[0],
                                                        float(shift))
        else:
            assert got[c, 0] == want[0] == -np.inf
    assert got[-1, 0] == -np.inf            # the dead child splits nothing


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_split_pick_ref_is_the_staged_composition(case):
    """``split_pick_ref`` is ``pick_pack`` on ``scan_residue`` with the
    children's ``gain_shift``, bit for bit, and ``find_best_split`` on a
    CPU tensor unpacks exactly those rows."""
    opts = OPTIONS[case]
    d = _children(5, 9, 16, 6, opts)
    _, tp, _ = _params(opts)
    t = torch.from_numpy
    legs = _legs(d, tp)
    args = (t(d["hist"]), t(d["mask"]), t(d["csums"]))
    got = scan_cuda.split_pick_ref(*args, meta=d["tmeta"], params=tp,
                                   **legs)
    res = tsplit.scan_residue(*args, meta=d["tmeta"], params=tp, **legs)
    want = tsplit.pick_pack(res, tsplit.gain_shift(
        args[2], tp, legs["parent_output"]), args[2], d["tmeta"], 16)
    assert torch.equal(got, want)
    fb = tsplit.find_best_split(
        args[0], args[2], d["tmeta"], args[1], tp,
        constraint=t(d["constr"]), depth=t(d["depth"]),
        parent_output=t(d["pout"]))
    assert torch.equal(twf.pack_children(fb), want)


@pytest.mark.parametrize("case", ["monotone", "smooth", "all"])
def test_absent_legs_are_the_kernel_defaults(case):
    """No bounds are ``NO_CONSTRAINT`` and no parent outputs 0, bit for
    bit: what the kernels read for a null pointer, and what
    ``scan_inputs`` leaves None (``find_best_split`` at the root)."""
    opts = OPTIONS[case]
    d = _children(8, 7, 16, 5, opts)
    _, tp, _ = _params(opts)
    t = torch.from_numpy
    legs = _legs(d, tp)
    args = (t(d["hist"]), t(d["mask"]), t(d["csums"]))
    got = scan_cuda.split_pick_ref(*args, meta=d["tmeta"], params=tp,
                                   **dict(legs, constraint=None,
                                          parent_output=None))
    full = dict(legs, constraint=torch.tensor(
        tsplit.NO_CONSTRAINT, dtype=torch.float32).repeat(5, 1),
        parent_output=torch.zeros(5, dtype=torch.float32))
    if not opts[0]:
        full["constraint"] = None
    if opts[3] <= 0:
        full["parent_output"] = None
    want = scan_cuda.split_pick_ref(*args, meta=d["tmeta"], params=tp,
                                    **full)
    assert torch.equal(got, want)
    absent = tsplit.scan_inputs(d["tmeta"], tp, 5, CPU, depth=t(d["depth"]))
    assert absent["constraint"] is None and absent["parent_output"] is None
    assert (absent["pfac"] is None) == (legs["pfac"] is None)


class _AtenOps(TorchDispatchMode):
    """Counts the aten ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_scan_args_run_no_aten_op(case):
    """The split-scan wrapper's argument assembly (``scan_args``: checks,
    the meta's tables, the legs' pointers) dispatches no aten op, so the
    launch is the first op of an unconstrained ``find_best_split``
    (``scan_inputs`` runs none there either); a meta without its tables
    is refused."""
    opts = OPTIONS[case]
    d = _children(9, 6, 16, 4, opts)
    _, tp, _ = _params(opts)
    t = torch.from_numpy
    args = (t(d["hist"]), t(d["mask"]), t(d["csums"]))
    legs = _legs(d, tp)
    with _AtenOps() as mode:
        assert tsplit.scan_inputs(d["tmeta"], tp._replace(
            monotone_penalty=0.0), 4, CPU) == dict(
                constraint=None, pfac=None, parent_output=None)
    assert mode.ops == []
    with _AtenOps() as mode:
        opts_bits, head, tail = scan_cuda.scan_args(
            *args, meta=d["tmeta"], params=tp, **legs)
    assert mode.ops == []
    assert opts_bits == scan_cuda.scan_options(d["tmeta"], tp)
    assert head[0] == args[0].data_ptr() and len(head) == 10
    assert tail[:4] == (4, 6, 16, 6) and tail[-1] == opts_bits
    row = torch.ones(6, dtype=torch.bool)
    expanded = row[None, :].expand(4, 6)      # node_feature_masks' view
    with _AtenOps() as mode:
        _, head, tail = scan_cuda.scan_args(
            args[0], expanded, args[2], meta=d["tmeta"], params=tp, **legs)
    assert mode.ops == []
    assert head[3] == row.data_ptr() and tail[3] == 0
    assert scan_cuda.scan_args(*args, meta=d["tmeta"], params=tp,
                               **legs)[2][3] == 6
    with pytest.raises(ValueError, match="meta.table"):
        scan_cuda.scan_args(*args, meta=d["tmeta"]._replace(table=None),
                            params=tp, **legs)
    if opts[0]:
        with pytest.raises(ValueError, match="meta.mono32"):
            scan_cuda.scan_args(*args, meta=d["tmeta"]._replace(mono32=None),
                                params=tp, **legs)


@pytest.mark.parametrize("C,F,B,ok", [
    (2, 10_000, 16, True),       # a residue past the block's shared memory
    (1, 1, 256, True), (3, 28, 257, False), (0, 28, 16, False),
    (2, 0, 16, False)])
def test_scan_args_checks_shapes(C, F, B, ok):
    """``scan_args`` takes any feature count (a residue too large for a
    block's shared memory goes through global memory) and refuses more
    than 256 bins, no child or no feature."""
    meta = tsplit.with_tables(tsplit.FeatureMeta(
        num_bins=torch.full((F,), B, dtype=torch.int64),
        missing_type=torch.zeros(F, dtype=torch.int64),
        nan_bin=torch.full((F,), -1, dtype=torch.int64),
        zero_bin=torch.zeros(F, dtype=torch.int64),
        usable=torch.ones(F, dtype=torch.bool)))
    args = (torch.zeros((C, F, B, 3)), torch.ones((C, F), dtype=torch.bool),
            torch.ones((C, 3)))
    if ok:
        _, _, tail = scan_cuda.scan_args(*args, meta=meta,
                                         params=tsplit.SplitParams())
        assert tail[:3] == (C, F, B)
    else:
        with pytest.raises(ValueError, match="256 bins"):
            scan_cuda.scan_args(*args, meta=meta,
                                params=tsplit.SplitParams())


@pytest.mark.parametrize("mono,contri", [
    ([1, -1], [0.5, 1.0, 2.0]), ([0, 0], []), ([1, 0, 0, 0, 0, -1, 1], [])])
def test_feature_meta_tables(mono, contri):
    """``make_feature_meta`` fills the kernels' tables once: ``table`` is
    the stacked int32 rows [num_bins, missing_type, nan_bin, zero_bin,
    usable] of the meta (``feature_table``) and ``mono32`` its monotone
    types as int32 (None without a constraint)."""
    X = np.random.RandomState(7).randn(500, 5)
    X[::7, 1] = np.nan
    X[::5, 2] = 0.0
    tds = BinnedDataset.from_numpy(X, config=Config.from_dict(
        {"max_bin": 15, "enable_bundle": False}))
    meta = tsplit.make_feature_meta(tds, CPU, mono, contri)
    assert torch.equal(meta.table, tsplit.feature_table(meta))
    assert meta.table.tolist() == [
        np.asarray(a, np.int64).tolist() for a in (
            tds.num_bins, tds.missing_types, tds.nan_bins, tds.zero_bins,
            ~np.asarray(tds.is_trivial))]
    assert meta.table.dtype == torch.int32 and meta.table.is_contiguous()
    assert meta.table.shape == (5, 5)
    if any(mono):
        assert meta.mono32.dtype == torch.int32
        assert torch.equal(meta.mono32,
                           meta.monotone_type.to(torch.int32))
    else:
        assert meta.mono32 is None and meta.monotone_type is None
