"""The port's model text and host trees against the JAX package.

Every reference golden model in tests/data loads into the port with
``HostTree`` fields equal to the JAX package's, writes back byte-identical
text, and the port's numpy walk reproduces the reference C++ predictions
to the tolerances tests/test_golden_compat.py uses.
"""

import glob
import os

import numpy as np
import pytest

from lightgbmv1_tpu.io import model_text as jax_mt
from lightgbmv1_tpu.io.parser import load_data_file

import chip_smoke
from lightgbmv1_tpu_torch import Booster
from lightgbmv1_tpu_torch.io import model_text as port_mt
from lightgbmv1_tpu_torch.models.tree import (HostTree, host_tree_depth,
                                              validate_host_tree)

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_MODELS = sorted(os.path.basename(p) for p in
                       glob.glob(os.path.join(DATA, "golden_*_model.txt")))

# golden model -> (rows file, label column to strip, rtol, atol) as in
# tests/test_golden_compat.py
GOLDEN_PREDS = {
    "golden_ref_model.txt": ("golden_binary.tsv", 1e-6, 1e-7),
    "golden_multiclass_model.txt": ("multiclass.train", 1e-9, 1e-12),
    "golden_regression_model.txt": ("regression.train", 1e-9, 1e-12),
    "golden_lambdarank_model.txt": ("rank.train", 1e-9, 1e-12),
    "golden_mds_model.txt": ("golden_binary.tsv", 1e-4, 2e-5),
    "golden_zero_model.txt": ("golden_zero_train.tsv", 1e-4, 2e-5),
}


def _read(name):
    with open(os.path.join(DATA, name)) as fh:
        return fh.read()


def _rows(name):
    if name.endswith(".tsv"):
        return np.loadtxt(os.path.join(DATA, name))[:, 1:]
    return load_data_file(os.path.join(DATA, name)).X


def _assert_same_tree(tp, tj):
    assert tp.num_leaves == tj.num_leaves
    assert tp.shrinkage == tj.shrinkage
    for name in HostTree.FIELDS + ["is_cat", "cat_bitset"]:
        a, b = getattr(tp, name), np.asarray(getattr(tj, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(tp.cat_sets) == len(tj.cat_sets)
    for a, b in zip(tp.cat_sets, tj.cat_sets):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_golden_models_present():
    assert len(GOLDEN_MODELS) >= 7


@pytest.mark.parametrize("name", GOLDEN_MODELS)
def test_golden_model_loads_like_jax(name):
    text = _read(name)
    mp, mj = port_mt.model_from_string(text), jax_mt.model_from_string(text)
    for attr in ("objective", "objective_params", "num_class",
                 "num_tree_per_iteration", "label_index", "max_feature_idx",
                 "feature_names", "feature_infos", "average_output",
                 "parameters"):
        assert getattr(mp, attr) == getattr(mj, attr), attr
    assert len(mp.trees) == len(mj.trees) > 0
    for tp, tj in zip(mp.trees, mj.trees):
        _assert_same_tree(tp, tj)


@pytest.mark.parametrize("name", GOLDEN_MODELS)
def test_model_to_string_byte_identical(name):
    text = _read(name)
    mp, mj = port_mt.model_from_string(text), jax_mt.model_from_string(text)
    kw = dict(objective_string=" ".join(
        [mj.objective] + [f"{k}:{v}" for k, v in mj.objective_params.items()]),
        num_class=mj.num_class,
        num_tree_per_iteration=mj.num_tree_per_iteration,
        feature_names=mj.feature_names, feature_infos=mj.feature_infos,
        average_output=mj.average_output, parameters=mj.parameters)
    out_p = port_mt.model_to_string(mp.trees, **kw)
    assert out_p == jax_mt.model_to_string(mj.trees, **kw)
    # and the port reads its own text back as the JAX package does
    for a, b in zip(port_mt.model_from_string(out_p).trees,
                    jax_mt.model_from_string(out_p).trees):
        _assert_same_tree(a, b)


@pytest.mark.parametrize("name", sorted(GOLDEN_PREDS))
def test_host_walk_reproduces_reference_predictions(name):
    rows, rtol, atol = GOLDEN_PREDS[name]
    X = _rows(rows)
    ref = np.loadtxt(os.path.join(DATA, name.replace("_model", "_pred")))
    got = Booster(model_file=os.path.join(DATA, name), device="cpu").predict(X)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def test_validate_host_tree_rejects_malformed():
    class T:
        pass

    t = T()
    t.num_leaves = 3
    t.left_child = np.array([1, -1], np.int32)
    t.right_child = np.array([-2, -3], np.int32)
    validate_host_tree(t)                        # proper 3-leaf tree
    assert host_tree_depth(t) == 2
    t.left_child = np.array([1, 0], np.int32)    # cycle
    with pytest.raises(ValueError, match="cyclic|twice"):
        validate_host_tree(t)
    t.left_child = np.array([1, -9], np.int32)   # leaf out of range
    with pytest.raises(ValueError, match="out of range"):
        validate_host_tree(t)


def test_malformed_model_text_fails_the_load():
    from lightgbmv1_tpu_torch.utils.log import LightGBMError

    text = _read("golden_regression_model.txt")
    bad = text.replace("left_child=1 ", "left_child=0 ", 1)
    assert bad != text
    with pytest.raises(LightGBMError, match="Invalid model file"):
        port_mt.model_from_string(bad)


def test_synthetic_smoke_model_loads_in_both_packages():
    """The generator chip_smoke.py drives the card with: its text loads in
    the JAX package with the same trees and the same host predictions."""
    text, trees = chip_smoke.make_model(3, n_trees=6, n_leaves=31, n_grid=9)
    mj = jax_mt.model_from_string(text)
    for tp, tj in zip(port_mt.model_from_string(text).trees, mj.trees):
        _assert_same_tree(tp, tj)
    X = chip_smoke.make_rows(np.random.RandomState(4), 200)
    for tp, tj in zip(trees, mj.trees):
        np.testing.assert_array_equal(tp.predict_leaf_index(X),
                                      tj.predict_leaf_index(X))
