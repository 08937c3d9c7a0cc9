"""The port's fault seams that the fleet and the trainer give a site,
against the JAX package's, on the CPU (JAX utils/faults.py,
models/gbdt.py ``_guard_grads``, serve/router.py ``_attempt``).

* ``grad_poison``: the same ``FaultSpec("grad_poison", payload=2)`` armed
  around each package's trainer build puts NaN on every 13th row's
  gradient and hessian at iteration 2: under ``finite_guard=clamp`` both
  train the same trees (every split, leaves within 2e-5), under
  ``raise`` both stop at the same boundary with ``FiniteGuardError``,
  and ``peek`` counts no event.
* ``rpc_drop`` fires at the router, site = the replica's name, and the
  request retries onto another replica in both packages.
* A ``peer_dead`` plan (elastic training, no site in the port) raises
  from ``activate``, ``inject`` and ``LGBMV1_FAULTS``, naming the
  parallel learners' item.
* The module docstring's table lists exactly the kinds the package
  fires.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbmv1_tpu as lj
from lightgbmv1_tpu import serve as jserve
from lightgbmv1_tpu.models import gbdt as jgbdt
from lightgbmv1_tpu.utils import faults as jfaults

import lightgbmv1_tpu_torch as lt
from lightgbmv1_tpu_torch import config as tconfig
from lightgbmv1_tpu_torch import serve as tserve
from lightgbmv1_tpu_torch.models import gbdt as tgbdt
from lightgbmv1_tpu_torch.utils import faults as tfaults

from conftest import make_binary_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
          "learning_rate": 0.1, "verbosity": -1, "max_bin": 63,
          "hist_dtype": "f32"}
POISON_AT = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_trees(jtrees, ttrees, atol=2e-5):
    assert len(jtrees) == len(ttrees)
    for jt, tt in zip(jtrees, ttrees):
        n = tt.num_leaves
        assert n == jt.num_leaves
        for f in ("split_feature", "threshold_bin", "default_left",
                  "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(tt, f)[:n - 1],
                                          getattr(jt, f)[:n - 1])
        np.testing.assert_allclose(tt.leaf_value[:n], jt.leaf_value[:n],
                                   rtol=0, atol=atol)


def _poisoned(tag, mode, X, y):
    """Each package's Booster built under the same armed plan; the plan
    stays armed while it trains up to 5 iterations.  Returns (iterations
    done, raised, the plan's fired events, the Booster)."""
    faults = tfaults if tag == "t" else jfaults
    err = tgbdt.FiniteGuardError if tag == "t" else jgbdt.FiniteGuardError
    p = dict(PARAMS, finite_guard=mode)
    with faults.inject(faults.FaultSpec("grad_poison",
                                        payload=POISON_AT)) as plan:
        assert faults.grad_poison_iteration() == POISON_AT
        b = (lt.Booster(p, train_set=lt.Dataset(X, label=y), device="cpu")
             if tag == "t" else lj.Booster(p, train_set=lj.Dataset(X,
                                                                   label=y)))
        done, raised = 0, False
        for _ in range(5):
            try:
                b.update()
            except err:
                raised = True
                break
            done += 1
    assert faults.grad_poison_iteration() is None
    return done, raised, list(plan.fired), b


@pytest.mark.parametrize("mode", ["clamp", "raise"])
def test_grad_poison_matches_jax(mode):
    """The poison fires at the JAX package's iteration and rows: the
    same trees under clamp, the same boundary under raise; ``peek``
    records no event in either package."""
    X, y = make_binary_problem(1500, 6, seed=9)
    tdone, traised, tfired, tb = _poisoned("t", mode, X, y)
    jdone, jraised, jfired, jb = _poisoned("j", mode, X, y)
    assert (tdone, traised, tfired) == (jdone, jraised, jfired)
    assert tfired == []
    if mode == "raise":
        assert traised and tdone == POISON_AT
    else:
        assert not traised and tdone == 5
        assert np.isfinite(tb._gbdt.raw_train_scores()).all()
        # the poisoned rows weigh nothing in iteration 2's tree
        _same_trees(jb._all_trees(), tb._all_trees())


def test_grad_poison_changes_the_poisoned_tree():
    """Under clamp the poisoned iteration's tree differs from an
    unpoisoned run's while the trees before it do not: the seam fires."""
    X, y = make_binary_problem(1500, 6, seed=9)
    _, _, _, tb = _poisoned("t", "clamp", X, y)
    clean = lt.Booster(dict(PARAMS, finite_guard="clamp"),
                       train_set=lt.Dataset(X, label=y), device="cpu")
    for _ in range(5):
        clean.update()
    poisoned, plain = tb._all_trees(), clean._all_trees()
    for i in range(POISON_AT):
        np.testing.assert_array_equal(poisoned[i].leaf_value,
                                      plain[i].leaf_value)
    assert not np.array_equal(poisoned[POISON_AT].leaf_value,
                              plain[POISON_AT].leaf_value)


def test_rpc_drop_retries_onto_another_replica():
    """An ``rpc_drop`` plan matching r0 drops the router's link to it:
    the request retries onto r1 and is answered, in both packages, with
    the same fired events and the same answer."""
    X, y = make_binary_problem(600, 6, seed=2)
    text = lt.train({"objective": "binary", "num_leaves": 7,
                     "verbosity": -1}, lt.Dataset(X, label=y), 3,
                    device="cpu").model_to_string()
    out = {}
    for tag, serve, faults in (("t", tserve, tfaults),
                               ("j", jserve, jfaults)):
        b = (lt.Booster(model_str=text, device="cpu") if tag == "t"
             else lj.Booster(model_str=text))
        kw = {"device": "cpu"} if tag == "t" else {}
        cfg = serve.ServeConfig(max_batch_rows=64, max_batch_delay_ms=1.0,
                                f64_scores=True,
                                predictor_kwargs={"bucket_min": 64})
        with serve.Fleet(b, n_replicas=2, config=cfg, **kw) as fleet:
            with serve.Router(fleet, serve.RouterConfig(
                    health_period_ms=5000.0, retry_max=1)) as router:
                with faults.inject(faults.FaultSpec(
                        "rpc_drop", match="r0")) as plan:
                    res = router.submit(X[:5])
                snap = router.metrics_snapshot()
        out[tag] = (res.values, res.version, plan.fired, snap["retries"],
                    snap["errors"])
    tv, *trest = out["t"]
    jv, *jrest = out["j"]
    assert np.array_equal(tv, jv) and trest == jrest
    assert trest == ["v1", [("rpc_drop", "r0", "raise")], 1, 0]


@pytest.mark.parametrize("how", ["activate", "inject"])
def test_peer_dead_plan_raises_naming_parallel(how):
    spec = tfaults.FaultSpec("peer_dead", mode="kill", match="rank1")
    try:
        with pytest.raises(NotImplementedError,
                           match=re.escape(f"ROADMAP queue 1, "
                                           f"{tconfig.PARALLEL}") + "$"):
            if how == "activate":
                tfaults.activate(tfaults.FaultPlan(
                    [tfaults.FaultSpec("h2d"), spec]))
            else:
                with tfaults.inject(spec):
                    pass
        assert not tfaults.active()
    finally:
        tfaults.deactivate()


def test_peer_dead_plan_from_the_environment_raises():
    """``LGBMV1_FAULTS`` arms its plan at import: a peer_dead plan
    stops the import, naming the item."""
    env = dict(os.environ, LGBMV1_FAULTS='[{"kind": "peer_dead"}]',
               PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", "import lightgbmv1_tpu_torch.utils.faults"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert f"ROADMAP queue 1, {tconfig.PARALLEL}" in proc.stderr


def test_docstring_table_lists_the_fired_kinds():
    """Every kind the package fires (``faults.fire("<kind>"``, and the
    ``grad_poison`` peek) has a row in the table, and every row names a
    kind the package fires."""
    pkg = os.path.join(REPO, "lightgbmv1_tpu_torch")
    fired = set()
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py") and name != "faults.py":
                src = open(os.path.join(root, name)).read()
                fired |= set(re.findall(
                    r'faults\.fire\(\s*"([a-z_]+)"', src))
                if "faults.grad_poison_iteration()" in src:
                    fired.add("grad_poison")
    doc = tfaults.__doc__
    table = doc[doc.index("====="):doc.rindex("=====")]
    rows = set(re.findall(r"^``([a-z_]+)``", table, re.MULTILINE))
    assert rows == fired
    assert "peer_dead" not in rows and "peer_dead" in tfaults._UNPORTED_KINDS
