"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the card (and raise without one), and
chip_smoke.py refuses to report success off the card."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lightgbmv1_tpu_torch")
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_zero_model.txt")

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:\.*)(?:jax|jaxlib|lightgbmv1_tpu)\b",
    re.MULTILINE)


def _env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT,
                OMP_NUM_THREADS="1")


def test_runtime_never_imports_jax():
    code = (
        "import sys, numpy as np\n"
        "from lightgbmv1_tpu_torch import Booster\n"
        "from lightgbmv1_tpu_torch.serve import Server, ServeConfig\n"
        f"b = Booster(model_file={GOLDEN!r}, device='cpu')\n"
        "X = np.random.RandomState(0).randn(40, b.num_feature())\n"
        "for m in ('fused', 'pallas', 'depthwise', 'auto'):\n"
        "    b.predict(X, predict_method=m)\n"
        "with Server(b, ServeConfig(predictor_kwargs={'method': 'fused'}),\n"
        "            device='cpu') as s:\n"
        "    assert s.submit(X[:3]).version == 'v1'\n"
        "    from lightgbmv1_tpu_torch.serve import ServeHTTP, TenantRegistry\n"
        "    from lightgbmv1_tpu_torch import obs, cli\n"
        "    TenantRegistry(s).add_manifest('acme:2')\n"
        "    h = ServeHTTP(s).start(); h.shutdown()\n"
        "from lightgbmv1_tpu_torch import Dataset, train\n"
        "y = (X[:, 0] > 0).astype(float)\n"
        "t = train({'objective': 'binary', 'num_leaves': 8, 'verbosity': -1},\n"
        "          Dataset(X, label=y), 2, device='cpu')\n"
        "assert t.num_trees() == 2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'lightgbmv1_tpu')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_callbacks_and_cv_never_import_jax():
    """The port's callbacks (its own copy of callback.py), early stopping
    and cv run without JAX or the JAX package in the process."""
    code = (
        "import sys, numpy as np\n"
        "from lightgbmv1_tpu_torch import Dataset, callback, cv, train\n"
        "rng = np.random.RandomState(0)\n"
        "X = rng.randn(600, 4); y = (X[:, 0] + rng.randn(600) > 0) * 1.0\n"
        "p = {'objective': 'binary', 'num_leaves': 4, 'verbosity': -1,\n"
        "     'learning_rate': 0.5}\n"
        "ev = {}\n"
        "b = train(p, Dataset(X[:400], label=y[:400]), 30,\n"
        "          valid_sets=[Dataset(X[400:], label=y[400:])],\n"
        "          early_stopping_rounds=2, device='cpu',\n"
        "          callbacks=[callback.record_evaluation(ev),\n"
        "                     callback.reset_parameter(\n"
        "                         learning_rate=lambda i: 0.5 * 0.9 ** i)])\n"
        "assert b.best_iteration > 0 and ev['valid_0']\n"
        "r = cv(p, Dataset(X, label=y), 3, nfold=2, device='cpu')\n"
        "assert len(r['binary_logloss-mean']) == 3\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'lightgbmv1_tpu')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_sources_import_neither_jax_nor_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path) as fh:
            hits = _FORBIDDEN.findall(fh.read())
        assert not hits, f"{path}: {hits}"
    # the pattern itself catches every spelling it must
    for line in ("import jax", "from jax import numpy", "import jaxlib",
                 "from lightgbmv1_tpu.io import x", "import lightgbmv1_tpu",
                 "from ..lightgbmv1_tpu import x"):
        assert _FORBIDDEN.search(line), line
    assert not _FORBIDDEN.search("from lightgbmv1_tpu_torch import Booster")


def test_parallel_modules_import_no_jax():
    """The parallel learners' modules are among the scanned sources, and
    a two-rank-free import and a group-of-one training through them leave
    no JAX module in the process."""
    scanned = set()
    for d, _, names in os.walk(PKG):
        scanned |= {os.path.relpath(os.path.join(d, n), PKG) for n in names}
    for mod in ("collectives", "cluster", "dist_data", "trainer"):
        assert os.path.join("parallel", mod + ".py") in scanned
    code = (
        "import sys, numpy as np\n"
        "from lightgbmv1_tpu_torch.parallel import (cluster, collectives,\n"
        "                                           dist_data, trainer)\n"
        "from lightgbmv1_tpu_torch import Dataset, train\n"
        "X = np.random.RandomState(0).randn(200, 4)\n"
        "y = (X[:, 0] > 0).astype(float)\n"
        "for learner in ('data', 'voting', 'feature'):\n"
        "    train({'objective': 'binary', 'tree_learner': learner,\n"
        "           'verbosity': -1}, Dataset(X, label=y), 1, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'lightgbmv1_tpu')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    import numpy as np

    from lightgbmv1_tpu_torch import Booster, Dataset, resolve_device, train
    from lightgbmv1_tpu_torch.serve import Server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Booster(model_file=GOLDEN)
    rng = np.random.RandomState(0)
    X, y = rng.randn(200, 4), (rng.rand(200) < 0.5).astype(float)
    params = {"objective": "binary", "num_leaves": 8, "verbosity": -1}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(params, Dataset(X, label=y), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Booster(params, train_set=Dataset(X, label=y))
    assert train(params, Dataset(X, label=y), 2, device="cpu").num_trees() \
        == 2
    with pytest.raises(RuntimeError, match="is_available"):
        Server()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_fails_off_the_card(tmp_path):
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone in a directory, without the package, it fails as well
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
