"""The port's CLI against the JAX package's, in process, on the CPU.

``lightgbmv1_tpu_torch.cli.main([...])`` with ``device_type=cpu`` beside
``lightgbmv1_tpu.cli.main`` on the same files (JAX tests/test_cli.py):
``task=train`` (every split identical, leaves within 2e-5, the port's
training tolerance), ``task=predict`` (the output files within the
serving tolerance, the contributions within 1e-12), ``task=convert_model``
(the C++ byte for byte, and compiled it scores as ``predict``),
``task=refit`` (leaves within 2e-5), ``config=<file>``, snapshots with a
bit-exact resume, ``save_binary=true`` and the ``.bin`` cache read by
either package, ``python -m lightgbmv1_tpu_torch``; ``obs_trace`` /
``trace_out`` on ``task=train`` (the iteration spans the JAX CLI writes)
and ``task=serve`` answering over HTTP (tests/test_torch_http.py holds
the serving surface to the JAX package's); the parallel learners (also
beside ``task=save_binary`` and ``stream_enable``, which run) and
row-sharded predict refused naming their items, and the fleet's and
observability's knobs accepted (``task=save_binary`` and streamed
training: tests/test_torch_block_cache.py).
"""

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from lightgbmv1_tpu import Booster as JBooster
from lightgbmv1_tpu import Dataset as JDataset
from lightgbmv1_tpu import cli as jcli

from lightgbmv1_tpu_torch import Booster, Dataset, train
from lightgbmv1_tpu_torch import cli
from lightgbmv1_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["objective=binary", "num_leaves=7", "min_data_in_leaf=20",
         "hist_dtype=f32", "max_bin=63", "num_trees=5", "verbosity=-1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(tmp_path, name="train.tsv", n=600, seed=0, cat=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    if cat:
        X[:, 4] = np.floor(np.abs(rng.randn(n)) * 3)
    logit = X[:, 0] - X[:, 1] + (3.0 * (np.isin(X[:, 4], [0, 2]) - 0.5)
                                 if cat else 0.0)
    y = (logit + rng.randn(n) * 0.3 > 0).astype(float)
    path = tmp_path / name
    np.savetxt(path, np.column_stack([y, X]), fmt="%.7g", delimiter="\t")
    return str(path)


def _port(args):
    return cli.main(list(args) + ["device_type=cpu"])


def _both(args, tmp_path, name):
    """Run both CLIs with ``output_model`` / ``output_result`` under
    ``name``; returns the port's and the JAX package's paths."""
    out = []
    for tag, run in (("t", _port), ("j", jcli.main)):
        path = str(tmp_path / f"{name}_{tag}.txt")
        key = "output_result" if "task=predict" in args else "output_model"
        assert run(list(args) + [f"{key}={path}"]) == 0
        out.append(path)
    return out


def _same_models(tpath, jpath, atol=2e-5):
    tt = Booster(model_file=tpath, device="cpu")._all_trees()
    jt = JBooster(model_file=jpath)._all_trees()
    assert len(tt) == len(jt) > 0
    for a, b in zip(tt, jt):
        n = a.num_leaves
        assert n == b.num_leaves
        for f in ("split_feature", "default_left", "left_child",
                  "right_child"):
            np.testing.assert_array_equal(getattr(a, f)[:n - 1],
                                          getattr(b, f)[:n - 1])
        np.testing.assert_allclose(a.threshold[:n - 1], b.threshold[:n - 1],
                                   rtol=0, atol=0)
        np.testing.assert_allclose(a.leaf_value[:n], b.leaf_value[:n],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("cat", [False, True], ids=["numeric",
                                                    "categorical"])
def test_train_matches_jax(cat, tmp_path):
    data = _write(tmp_path, cat=cat)
    valid = _write(tmp_path, "valid.tsv", n=300, seed=1, cat=cat)
    args = [f"data={data}", f"valid={valid}", "metric=auc", *TRAIN]
    if cat:
        args.append("categorical_feature=4")
    tpath, jpath = _both(args, tmp_path, "model")
    _same_models(tpath, jpath)
    if cat:
        assert any(t.is_cat[:t.num_leaves - 1].any() for t in Booster(
            model_file=tpath, device="cpu")._all_trees())


@pytest.fixture
def model(tmp_path):
    data = _write(tmp_path)
    path = str(tmp_path / "model.txt")
    assert _port([f"data={data}", f"output_model={path}", *TRAIN]) == 0
    return data, path


@pytest.mark.parametrize("extra", [
    [], ["predict_raw_score=true"], ["predict_leaf_index=true"],
    ["predict_contrib=true"], ["pred_early_stop=true",
                               "pred_early_stop_freq=1",
                               "pred_early_stop_margin=0.5"],
    ["predict_method=native", "num_iteration_predict=3"],
    ["predict_method=pallas", "start_iteration_predict=1"]],
    ids=["plain", "raw", "leaf", "contrib", "early_stop", "native",
         "device"])
def test_predict_matches_jax(extra, model, tmp_path):
    data, path = model
    tres, jres = _both(["task=predict", f"data={data}",
                        f"input_model={path}", *extra], tmp_path, "pred")
    got, want = np.loadtxt(tres), np.loadtxt(jres)
    assert got.shape == want.shape and got.shape[0] == 600
    trees = Booster(model_file=path, device="cpu")._all_trees()
    tol = 1e-6 * sum(float(np.abs(t.leaf_value).max())
                     for t in trees) + 1e-7
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if extra[:1] in (["predict_leaf_index=true"], ["predict_contrib=true"],
                     ["predict_raw_score=true"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cat", [False, True], ids=["numeric",
                                                    "categorical"])
def test_convert_model_matches_jax(cat, tmp_path):
    """The generated C++ is the JAX package's byte for byte; compiled
    beside a ``main`` it scores rows within 1e-12 of the port's raw
    predictions (JAX tests/test_cli.py:125)."""
    data = _write(tmp_path, cat=cat)
    path = str(tmp_path / "model.txt")
    args = [f"data={data}", f"output_model={path}", *TRAIN]
    assert _port(args + (["categorical_feature=4"] if cat else [])) == 0
    assert cat == any(t.is_cat[:t.num_leaves - 1].any() for t in Booster(
        model_file=path, device="cpu")._all_trees())
    cpp = []
    for tag, run in (("t", _port), ("j", jcli.main)):
        out = str(tmp_path / f"model_{tag}.cpp")
        assert run(["task=convert_model", f"input_model={path}",
                    f"convert_model={out}"]) == 0
        cpp.append(open(out).read())
    assert cpp[0] == cpp[1]
    X = np.loadtxt(data)[:50, 1:]
    main_cpp = tmp_path / "main.cpp"
    main_cpp.write_text(
        "#include <cstdio>\nvoid PredictRaw(const double*, double*);\n"
        "int main() {\n  double row[5], out;\n"
        "  while (std::scanf(\"%lf %lf %lf %lf %lf\", row, row + 1, row + 2,"
        " row + 3, row + 4) == 5) {\n"
        "    PredictRaw(row, &out);\n    std::printf(\"%.17g\\n\", out);\n"
        "  }\n  return 0;\n}\n")
    exe = str(tmp_path / "model_bin")
    subprocess.run(["g++", "-O0", "-o", exe, str(tmp_path / "model_t.cpp"),
                    str(main_cpp)], check=True, capture_output=True)
    res = subprocess.run([exe], input="\n".join(
        " ".join(repr(float(v)) for v in row) for row in X),
        capture_output=True, text=True, check=True)
    got = np.array([float(v) for v in res.stdout.split()])
    want = Booster(model_file=path, device="cpu").predict(X, raw_score=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_refit_matches_jax(model, tmp_path):
    data, path = model
    new = _write(tmp_path, "new.tsv", n=500, seed=5)
    tpath, jpath = _both(["task=refit", f"data={new}",
                          f"input_model={path}", "refit_decay_rate=0.5"],
                         tmp_path, "refit")
    _same_models(tpath, jpath)
    before = Booster(model_file=path, device="cpu")._all_trees()
    after = Booster(model_file=tpath, device="cpu")._all_trees()
    assert any(not np.array_equal(a.leaf_value, b.leaf_value)
               for a, b in zip(before, after))


def test_config_file(tmp_path):
    """``config=<file>`` reads ``key = value`` lines with comments and
    aliases; an argument overrides the file; the model is the inline
    arguments' and the JAX package's."""
    data = _write(tmp_path)
    conf = tmp_path / "train.conf"
    conf.write_text("task = train\n" + "\n".join(
        a.replace("=", " = ") for a in TRAIN) + f"\ndata = {data}\n"
        "num_leaves = 31  # overridden below\n# a comment line\n\n")
    via_file = str(tmp_path / "file.txt")
    inline = str(tmp_path / "inline.txt")
    assert _port([f"config={conf}", "num_leaves=7",
                  f"output_model={via_file}"]) == 0
    assert _port([f"data={data}", *TRAIN, f"output_model={inline}"]) == 0
    assert open(via_file).read() == open(inline).read()
    jpath = str(tmp_path / "j.txt")
    assert jcli.main([f"config={conf}", "num_leaves=7",
                      f"output_model={jpath}"]) == 0
    _same_models(via_file, jpath)
    cfg = tconfig.Config.from_cli([f"config_file={conf}", "eta=0.3",
                                   "no_equals_sign"])
    assert cfg.num_leaves == 31 and cfg.learning_rate == 0.3
    assert cfg.data == data and cfg.config == ""


def test_snapshots_resume_bit_exact(tmp_path):
    """``snapshot_freq=2``: a model text and a checkpoint every two
    iterations, the newest ``snapshot_keep`` of each kept; a run whose
    final model is missing resumes from the newest intact checkpoint (a
    torn newer one skipped) and writes the uninterrupted run's text."""
    data = _write(tmp_path)
    args = [f"data={data}", *[a for a in TRAIN if "num_trees" not in a],
            "snapshot_freq=2", "bagging_fraction=0.8", "bagging_freq=1"]
    whole = str(tmp_path / "whole.txt")
    assert _port(args + ["num_trees=8", f"output_model={whole}"]) == 0
    out = str(tmp_path / "m.txt")
    assert _port(args + ["num_trees=6", f"output_model={out}",
                         "snapshot_keep=2"]) == 0
    arts = sorted(p for p in os.listdir(tmp_path) if p.startswith("m.txt."))
    assert arts == ["m.txt.ckpt_iter_4", "m.txt.ckpt_iter_6",
                    "m.txt.snapshot_iter_4", "m.txt.snapshot_iter_6"]
    os.remove(out)                                   # the run "died"
    with open(out + ".ckpt_iter_6", "r+b") as fh:    # and tore its newest
        fh.truncate(100)
    assert _port(args + ["num_trees=8", f"output_model={out}"]) == 0
    assert open(out).read() == open(whole).read()
    # the JAX CLI writes the same artifacts
    jout = str(tmp_path / "jm.txt")
    assert jcli.main(args + ["num_trees=4", f"output_model={jout}"]) == 0
    assert os.path.exists(jout + ".ckpt_iter_4")
    assert os.path.exists(jout + ".snapshot_iter_2")


def test_save_binary_round_trips(tmp_path):
    """``save_binary=true`` writes ``<data>.bin``; the JAX package loads
    the port's cache and the port the JAX package's, bins, mappers and
    metadata equal; training from the port's cache (``data=<.bin>``)
    writes the text of training from the file."""
    data = _write(tmp_path)
    from_file = str(tmp_path / "from_file.txt")
    assert _port([f"data={data}", *TRAIN, "save_binary=true",
                  f"output_model={from_file}"]) == 0
    tbin = data + ".bin"
    jbin = str(tmp_path / "jax.bin")
    JDataset(data, params={"max_bin": 63}).save_binary(jbin)
    shutil.copy(tbin, str(tmp_path / "port.bin"))
    for path in (tbin, jbin):
        t = Dataset(path).construct()._binned
        j = JDataset(path).construct()._binned
        np.testing.assert_array_equal(t.binned, j.binned)
        np.testing.assert_array_equal(t.metadata.label, j.metadata.label)
        assert t.feature_names == j.feature_names
        for tm, jm in zip(t.bin_mappers, j.bin_mappers):
            np.testing.assert_array_equal(tm.bin_upper_bound,
                                          jm.bin_upper_bound)
            assert (tm.num_bin, tm.missing_type) == (jm.num_bin,
                                                     jm.missing_type)
    np.testing.assert_array_equal(Dataset(tbin).construct()._binned.binned,
                                  Dataset(jbin).construct()._binned.binned)
    from_bin = str(tmp_path / "from_bin.txt")
    assert _port([f"data={tbin}", *TRAIN, f"output_model={from_bin}"]) == 0
    assert open(from_bin).read() == open(from_file).read()


def test_binary_cache_is_checked(tmp_path):
    """A cache with a flipped byte is refused by its digests."""
    from lightgbmv1_tpu_torch.utils.log import LightGBMError

    X = np.random.RandomState(0).randn(200, 3)
    path = str(tmp_path / "d.bin")
    Dataset(X, label=(X[:, 0] > 0).astype(float)).save_binary(path)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(LightGBMError, match="corrupt"):
        Dataset(path).construct()


@pytest.mark.parametrize("args,item", [
    (["task=save_binary", "data=d.tsv", "tree_learner=voting",
      "elastic_max_restarts=5"], tconfig.PARALLEL),
    (["task=predict", "num_machines=2", "num_hosts=2"],
     tconfig.PARALLEL_LEGS),
    (["task=train", "data=d.tsv", "stream_enable=true",
      "elastic_lease_timeout_s=1"], tconfig.PARALLEL),
    (["task=predict", "data=d.tsv", "input_model=m.txt",
      "output_result=p.txt", "predict_method=depthwise",
      "predict_num_shards=2"],
     tconfig.SHARDED_PREDICT),
    (["task=train", "data=d.tsv", "tree_learner=data",
      "hist_dtype_deep=int8sr"], tconfig.PARALLEL_LEGS),
    (["task=predict", "data=d.tsv", "input_model=m.txt",
      "output_result=p.txt", "predict_method=scan"],
     tconfig.SHARDED_PREDICT)],
    ids=["save_binary", "num_machines", "stream_enable",
         "predict_num_shards", "tree_learner", "predict_method_scan"])
def test_unported_tasks_and_knobs_raise(args, item, tmp_path, monkeypatch):
    """What the port does not run raises naming its item, from the
    configuration (before any file is read) or, for row-sharded predict,
    where the predictor is built."""
    monkeypatch.chdir(tmp_path)
    X = np.random.RandomState(0).randn(50, 3)
    y = (X[:, 0] > 0).astype(float)
    np.savetxt("d.tsv", np.column_stack([y, X]), delimiter="\t")
    train({"objective": "binary", "num_leaves": 4, "verbosity": -1},
          Dataset(X, label=y), 2, device="cpu").save_model("m.txt")
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"ROADMAP queue 1, {item}") + "$"):
        _port(args)


def test_fleet_and_observability_knobs_are_accepted():
    """The fleet's, the router's and placement's knobs, ``profile_dir``
    and ``obs_dir`` (items 7 and 12) are no longer refused."""
    cfg = tconfig.Config.from_cli([
        "task=serve", "input_model=m.txt", "serve_replicas=3",
        "router_hedge_ms=50", "router_retry_max=2",
        "router_health_period_ms=15", "tenant_manifest=a,b",
        "placement_replicas_per_tenant=2", "profile_dir=prof",
        "obs_dir=obs"])
    assert tconfig.unported_reason(cfg) is None


def test_obs_trace_writes_the_train_spans(tmp_path):
    """``task=train trace_out=...`` (which implies ``obs_trace``): both
    CLIs write a Chrome trace holding one ``train.iteration`` span an
    iteration, numbered alike, and disarm the tracer at the end."""
    from lightgbmv1_tpu.obs import trace as jtrace
    from lightgbmv1_tpu_torch.obs import trace as ttrace

    data = _write(tmp_path)
    spans = {}
    for tag, run in (("t", _port), ("j", jcli.main)):
        out = str(tmp_path / f"trace_{tag}.json")
        assert run([f"data={data}", *TRAIN, f"trace_out={out}",
                    f"output_model={tmp_path / (tag + '.txt')}"]) == 0
        doc = json.load(open(out))
        spans[tag] = sorted(e["args"]["iteration"]
                            for e in doc["traceEvents"]
                            if e.get("name") == "train.iteration")
    assert spans["t"] == spans["j"] == list(range(5))
    assert not ttrace.enabled() and not jtrace.enabled()


def test_task_serve_answers_over_http(model, tmp_path):
    """``task=serve`` on the CPU: the port's CLI loads the model, serves
    it over HTTP on the port it logs for the bounded window, answers a
    request with ``Booster.predict``'s raw scores (bit for bit on the
    f64 lane) under version ``v1``, and returns at the window's end."""
    from lightgbmv1_tpu_torch.utils.log import register_callback

    _, path = model
    lines = []
    register_callback(lines.append)
    try:
        th = threading.Thread(target=_port, args=([
            "task=serve", f"input_model={path}", "serve_http_port=0",
            "serve_duration_s=4", "predict_f64_scores=true",
            "verbosity=1"],))
        th.start()
        port = _wait_for_port(lines, th)
        X = np.random.RandomState(5).randn(7, 5)
        code, body = _http_post(port, {"rows": X.tolist()})
        th.join(timeout=60)
    finally:
        register_callback(None)
    assert not th.is_alive()
    assert code == 200 and body["version"] == "v1"
    want = Booster(model_file=path, device="cpu").predict(X, raw_score=True)
    np.testing.assert_array_equal(np.asarray(body["values"])[:, 0], want)
    assert any("serve: final metrics" in ln for ln in lines)


def _wait_for_port(lines, th, timeout=60.0):
    """The HTTP port ``task=serve`` logs, once its ``/healthz`` answers
    200; polled for the whole window, never a fixed start-up sleep."""
    t_end = time.monotonic() + timeout
    port = None
    while time.monotonic() < t_end and th.is_alive():
        for ln in list(lines):
            m = re.search(r"HTTP listening on 127\.0\.0\.1:(\d+)", ln)
            if m:
                port = int(m.group(1))
        if port is not None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    if r.status == 200:
                        return port
            except OSError:
                pass
        time.sleep(0.02)
    raise AssertionError(f"task=serve never became healthy: {lines[-5:]}")


def _http_post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_usage_and_unknown_task(capsys):
    from lightgbmv1_tpu_torch.utils.log import LightGBMError

    assert cli.main([]) == 1
    assert "python -m lightgbmv1_tpu_torch" in capsys.readouterr().out
    with pytest.raises(LightGBMError, match="Unknown task: nope"):
        _port(["task=nope"])
    with pytest.raises(LightGBMError, match="No training data"):
        _port(["task=train"])


def test_python_m_entry_point(model, tmp_path):
    """``python -m lightgbmv1_tpu_torch`` runs the CLI."""
    _, path = model
    out = str(tmp_path / "m.cpp")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "lightgbmv1_tpu_torch",
                          "task=convert_model", f"input_model={path}",
                          f"convert_model={out}", "device_type=cpu"],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert open(out).read().startswith("// Generated by")
