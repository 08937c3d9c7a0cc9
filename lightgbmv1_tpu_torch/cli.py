"""Command-line application; the port's copy of lightgbmv1_tpu/cli.py.

The counterpart of the reference CLI (``src/main.cpp:11-42`` →
``src/application/application.cpp``: parameter loading :49-82, LoadData
:84-162, InitTrain :164-199, Train :201, Predict :213 →
``src/application/predictor.hpp:29-160``; model conversion
``ModelToIfElse``, src/boosting/gbdt_model_text.cpp:122-304):

    python -m lightgbmv1_tpu_torch config=train.conf [key=value ...]

Tasks: ``train`` (default; ``save_binary=true`` also writes
``<data>.bin``, the binned dataset cache; ``snapshot_freq`` writes a
model text and a checkpoint every so many iterations, and a run whose
``output_model`` is missing resumes from the newest intact one),
``predict`` / ``prediction`` / ``test``, ``refit``, ``convert_model``
(C++ if-else code) and ``serve``: ``input_model`` published into a warm
``Server`` behind the HTTP front-end on 127.0.0.1:``serve_http_port``
(``POST /predict``, ``GET /metrics``, ``/slo``, ``/drift``, ``/tenants``,
``/healthz``; ``tenant_manifest`` hosts named tenants beside the
default one) for ``serve_duration_s`` seconds (0: until interrupted).
``serve_replicas > 1`` serves a fleet of that many replicas on the one
device (serve/fleet.py, two-phase publish) behind the router
(serve/router.py: the ``router_*`` knobs), through the same front-end;
``placement_replicas_per_tenant`` pins each manifest tenant to that many
replicas and moves the hot ones once a second (serve/placement.py).
``task=save_binary`` parses and bins ``data`` once and writes the
out-of-core block cache (data/block_cache.py) to ``stream_cache_dir``
or ``<data>.blocks``, ``stream_block_rows`` rows a block; ``task=train
data=<that directory>`` detects it and trains through the row-block
streaming trainer (models/gbdt_stream.py), as ``stream_enable=true``
does on any data.

``obs_trace`` / ``trace_out`` arm the span tracer over a training or
serving run (``trace_out`` gets the Chrome trace at its end);
``profile_dir`` captures the train, predict or serve window with
``torch.profiler`` (obs/device.py); after every task the process's
trace, metrics and events go to ``obs_dir`` (or ``LGBMV1_OBS_DIR``) for
obs/agg.py to merge; ``crash_dir`` arms the crash-dump recorder for the
process; at ``verbosity >= 1`` the phase timer's report is logged at
exit.  The ``snapshot`` fault seam (utils/faults.py) fires after each
snapshot.

``num_machines=N machines=host:port,...`` (or ``machine_list_filename``)
runs the task as one rank of N (JAX :615-620; reference
Application::InitTrain -> Network::Init): ``parallel/cluster.init_cluster``
makes the group first, this rank found by its ``local_listen_port``,
``task=train`` then loads this rank's shard of ``data`` through
``parallel/dist_data.load_distributed`` (the whole file under
``tree_learner=feature``, this rank's file under ``pre_partition``), and
rank 0 alone writes the model, its snapshots and the binary cache.

It runs on the card; ``device_type=cpu`` (alias ``device``) runs it on
the CPU.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import sys
import time
from typing import List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import Config, unported_reason
from .device import knob_device
from .io.dataset import BinnedDataset
from .io.parser import load_data_file
from .utils import faults, fileio
from .utils.log import log_fatal, log_info, log_warning
from .utils.timer import global_timer


def _config_to_params(config: Config) -> dict:
    """The Config as the params dict the Booster takes."""
    return dataclasses.asdict(config)


def _categorical(config: Config):
    """The ``categorical_feature`` knob's column indices, or "auto"."""
    if not config.categorical_feature:
        return "auto"
    return [int(x) for x in
            str(config.categorical_feature).replace(",", " ").split()]


def _load_dataset(config: Config, path: str,
                  reference: Optional[Dataset] = None,
                  init_score_file: str = "") -> Dataset:
    """A data file as a Dataset (JAX :45): a binned cache or a block
    cache directory (JAX :50-56, streamed by the training) as it is,
    ``two_round`` streamed into bins, else parsed with the loader knobs.
    The file's init scores reach the Dataset (the JAX CLI drops them)."""
    params = _config_to_params(config)
    if reference is None and _distributed():
        from .parallel.dist_data import load_distributed

        return Dataset.from_binned(
            load_distributed(path, config,
                             categorical_features=(
                                 None if _categorical(config) == "auto"
                                 else _categorical(config))),
            params=params)
    if os.path.isdir(path) or BinnedDataset.is_binary_file(path):
        return Dataset(path, params=params, reference=reference)
    if config.two_round and reference is None:
        return Dataset(path, params=params, reference=reference,
                       categorical_feature=_categorical(config))
    df = load_data_file(
        path, has_header=config.header, label_column=config.label_column,
        weight_column=config.weight_column,
        group_column=config.group_column,
        ignore_column=config.ignore_column, num_threads=config.num_threads,
        init_score_file=init_score_file)
    return Dataset(df.X, label=df.label, weight=df.weight, group=df.group,
                   init_score=df.init_score, params=params,
                   reference=reference,
                   feature_name=df.feature_names or "auto",
                   categorical_feature=_categorical(config))


def _distributed() -> bool:
    """Whether this process is one rank of a group of more than one."""
    from .parallel.collectives import current_group

    return current_group().world > 1


def _rank() -> int:
    from .parallel.collectives import current_group

    return current_group().rank


def _iter_artifacts(output_model: str):
    """``[(iteration, kind, path)]`` of the resume artifacts on disk:
    ``ckpt`` (the trainer's whole state, a bit-exact resume) or
    ``snapshot`` (model text, continued training)."""
    out = []
    for kind, tag in (("ckpt", ".ckpt_iter_"),
                      ("snapshot", ".snapshot_iter_")):
        for p in glob.glob(glob.escape(output_model) + tag + "*"):
            m = re.search(r"_iter_(\d+)$", p)
            if m:
                out.append((int(m.group(1)), kind, p))
    return out


def _find_resume_point(output_model: str):
    """The newest intact resume artifact as ``(kind, path, done_iters,
    bundle)``, ``(None, None, 0, None)`` when none is (JAX :116): every
    checkpoint comes before every snapshot, newest first, and each is
    validated before it is chosen, so a torn newest file gives way to
    the one before it."""
    from .io.checkpoint import load_checkpoint
    from .io.model_text import model_from_string

    arts = _iter_artifacts(output_model)
    arts.sort(key=lambda t: (t[1] == "ckpt", t[0]), reverse=True)
    for it, kind, path in arts:
        try:
            if kind == "ckpt":
                bundle = load_checkpoint(path)
                return (kind, path, int(bundle["manifest"]["iteration"]),
                        bundle)
            with fileio.open_file(path) as fh:
                model_from_string(fh.read())
            return kind, path, it, None
        except Exception as e:  # noqa: BLE001 — the next one, loudly
            log_warning(f"Ignoring invalid {kind} {path} "
                        f"({type(e).__name__}: {e})")
    return None, None, 0, None


def _prune_snapshots(output_model: str, keep: int) -> None:
    """Keep the newest ``keep`` artifacts of each kind (at least 2, so a
    torn newest one always has an intact predecessor)."""
    by_kind = {"ckpt": [], "snapshot": []}
    for it, kind, path in _iter_artifacts(output_model):
        by_kind[kind].append((it, path))
    for arts in by_kind.values():
        arts.sort(reverse=True)
        for _, path in arts[max(keep, 2):]:
            try:
                os.remove(path)
            except OSError:
                pass


def _arm_trace(config: Config) -> bool:
    """Arm the span tracer under ``obs_trace`` / ``trace_out`` (JAX
    :240-247); True when armed."""
    if not config.obs_trace:
        return False
    from .obs import trace as obs_trace

    obs_trace.arm(ring_events=config.obs_ring_events)
    return True


def _finish_trace(config: Config, tracing: bool) -> None:
    """Export the spans to ``trace_out`` (when set) and disarm (JAX
    :251-267); nothing when the tracer was not armed here."""
    if not tracing:
        return
    from .obs import trace as obs_trace

    if config.trace_out and obs_trace.enabled():
        doc = obs_trace.export_chrome(config.trace_out)
        log_info(f"Wrote host span trace to {config.trace_out} "
                 f"({len(doc['traceEvents'])} events, "
                 f"{doc['otherData']['dropped_events']} dropped; "
                 "open at https://ui.perfetto.dev)")
    obs_trace.disarm()


def _arm_profiler(config: Config):
    """Arm the ``profile_dir`` capture (obs/device.py) for this task's
    window and return its export-once finisher (JAX :166-184): safe to
    call from every exit path, only the first call stops the capture
    and writes the trace and the wall-clock anchor sidecar."""
    if not config.profile_dir:
        return lambda: None
    from .obs import device as obs_device

    session = obs_device.start_profiler(config.profile_dir)

    def finish():
        if obs_device.stop_profiler(session):
            log_info(f"Wrote device trace to {config.profile_dir} (merge "
                     "the lane with obs.agg.aggregate_dir(obs_dir, "
                     f"profile_dir={config.profile_dir!r}))")
    return finish


def _obs_dir(config: Config) -> str:
    return config.obs_dir or os.environ.get("LGBMV1_OBS_DIR", "")


def run_train(config: Config) -> Booster:
    """Train on ``data`` with the ``valid`` files (JAX :188; reference
    Application::InitTrain + Train, application.cpp:164-211)."""
    if not config.data:
        log_fatal("No training data: set data=<file>")
    dev = knob_device(config.device_type)
    t0 = time.time()
    train_set = _load_dataset(config, config.data,
                              init_score_file=config.initscore_filename)
    if config.save_binary and _rank() == 0:
        # reference: is_save_binary_file -> SaveBinaryFile(data + ".bin")
        train_set.save_binary(config.data + ".bin")
    init_model = config.input_model or None
    done_iters, resume_bundle = 0, None
    if init_model is None and config.snapshot_freq > 0 \
            and not os.path.exists(config.output_model):
        # a run that died before its final model resumes from its newest
        # intact artifact; a finished run's snapshots never start a new one
        kind, snap, done_iters, resume_bundle = _find_resume_point(
            config.output_model)
        if kind == "ckpt":
            log_info(f"Resuming bit-exactly from checkpoint {snap} "
                     f"({done_iters} iterations already trained)")
        elif kind == "snapshot":
            log_info(f"Resuming from snapshot {snap} ({done_iters} "
                     "iterations already trained)")
            init_model = snap
    booster = Booster(params=_config_to_params(config), train_set=train_set,
                      init_model=init_model, device=dev)
    for i, vpath in enumerate(config.valid):
        vinit = (config.valid_data_initscores[i]
                 if i < len(config.valid_data_initscores) else "")
        booster.add_valid(_load_dataset(config, vpath, reference=train_set,
                                        init_score_file=vinit),
                          os.path.basename(vpath))
    if resume_bundle is not None:
        # after add_valid: the valid score caches are part of the bundle
        booster.resume_from_checkpoint(resume_bundle)
    log_info(f"Finished loading data in {time.time() - t0:.6f} seconds")

    t0 = time.time()
    tracing = _arm_trace(config)
    finish_profile = _arm_profiler(config)
    try:
        for i in range(max(config.num_iterations - done_iters, 0)):
            finished = booster.update()
            if config.metric_freq > 0 and (i + 1) % config.metric_freq == 0:
                # the training metric only under is_provide_training_metric
                # (reference gbdt.cpp:413-434)
                rows = list(booster.eval_valid())
                if config.is_provide_training_metric:
                    rows = list(booster.eval_train()) + rows
                for data_name, metric, value, _ in rows:
                    log_info(f"Iteration:{i + 1}, {data_name} {metric} : "
                             f"{value:g}")
            log_info(f"{time.time() - t0:.6f} seconds elapsed, finished "
                     f"iteration {i + 1}")
            total_i = done_iters + i + 1
            if config.snapshot_freq > 0 \
                    and total_i % config.snapshot_freq == 0:
                # reference GBDT::Train, gbdt.cpp:258-262; both written
                # atomically, so a kill leaves only intact files
                snap = f"{config.output_model}.snapshot_iter_{total_i}"
                booster.save_model(snap)
                booster.save_checkpoint(f"{config.output_model}.ckpt_iter_"
                                        f"{total_i}")
                log_info(f"Saved snapshot to {snap} (+ checkpoint bundle)")
                _prune_snapshots(config.output_model,
                                 keep=config.snapshot_keep)
                # fault seam: a scripted kill lands here, after the Nth
                # snapshot is durable and before the next iteration
                faults.fire("snapshot", site=str(total_i))
            if finished:
                break
    except BaseException as e:
        # a dying run: the armed flight recorder writes its bundle here,
        # while the trainer state that explains the death exists, and
        # the partial trace is exported
        from .obs import dump as obs_dump

        obs_dump.dump("train_crash", exc=e)
        _finish_trace(config, tracing)
        finish_profile()    # a dying run still gets its partial capture
        raise
    try:
        if config.output_model:
            # inside the traced window: the final save is on the timeline
            booster.save_model(config.output_model)
    finally:
        _finish_trace(config, tracing)
        finish_profile()
    log_info("Finished training")
    return booster


def run_predict(config: Config) -> np.ndarray:
    """Predict ``data`` with ``input_model`` into ``output_result``, one
    row a line, tab-separated (JAX :347; reference Application::Predict
    -> Predictor, predictor.hpp:29-160); ``predict_method`` and the other
    ``predict_*`` knobs reach ``Booster.predict``."""
    if not config.input_model:
        log_fatal("No model file: set input_model=<file>")
    if not config.data:
        log_fatal("No prediction data: set data=<file>")
    booster = Booster(params=_config_to_params(config),
                      model_file=config.input_model,
                      device=knob_device(config.device_type))
    log_info("Finished initializing prediction, total used "
             f"{booster.current_iteration()} iterations")
    finish_profile = _arm_profiler(config)
    t0 = time.time()
    try:
        df = load_data_file(
            config.data, has_header=config.header,
            label_column=config.label_column,
            weight_column=config.weight_column,
            group_column=config.group_column,
            ignore_column=config.ignore_column, is_predict=True)
        X = df.X
        if X.shape[1] == booster.num_feature() + 1:
            X = X[:, 1:]    # a prediction file may keep the label column
        t_parse = time.time()
        out = np.asarray(booster.predict(
            X, raw_score=config.predict_raw_score,
            pred_leaf=config.predict_leaf_index,
            pred_contrib=config.predict_contrib,
            start_iteration=config.start_iteration_predict,
            num_iteration=(config.num_iteration_predict
                           if config.num_iteration_predict > 0 else None),
            pred_early_stop=config.pred_early_stop,
            pred_early_stop_freq=config.pred_early_stop_freq,
            pred_early_stop_margin=config.pred_early_stop_margin,
            predict_disable_shape_check=config.predict_disable_shape_check))
        t_pred = time.time()
        if out.ndim == 1:
            out = out[:, None]
        np.savetxt(config.output_result, out,
                   fmt="%d" if config.predict_leaf_index else "%.18g",
                   delimiter="\t")
    finally:
        finish_profile()    # the partial capture lands on a failure too
    log_info(f"Prediction window: parse {t_parse - t0:.3f}s, predict "
             f"{t_pred - t_parse:.3f}s ({config.predict_method}), write "
             f"{time.time() - t_pred:.3f}s ({X.shape[0]} rows)")
    log_info("Finished prediction")
    return out


def run_serve(config: Config, ready=None, stop=None):
    """Online serving (JAX :415-553): load ``input_model``, publish it
    into a warm :class:`~lightgbmv1_tpu_torch.serve.Server` on the
    device, with the manifest's tenants each published the same model,
    and listen on the HTTP front-end until ``serve_duration_s`` (0: until
    interrupted).  ``serve_replicas > 1`` stands up a
    :class:`~lightgbmv1_tpu_torch.serve.Fleet` of that many replicas on
    the one device behind a :class:`~lightgbmv1_tpu_torch.serve.Router`
    (the ``router_*`` and ``serve_slo_*`` knobs), which the front-end
    serves and this returns as the "server"; with a manifest and
    ``placement_replicas_per_tenant`` a placement controller pins the
    tenants and is stepped once a second.  Returns ``(server, http)``,
    both shut down, with the final metrics logged and, under ``obs_dir``
    or ``LGBMV1_OBS_DIR``, the process's artifacts written with the
    server's (or the router's) registry.

    A caller that embeds the run passes ``ready(server, http)``, called
    once the front-end listens (it may publish, roll back or read the
    server from there), and ``stop``, a ``threading.Event`` that ends
    the window early when set."""
    from .serve import ServeHTTP, TenantRegistry
    from .serve.server import build_server

    if not config.input_model:
        log_fatal("No model file: set input_model=<file>")
    tracing = _arm_trace(config)
    finish_profile = _arm_profiler(config)
    fleet = placement = None
    try:
        dev = knob_device(config.device_type)
        booster = Booster(params=_config_to_params(config),
                          model_file=config.input_model, device=dev)
        if config.serve_replicas > 1:
            fleet, server = _build_fleet(booster, config, dev)
        else:
            server = build_server(booster, config, device=dev)
    except BaseException:
        finish_profile()
        _finish_trace(config, tracing)
        raise
    try:
        if config.tenant_manifest:
            tenreg = TenantRegistry(fleet if fleet is not None else server)
            specs = tenreg.add_manifest(config.tenant_manifest)
            for spec in specs:
                tenreg.publish(spec.name, booster)
            log_info(f"serve: {len(specs)} tenant(s) published "
                     f"({', '.join(sp.name for sp in specs)})")
            if fleet is not None and config.placement_replicas_per_tenant:
                from .serve import PlacementConfig, PlacementController

                placement = PlacementController(fleet, server, PlacementConfig(
                    replicas_per_tenant=config.placement_replicas_per_tenant,
                    burn_threshold=config.placement_burn_threshold,
                    occupancy_frac=config.placement_occupancy_frac,
                    cooldown_s=config.placement_cooldown_s))
                placement.assign()
        http = ServeHTTP(server, port=config.serve_http_port).start()
    except BaseException:
        server.close()
        if fleet is not None:
            fleet.close()
        finish_profile()
        _finish_trace(config, tracing)
        raise
    log_info(f"serve: HTTP listening on 127.0.0.1:{http.port} "
             "(POST /predict, GET /metrics, GET /healthz)")
    try:
        if ready is not None:
            ready(server, http)
        deadline = (time.monotonic() + config.serve_duration_s
                    if config.serve_duration_s > 0 else None)
        while deadline is None or time.monotonic() < deadline:
            step = 3600.0 if placement is None else 1.0
            if deadline is not None:
                step = min(step, max(deadline - time.monotonic(), 0.0))
            if stop is None:
                time.sleep(step)
            elif stop.wait(step):
                break
            if placement is not None:
                placement.step()
    except KeyboardInterrupt:
        log_info("serve: interrupted")
    finally:
        import json

        http.shutdown()
        snap = server.metrics_snapshot()
        obs_dir = _obs_dir(config)
        if obs_dir:
            # with THIS server's (or router's) registry, so the merged
            # snapshot carries its serve counters (JAX :531-540)
            from .obs import agg as obs_agg

            obs_agg.export_process_artifacts(
                obs_dir, registry=server.metrics.registry)
            log_info(f"serve: wrote obs artifacts to {obs_dir}")
        server.close()
        if fleet is not None:
            fleet.close()
        finish_profile()
        _finish_trace(config, tracing)
        log_info("serve: final metrics " + json.dumps(snap))
    return server, http


def _build_fleet(booster: Booster, config: Config, dev):
    """``(fleet, router)``: ``serve_replicas`` replicas of the serving
    knobs on ``dev``, ``booster`` published fleet-wide, behind a router
    with the ``router_*`` and ``serve_slo_*`` knobs (JAX :465-509)."""
    from .serve import (Fleet, Router, RouterConfig, SLOConfig,
                        serve_config_from)

    fleet = Fleet(booster, n_replicas=config.serve_replicas,
                  config=serve_config_from(config), device=dev)
    try:
        router = Router(fleet, RouterConfig(
            health_period_ms=config.router_health_period_ms,
            eject_after=config.router_eject_after,
            readmit_after=config.router_readmit_after,
            retry_max=config.router_retry_max,
            hedge_ms=config.router_hedge_ms,
            deadline_ms=config.router_deadline_ms,
            slo=SLOConfig(
                availability_target=config.serve_slo_availability_target,
                latency_ms=config.serve_slo_latency_ms,
                latency_target=config.serve_slo_latency_target,
                fast_window_s=config.serve_slo_fast_window_s,
                slow_window_s=config.serve_slo_slow_window_s)))
    except BaseException:
        fleet.close()
        raise
    log_info(f"serve: fleet of {config.serve_replicas} replicas "
             f"({fleet.version()}) behind the router")
    return fleet, router


def run_refit(config: Config) -> Booster:
    """Re-fit ``input_model``'s leaves on ``data`` into ``output_model``
    (JAX :557; reference Application task=refit)."""
    if not config.input_model:
        log_fatal("No model file: set input_model=<file>")
    booster = Booster(model_file=config.input_model,
                      device=knob_device(config.device_type))
    df = load_data_file(config.data, has_header=config.header,
                        label_column=config.label_column)
    refitted = booster.refit(df.X, df.label,
                             decay_rate=config.refit_decay_rate)
    refitted.save_model(config.output_model)
    log_info(f"Finished refit; model saved to {config.output_model}")
    return refitted


def run_convert_model(config: Config) -> str:
    """``input_model`` as standalone C++ if-else code in
    ``convert_model`` (JAX :571; reference GBDT::SaveModelToIfElse)."""
    from .io.model_codegen import model_to_cpp

    if not config.input_model:
        log_fatal("No model file: set input_model=<file>")
    if config.convert_model_language not in ("", "cpp"):
        log_fatal(f"convert_model_language="
                  f"{config.convert_model_language} is not supported; "
                  "only 'cpp' code generation is available")
    booster = Booster(model_file=config.input_model,
                      device=knob_device(config.device_type))
    out = config.convert_model or "gbdt_prediction.cpp"
    with fileio.open_file(out, "w") as fh:
        fh.write(model_to_cpp(booster._loaded))
    log_info(f"Converted model to C++ code at {out}")
    return out


def run_save_binary(config: Config) -> str:
    """``task=save_binary`` (JAX :328-345; reference Application task
    save_binary -> Dataset::SaveBinaryFile): parse and bin ``data``, then
    write the block cache that ``task=train data=<dir>`` streams without
    parsing again; to ``stream_cache_dir`` or ``<data>.blocks``.
    Returns the directory."""
    if not config.data:
        log_fatal("No data to convert: set data=<file>")
    out = config.stream_cache_dir or (config.data + ".blocks")
    t0 = time.time()
    train_set = _load_dataset(config, config.data,
                              init_score_file=config.initscore_filename)
    train_set.save_block_cache(out, block_rows=config.stream_block_rows)
    log_info(f"Finished save_binary in {time.time() - t0:.3f}s: "
             f"train with data={out}")
    return out


_TASKS = {"train": run_train, "predict": run_predict,
          "prediction": run_predict, "test": run_predict,
          "refit": run_refit, "convert_model": run_convert_model,
          "serve": run_serve, "save_binary": run_save_binary}


def main(argv: Optional[List[str]] = None) -> int:
    """Run the task of ``key=value`` arguments (JAX :592); the module's
    usage with none."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    config = Config.from_cli(argv)
    task = config.task
    if task not in _TASKS:
        log_fatal(f"Unknown task: {task}")
    why = unported_reason(config)
    if why is not None:
        raise NotImplementedError(why)
    # the phase timer (reference USE_TIMETAG global_timer, common.h:
    # 1054-1138): its scopes live in models/gbdt.py; report at exit
    global_timer.enabled = config.verbosity >= 1
    # who this process is in its events, the event ring's size, and the
    # crash-dump recorder under crash_dir (or LGBMV1_CRASH_DIR, which
    # reaches a subprocess run)
    from .obs import events as obs_events

    obs_events.set_identity(role=task)
    if config.obs_event_ring != obs_events.DEFAULT_RING_EVENTS:
        obs_events.configure(config.obs_event_ring)
    crash_dir = config.crash_dir or os.environ.get("LGBMV1_CRASH_DIR", "")
    if crash_dir:
        from .obs import dump as obs_dump

        obs_dump.arm(crash_dir, config=_config_to_params(config))
    cluster = None
    if config.num_machines > 1 or config.machines \
            or config.machine_list_filename:
        # reference Application::InitTrain -> Network::Init (JAX
        # :615-620): the group before the task
        from .parallel import cluster

        cluster.init_cluster(config, device=knob_device(config.device_type))
    try:
        _TASKS[task](config)
    finally:
        if cluster is not None:
            cluster.shutdown()
    obs_dir = _obs_dir(config)
    if obs_dir and task != "serve":   # serve exports its own, with its
        # server's registry, inside run_serve's shutdown (JAX :636-643)
        from .obs import agg as obs_agg

        paths = obs_agg.export_process_artifacts(obs_dir)
        log_info(f"Wrote obs artifacts to {obs_dir} "
                 f"({', '.join(sorted(paths))}; merge with "
                 "obs.agg.aggregate_dir)")
    if global_timer.enabled and global_timer.totals:
        log_info(global_timer.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
