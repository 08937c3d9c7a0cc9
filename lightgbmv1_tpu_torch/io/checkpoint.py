"""Trainer checkpoints with bit-exact resume: the port's copy of
lightgbmv1_tpu/io/checkpoint.py (:1-55).

A checkpoint is the whole trainer state, so that a run resumed from it
writes the model text of the run that never stopped, byte for byte: the
trees' arrays in bin space, the f32 score caches of the training and
every valid set, the sequentially drawn ``RandomState``s (feature
sampling, DART's drops with its tree weights and recorded leaf ids), the
iteration, each tree's shrinkage and bias, and the model text.  The
per-iteration streams (bagging, GOSS, extra_trees, the tree keys) are
``fold_in``-keyed on the iteration (utils/prng.py), so they need no state.

The file: one zip, written atomically (``fileio.atomic_write_bytes``),
holding ``manifest.json``, ``model.txt``, an optional ``base_model.txt``
(continued training), ``arrays.npz`` and an optional ``reference.bin``
(the training reference of obs/model.py, for drift checks of the served
model).  The manifest carries the
SHA-256 digests of the other members; ``load_checkpoint`` checks them
before it trusts an array and raises ``CheckpointError`` on a torn or
flipped file.  The state is the port's own (its trees are the port's
``TreeArrays``): a checkpoint of the JAX package is not read here.
Each write observes its wall time in the default registry's
``checkpoint_save_ms`` histogram and, with the tracer armed, records a
``checkpoint.save`` span.
"""

from __future__ import annotations

import hashlib
import io
import json
import zipfile
from typing import Any, Dict

import numpy as np

from ..utils import fileio

FORMAT_NAME = "lightgbmv1-tpu-torch-checkpoint"
FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    """The bundle is unreadable, torn, or does not fit the trainer it is
    restored into."""


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def encode_rng_state(rng: np.random.RandomState) -> Dict[str, Any]:
    name, keys, pos, has_gauss, cached = rng.get_state()
    return {"name": name, "pos": int(pos), "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached),
            "keys": np.asarray(keys, np.uint32).tolist()}


def decode_rng_state(d: Dict[str, Any]) -> tuple:
    return (d["name"], np.asarray(d["keys"], np.uint32), int(d["pos"]),
            int(d["has_gauss"]), float(d["cached_gaussian"]))


def write_checkpoint(path: str, manifest: Dict[str, Any],
                     arrays: Dict[str, np.ndarray], model_text: str,
                     base_model_text: str = "",
                     reference_bytes: bytes = b"") -> None:
    """Serialize one bundle and write it atomically; ``reference_bytes``
    (``ModelReference.to_bytes``) rides as the digest-checked member
    ``reference.bin``."""
    from ..obs import trace
    from ..obs.metrics import default_registry

    t0_ns = trace.now_ns()
    _write_checkpoint(path, manifest, arrays, model_text, base_model_text,
                      reference_bytes)
    default_registry().histogram(
        "checkpoint_save_ms", "Wall time of one checkpoint-bundle write",
        buckets=(5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000, 10000)
    ).observe((trace.now_ns() - t0_ns) / 1e6)
    if trace.enabled():
        trace.add_span("checkpoint.save", t0_ns, trace.now_ns() - t0_ns,
                       cat="checkpoint", args={"path": str(path)})


def _write_checkpoint(path, manifest, arrays, model_text, base_model_text,
                      reference_bytes) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    arrays_bytes = buf.getvalue()
    model_bytes = model_text.encode("utf-8")
    base_bytes = base_model_text.encode("utf-8") if base_model_text else b""
    manifest = dict(manifest)
    manifest["format"] = FORMAT_NAME
    manifest["format_version"] = FORMAT_VERSION
    manifest["digests"] = {"arrays.npz": _digest(arrays_bytes),
                           "model.txt": _digest(model_bytes)}
    if base_bytes:
        manifest["digests"]["base_model.txt"] = _digest(base_bytes)
    if reference_bytes:
        manifest["digests"]["reference.bin"] = _digest(reference_bytes)
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest))
        zf.writestr("model.txt", model_bytes)
        if base_bytes:
            zf.writestr("base_model.txt", base_bytes)
        zf.writestr("arrays.npz", arrays_bytes)
        if reference_bytes:
            zf.writestr("reference.bin", reference_bytes)
    fileio.atomic_write_bytes(path, out.getvalue(), site=path)


def is_checkpoint_file(path) -> bool:
    """A zip whose members include our manifest."""
    try:
        with fileio.open_file(str(path), "rb") as fh:
            raw = fh.read()
        if raw[:2] != b"PK":
            return False
        with zipfile.ZipFile(io.BytesIO(raw)) as zf:
            return "manifest.json" in zf.namelist()
    except Exception:  # noqa: BLE001 - an unreadable file is no checkpoint
        return False


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read and check a bundle: ``{"manifest", "arrays", "model_text",
    "base_model_text", "reference_bytes"}`` (the last empty when the
    bundle carries no reference).  Raises ``CheckpointError`` on a torn zip, a
    digest that does not match, a missing member, model text whose trees
    fail ``validate_host_tree`` or a tree count other than the
    manifest's, or a score cache that is not finite."""
    try:
        with fileio.open_file(str(path), "rb") as fh:
            raw = fh.read()
        with zipfile.ZipFile(io.BytesIO(raw)) as zf:
            names = set(zf.namelist())
            if "manifest.json" not in names:
                raise CheckpointError(f"{path}: no manifest")
            manifest = json.loads(zf.read("manifest.json"))
            if manifest.get("format") != FORMAT_NAME:
                raise CheckpointError(f"{path}: not a {FORMAT_NAME} bundle")
            members = {}
            for member, want in manifest.get("digests", {}).items():
                if member not in names:
                    raise CheckpointError(f"{path}: missing {member}")
                data = zf.read(member)
                if _digest(data) != want:
                    raise CheckpointError(
                        f"{path}: digest mismatch on {member} (torn or "
                        "corrupted bundle)")
                members[member] = data
    except CheckpointError:
        raise
    except Exception as e:  # noqa: BLE001 - zip, json and IO failures
        raise CheckpointError(
            f"{path}: unreadable checkpoint ({type(e).__name__}: {e})")
    model_text = members.get("model.txt", b"").decode("utf-8")
    base_text = members.get("base_model.txt", b"").decode("utf-8")
    try:
        from .model_text import model_from_string

        loaded = model_from_string(model_text)
    except Exception as e:  # noqa: BLE001
        raise CheckpointError(f"{path}: model text failed validation "
                              f"({type(e).__name__}: {e})")
    if len(loaded.trees) != int(manifest.get("num_trees_total",
                                             len(loaded.trees))):
        raise CheckpointError(
            f"{path}: manifest claims {manifest.get('num_trees_total')} "
            f"trees, model text carries {len(loaded.trees)}")
    try:
        npz = np.load(io.BytesIO(members["arrays.npz"]), allow_pickle=False)
        arrays = {k: npz[k] for k in npz.files}
    except Exception as e:  # noqa: BLE001
        raise CheckpointError(
            f"{path}: unreadable arrays ({type(e).__name__}: {e})")
    # a NaN-poisoned trainer must not leave a "valid" checkpoint
    for k, a in arrays.items():
        if (k.endswith("_score") or "_score_" in k) and a.dtype.kind == "f" \
                and not np.isfinite(a).all():
            raise CheckpointError(f"{path}: non-finite values in {k}")
    return {"manifest": manifest, "arrays": arrays,
            "model_text": model_text, "base_model_text": base_text,
            "reference_bytes": members.get("reference.bin", b"")}


def validate_checkpoint(path: str) -> Dict[str, Any]:
    """The whole check of ``load_checkpoint``; returns the manifest."""
    return load_checkpoint(path)["manifest"]


def checkpoint_iteration(path: str) -> int:
    return int(validate_checkpoint(path)["iteration"])
