"""Local and remote file IO: the port's copy of lightgbmv1_tpu/utils/fileio.py.

A path with a URL scheme (``gs://``, ``s3://``, ``memory://``, ...) is
opened through ``fsspec``; a plain path through the builtin ``open``.
Without ``fsspec`` a remote path raises ``LightGBMError``, as the JAX
module does (:26-38).  ``atomic_write_bytes`` writes a local file
crash-consistently (a temporary file in the target directory, fsync,
rename, directory fsync).  Its ``file_write`` fault seam
(utils/faults.py) makes torn files (``truncate``), flipped bytes
(``corrupt``) and a crash before the rename (``kill``), so the readers
of these files are tested against each.
"""

from __future__ import annotations

import os
import re
from typing import IO

_SCHEME = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote_path(path) -> bool:
    """True for a scheme-prefixed path (``file://`` too: it also opens
    through fsspec)."""
    return bool(_SCHEME.match(str(path)))


def _fsspec(path: str):
    try:
        import fsspec
    except ImportError as e:
        from .log import log_fatal

        log_fatal(f"Remote path {path!r} requires the 'fsspec' package: {e}")
    return fsspec


def open_file(path, mode: str = "r", **kwargs) -> IO:
    """Open a local or remote path."""
    path = str(path)
    if not is_remote_path(path):
        return open(path, mode, **kwargs)
    return _fsspec(path).open(path, mode, **kwargs).open()


def atomic_write_bytes(path, data: bytes, site: str = "") -> None:
    """Write ``data`` to ``path`` so that a crash at any point leaves the
    old file or the new one, never a torn one; a remote path is one
    streamed write (an object store commits whole objects).  ``site``
    names the write to a fault plan (default: the path)."""
    from . import faults

    path = str(path)
    sp = faults.fire("file_write", site=site or path)
    if sp is not None and sp.mode == "truncate":
        # a torn write: half the payload at the final path, no rename
        with open(path, "wb") as fh:
            fh.write(data[: max(len(data) // 2, 1)])
        return
    if sp is not None and sp.mode == "corrupt":
        data = faults.current_plan().corrupt_bytes(data)
    if is_remote_path(path):
        with open_file(path, "wb") as fh:
            fh.write(data)
        return
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        if sp is not None and sp.mode == "kill":
            # a crash between the temporary write and the rename: the old
            # file survives; the armed flight recorder dumps first (not
            # when the write is its own bundle)
            if "forensics_bundle" not in (site or path):
                try:
                    from ..obs import dump

                    dump.dump("fault_kill",
                              error=f"file_write kill at {site or path}")
                except Exception:   # noqa: BLE001
                    pass
            os._exit(137)
        os.replace(tmp, path)
        try:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:   # not every filesystem syncs a directory
            pass
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def atomic_write_text(path, text: str, site: str = "") -> None:
    atomic_write_bytes(path, text.encode("utf-8"), site=site)


def exists(path) -> bool:
    path = str(path)
    if not is_remote_path(path):
        return os.path.exists(path)
    try:
        import fsspec
    except ImportError:
        return False
    fs, rel = fsspec.core.url_to_fs(path)
    return fs.exists(rel)
