"""Device choice for the port's entry points.

The port runs on the card.  ``resolve_device(None)`` is ``cuda`` when a
card is present and raises otherwise: a serving process that silently
dropped to the CPU would answer 100x slower and say nothing about it.
The CPU is a device the caller names (the tests do, and the CLI's and
the sklearn wrappers' callers through ``device_type=cpu``), never a
fallback.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda[:i]"``/``torch.device`` as
    given.  Raises ``RuntimeError`` when a CUDA device is asked for (or
    defaulted to) and ``torch.cuda.is_available()`` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lightgbmv1_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: expected cuda or cpu")
    return dev


def knob_device(device_type) -> torch.device:
    """The device the ``device_type`` knob (alias ``device``) names, for
    the entry points that take knobs rather than a ``device`` argument
    (the CLI, the sklearn wrappers): ``cpu`` the CPU; any other value,
    the JAX package's default ``tpu`` and no value included, the card."""
    if str(device_type or "").strip().lower() == "cpu":
        return resolve_device("cpu")
    return resolve_device(None)
