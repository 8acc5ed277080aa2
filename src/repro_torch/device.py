"""Explicit device resolution for the port's backends.

``cuda`` and ``torch`` backends place their operands on a torch device;
``cuda`` requires a CUDA device and raises without one, ``torch`` runs
its plain versions wherever the caller puts it.  Nothing here falls back
to another device.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional, Union

import torch

BACKENDS = ("cuda", "torch", "numpy")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def resolve_device(backend: str,
                   device: Union[None, str, torch.device] = None
                   ) -> Optional[torch.device]:
    """The torch device a backend runs on (None for ``numpy``).

    ``device=None`` means the CUDA device for ``cuda`` and ``torch``.
    Raises when the backend needs a CUDA device that is not there, or
    when ``cuda`` is asked to run on a non-CUDA device.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend == "numpy":
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"backend={backend!r} needs a CUDA device and none is "
                "available; pass backend='torch', device='cpu' or "
                "backend='numpy' to run on the host")
    elif backend == "cuda":
        raise ValueError(f"backend='cuda' runs on a CUDA device, not {dev}")
    return dev


def nvcc_path() -> Optional[str]:
    """The CUDA compiler, from ``$NVCC``, ``PATH`` or the toolkit's
    default location; None when there is none."""
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), NVCC_DEFAULT):
        if cand and os.path.exists(cand):
            return cand
    return None


def has_nvcc() -> bool:
    return nvcc_path() is not None
