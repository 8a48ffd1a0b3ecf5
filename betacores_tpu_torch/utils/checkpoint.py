"""Coreset-state checkpoints (counterpart of betacores_tpu/utils/checkpoint.py).

A ``CoresetState``, with the state of the ``torch.Generator`` that drives
the build (where the reference keeps its PRNG key) and a dict of metadata,
is written with ``torch.save`` and read back with
``torch.load(weights_only=True)``, so a build can be stopped after k
selections and continued to the same result. A write goes to a temporary
file first and replaces the checkpoint with ``os.replace``: a crash leaves
the old checkpoint or the new one, never half of one. ``save_params`` /
``load_params`` do the same for any NamedTuple of tensors (e.g. the flow
parameters of inference/shf.py). ``config_tag`` is the reference's
config-encoding file-name fragment.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def config_tag(cfg: Dict[str, Any]) -> str:
    """Reference-style config-encoding filename fragment
    (zellner_neural_linear/main.py:212: results_<d>_<alg>_frate_<f>_...)."""
    return "_".join(f"{k}_{v}" for k, v in sorted(cfg.items()))


def _storable(extra: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``extra`` with numpy arrays and scalars as tensors, which
    ``torch.load(weights_only=True)`` reads (it refuses numpy objects)."""
    def conv(v):
        if isinstance(v, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(v))
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        return v

    return conv(dict(extra or {}))


def _atomic_save(payload: dict, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_state(path: str, state, key: Optional[torch.Generator] = None,
               extra: Optional[Dict[str, Any]] = None) -> None:
    """Writes the ``CoresetState`` ``state`` (its tensors copied to the
    host), the state of the generator ``key`` and its device, and ``extra``
    (numbers, strings, lists, dicts, tensors; numpy arrays are stored as
    tensors)."""
    payload = {"state": {k: v.detach().cpu() for k, v in state._asdict().items()},
               "extra": _storable(extra)}
    if key is not None:
        payload["key"] = key.get_state()
        payload["key_device"] = str(key.device)
    _atomic_save(payload, path)


def load_state(path: str, device: torch.device | str = "cuda"):
    """(CoresetState on ``device``, the generator or None, extra). The
    generator is made on the device it was saved from and set to the saved
    state, so it continues the saved stream."""
    from ..coresets.state import CoresetState     # utils is imported by coresets

    payload = torch.load(path, weights_only=True)
    st = CoresetState(**{k: v.to(device) for k, v in payload["state"].items()})
    key = None
    if "key" in payload:
        key = torch.Generator(device=torch.device(payload["key_device"]))
        key.set_state(payload["key"])
    return st, key, payload["extra"]


def save_params(path: str, params, extra: Optional[Dict[str, Any]] = None) -> None:
    """Writes a NamedTuple of tensors (e.g. an ``SHFParams`` flow); read it
    back with ``load_params(path, type(params))``."""
    payload = {"params": {k: v.detach().cpu() for k, v in params._asdict().items()},
               "extra": _storable(extra)}
    _atomic_save(payload, path)


def load_params(path: str, cls, device: torch.device | str = "cuda"):
    """(cls(**fields) with its tensors on ``device``, extra)."""
    payload = torch.load(path, weights_only=True)
    return (cls(**{k: v.to(device) for k, v in payload["params"].items()}),
            payload["extra"])
