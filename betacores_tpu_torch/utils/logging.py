"""Per-instance logging (counterpart of betacores_tpu/utils/logging.py).

Each algorithm instance gets a logger tagged ``<name>-<hex6>`` with the
format ``levelname - id.funcName(): message``; the default level is ERROR
and ``set_verbosity`` changes it. The port logs under its own root,
``betacores_tpu_torch``.
"""

from __future__ import annotations

import logging
import secrets

LOGLEVELS = {
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "critical": logging.CRITICAL,
    "info": logging.INFO,
    "debug": logging.DEBUG,
}

_FMT = "%(levelname)s - %(id)s.%(funcName)s(): %(message)s"

_root = logging.getLogger("betacores_tpu_torch")
if not _root.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(_FMT))
    _root.addHandler(_h)
    _root.setLevel(logging.ERROR)
    _root.propagate = False


def set_verbosity(verbosity: str = "error") -> None:
    if verbosity not in LOGLEVELS:
        raise ValueError(f"verbosity must be one of {sorted(LOGLEVELS)}")
    _root.setLevel(LOGLEVELS[verbosity])


def get_logger(name: str) -> logging.LoggerAdapter:
    """Per-instance logger tagged ``<name>-<hex6>``."""
    return logging.LoggerAdapter(_root, {"id": f"{name}-{secrets.token_hex(3)}"})
