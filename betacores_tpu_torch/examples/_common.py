"""What the ported drivers share: the two flags the port adds, generators
seeded as the JAX drivers derive their keys, host copies, the card's name
and power limit beside every printed time, the card's peaks, and the
``--mesh DxS`` parse."""

from __future__ import annotations

import numpy as np
import torch


def add_port_flags(ap, seed: bool = True) -> None:
    """``--device`` (where every tensor lives; the card by default) and
    ``--seed`` (an offset of every generator seed, 0 by default; left out
    with ``seed=False`` for a driver whose JAX script has a ``--seed`` of
    its own)."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    if not seed:
        return
    ap.add_argument("--seed", type=int, default=0,
                    help="offset of every generator seed (the JAX driver derives its "
                         "keys from --trial and constants)")


def keyed(args, s: int, device=None) -> torch.Generator:
    """A generator on ``device`` (default ``args.device``) seeded with
    ``s``, where the JAX driver takes ``jax.random.key(s)``."""
    dev = args.device if device is None else device
    return torch.Generator(device=dev).manual_seed(seed_of(args, s))


def host(x) -> np.ndarray:
    """A tensor (or anything array-like) as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sync(device) -> None:
    """Waits for the card's queued work (a host clock around it then times
    the work), nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# the card's peaks that every roofline of the port is stated against (NVIDIA
# H100 SXM: dense float32 without TF32, HBM3), as chip_smoke.py states its
# kernels' bounds
PEAK_FLOPS = 67e12
PEAK_BW = 3.35e12

_DEVICE_LINES: dict = {}


def device_line(device) -> str:
    """Where a printed time was taken: on a card its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (the name alone where nvidia-smi is missing), else "the CPU"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "the CPU"
    if dev not in _DEVICE_LINES:
        import subprocess

        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        try:
            out = subprocess.run(["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60, check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            out = f"{torch.cuda.get_device_name(idx)}, power limit not read"
        _DEVICE_LINES[dev] = out
    return _DEVICE_LINES[dev]


def seed_of(args, s: int) -> int:
    """The integer seed ``keyed`` gives a generator, for the classes and
    builds that take an integer seed where the JAX driver passes one."""
    return int(s) + 1_000_003 * int(args.seed)


def parse_mesh(text: str) -> tuple:
    """(n_data, n_samp) of a DATAxSAMP flag, with the JAX drivers' error."""
    try:
        shape = tuple(int(t) for t in text.split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise SystemExit(f"--mesh must be DATAxSAMP (e.g. 8x1), got {text!r}")
    return shape
