"""What the ported drivers share: the two flags the port adds, generators
seeded as the JAX drivers derive their keys, and host copies."""

from __future__ import annotations

import numpy as np
import torch


def add_port_flags(ap) -> None:
    """``--device`` (where every tensor lives; the card by default) and
    ``--seed`` (an offset of every generator seed, 0 by default)."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="offset of every generator seed (the JAX driver derives its "
                         "keys from --trial and constants)")


def keyed(args, s: int, device=None) -> torch.Generator:
    """A generator on ``device`` (default ``args.device``) seeded with
    ``s``, where the JAX driver takes ``jax.random.key(s)``."""
    dev = args.device if device is None else device
    return torch.Generator(device=dev).manual_seed(int(s) + 1_000_003 * int(args.seed))


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
