"""The device mesh on ``torch.distributed`` (counterpart of
betacores_tpu/parallel/mesh.py).

The framework's two parallel axes:
  * ``data`` shards the dataset's N rows: local candidate scoring, a
    distributed greedy argmax, and a psum for each Sigma-over-N term;
  * ``samp`` shards the S posterior samples of the projections: every
    inner product over S becomes a psum over ``samp``.

One process per rank. Rank r sits at (ax_d, ax_s) with
r = ax_d * n_samp + ax_s, the layout of the reference's
``devices.reshape(n_data, n_samp)``. ``make_mesh`` makes one process group
per ``data`` line (the ranks that share ax_s) and one per ``samp`` line (the
ranks that share ax_d), each in axis order; ``LANE_AXES`` names the whole
mesh, both axes at once, in rank order (the lane split of the reference's
``P((DATA_AXIS, SAMP_AXIS))``: BPSVI lanes, MCMC chains, flow lanes and
Shapley permutations). The collectives go through ``torch.distributed``
even on an axis of size 1; a backend that cannot serve a tensor's device
raises instead of copying through the host.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import os
import tempfile
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SAMP_AXIS = "samp"
LANE_AXES = (DATA_AXIS, SAMP_AXIS)

# the devices each backend serves; anything else raises (gloo, for one,
# has no all_gather on CUDA tensors)
_BACKEND_DEVICES = {"gloo": "cpu", "nccl": "cuda"}


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in an (n_data, n_samp) mesh, the groups of its two
    axis lines, its device, and a count of the collectives it has run
    (``calls["psum"]``, ``calls["all_gather"]``)."""

    n_data: int
    n_samp: int
    ax_d: int
    ax_s: int
    device: torch.device
    groups: dict
    calls: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, SAMP_AXIS: self.n_samp,
                LANE_AXES: self.n_data * self.n_samp}

    @property
    def rank(self) -> int:
        return self.ax_d * self.n_samp + self.ax_s

    def _group(self, axis: str, x: torch.Tensor):
        group = self.groups[axis]
        backend = dist.get_backend(group)
        if _BACKEND_DEVICES.get(backend) != x.device.type:
            raise ValueError(f"the {backend} backend does not serve {x.device.type} "
                             f"tensors (axis {axis!r})")
        return group

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """The sum of ``x`` over the ranks of this rank's ``axis`` line
        (``LANE_AXES``: every rank), as a new tensor (``x`` is left
        alone)."""
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self._group(axis, x))
        self.calls["psum"] += 1
        return out

    def all_gather(self, x: torch.Tensor, axis) -> torch.Tensor:
        """(axis size, *x.shape): ``x`` of every rank of this rank's
        ``axis`` line, stacked in axis order (``LANE_AXES``: every rank's,
        in rank order)."""
        group = self._group(axis, x)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=group)
        self.calls["all_gather"] += 1
        return torch.stack(parts)


def require_axes(mesh) -> Tuple[int, int]:
    """(data-axis size, samp-axis size) of a mesh made by ``make_mesh``,
    with a descriptive error for anything else."""
    shape = getattr(mesh, "shape", None)
    if not isinstance(shape, dict) or DATA_AXIS not in shape or SAMP_AXIS not in shape:
        raise ValueError(f"mesh must have axes ('{DATA_AXIS}', '{SAMP_AXIS}'): use "
                         f"parallel.make_mesh(n_data, n_samp) (n_samp=1 is fine)")
    return shape[DATA_AXIS], shape[SAMP_AXIS]


def make_mesh(n_data: int, n_samp: int = 1,
              device: Optional[torch.device | str] = None) -> Mesh:
    """This rank's ``Mesh`` over an initialised process group of exactly
    n_data * n_samp ranks. Every rank must call it, in the same order as
    any other group creation (it creates n_samp + n_data groups). The
    device defaults to the backend's: ``cuda:<rank % device count>`` under
    nccl, the CPU under gloo."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError("make_mesh needs an initialised torch.distributed "
                         "process group (init_process_group)")
    world = dist.get_world_size()
    if n_data < 1 or n_samp < 1 or world != n_data * n_samp:
        raise ValueError(f"a ({n_data}, {n_samp}) mesh needs {n_data * n_samp} "
                         f"ranks, the process group has {world}")
    rank = dist.get_rank()
    ax_d, ax_s = divmod(rank, n_samp)
    groups = {}
    for s in range(n_samp):        # data lines: ranks sharing ax_s
        g = dist.new_group([d * n_samp + s for d in range(n_data)])
        if s == ax_s:
            groups[DATA_AXIS] = g
    for d in range(n_data):        # samp lines: ranks sharing ax_d
        g = dist.new_group([d * n_samp + s for s in range(n_samp)])
        if d == ax_d:
            groups[SAMP_AXIS] = g
    groups[LANE_AXES] = dist.group.WORLD       # the world is the mesh, in rank order
    if device is None:
        if dist.get_backend() == "nccl":
            device = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            device = torch.device("cpu")
    return Mesh(n_data, n_samp, ax_d, ax_s, torch.device(device), groups)


@contextlib.contextmanager
def world_of_one(backend: str):
    """This process as the only rank of a ``backend`` process group ("nccl"
    for a card, "gloo" for the CPU), met through a FileStore in a temporary
    directory, so it needs no launcher and no network; destroyed on exit.
    The (1, 1) mesh made inside it drives the sharded build on one device."""
    if backend == "nccl":
        # one rank still bootstraps over a socket: keep it on the loopback
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            yield
        finally:
            dist.destroy_process_group()


def auto_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Favour the data axis; give the sample axis a factor of 2 when even."""
    if n_devices % 2 == 0 and n_devices > 2:
        return n_devices // 2, 2
    return n_devices, 1


def lane_block(n_lanes: int, mesh: Mesh) -> Tuple[int, int, int]:
    """(padded lane count, this rank's first lane, lanes per rank): the
    lanes padded up to a multiple of the mesh's rank count and split into
    equal contiguous blocks in rank order, as the reference shards a lane
    axis over ``P((DATA_AXIS, SAMP_AXIS))``."""
    n_ranks = mesh.n_data * mesh.n_samp
    per = -(-n_lanes // n_ranks)
    return per * n_ranks, mesh.rank * per, per


def gather_lanes(mesh: Mesh, parts, n_lanes: int) -> list:
    """Every rank's lanes of each tensor of ``parts`` (this rank's block of
    ``lane_block``'s split, the lane axis first), in lane order, with the
    padding lanes (from ``n_lanes`` on) dropped: one all_gather over both
    axes of the parts packed in float64, which holds every float32 and
    float64 value, integer below 2^53 and bool exactly."""
    per = parts[0].shape[0]
    packed = torch.cat([p.reshape(per, -1).double() for p in parts], dim=1)
    every = mesh.all_gather(packed, LANE_AXES).flatten(0, 1)[:n_lanes]
    out, at = [], 0
    for p in parts:
        k = p[0].numel()
        out.append(every[:, at:at + k].reshape((n_lanes,) + tuple(p.shape[1:])).to(p.dtype))
        at += k
    return out


def _local_block(x: torch.Tensor, mesh: Mesh, pad=0) -> torch.Tensor:
    """This rank's block of ``x``'s rows after padding N up to a multiple
    of the data-axis size with rows of ``pad``, on the mesh's device."""
    N = x.shape[0]
    rows = -(-N // mesh.n_data)
    lo = min(N, mesh.ax_d * rows)
    hi = min(N, lo + rows)
    out = torch.full((rows,) + tuple(x.shape[1:]), pad, dtype=x.dtype, device=mesh.device)
    out[:hi - lo] = x[lo:hi]
    return out


def shard_data(data: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, int]:
    """(this rank's row block of ``data``, N). N is padded up to a multiple
    of the data-axis size with zero rows (the last shards hold them); the
    ranks of one ``samp`` line hold the same block."""
    return _local_block(data, mesh), data.shape[0]


def shard_group_ids(gid: torch.Tensor, mesh: Mesh, n_groups: int) -> torch.Tensor:
    """This rank's block of an (N,) group-id vector, split as ``shard_data``
    splits the rows; padding rows get id ``n_groups``, the segment every
    group reduction drops, so they join no group."""
    return _local_block(gid.to(torch.int64), mesh, pad=n_groups)


def shard_weights(u: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of an (N,) base-data weight vector, padded with
    zeros exactly as ``shard_data`` pads the rows: zero-weight rows are
    masked out of the target and of the candidate argmax."""
    return _local_block(u, mesh)
