"""collective_mib (MiB): the bytes rank 0 handed to the mesh's collectives
in the profiled selection (each all-reduce's tensor, each all_gather's own
part), from the program's counter ``mesh.bytes``
(betacores_tpu_torch/parallel/mesh.py, on while a profiler runs; a
collective in a replayed CUDA graph counts at each replay), over every
span, per profiled selection. Nothing when the program counts no
collective bytes (one card, or a program without the counter)."""


def read(run):
    from betacores_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None or not run.profiled:
        return None
    total = sum(n for (name, _), n in snapshot().counters.items() if name == "mesh.bytes")
    if not total:
        return None
    return total / 2 ** 20 / len(run.profiled)
