"""One run of one cell of the port's benchmark (``run.py`` is the command).

A cell (BENCHMARK.json ``workloads``) names a configuration
(``configs/<name>.json``: the model family, the data's sizes and the build's
hyperparameters), a traffic mix (``traffic/<name>.json``: which route the
build takes: select over a subsample, every row or every group; refinement
on a subsample or every row) and its limits (``limits/<cell>.json``). The
family (``families/<family>.py``) makes the data, builds the system under
test and gives the plain reference its model; each per-layer metric is read
by ``metrics/<metric>.py``. Adding a cell or a metric adds such files and
BENCHMARK.json entries; this file stays.

A run:

1. set-up: the data and every draw of one build (the select noise and
   candidates, each refinement pass's noise and rows) from ``--seed``, on
   the card; the port's builder over the data, with the draws handed in
   through its ``FixedDraws`` seam; one selection from the empty state,
   which builds or loads the kernels, makes the pass's buffers and
   captures its CUDA graph. Then the peak memory counter is reset.
2. the window: ``select`` then ``optimize``, the calls the port's ``build``
   makes, selection after selection, from the empty state again (and the
   same draws) each time the configuration's build length is reached; it
   ends at the first selection boundary after ``--seconds``, on a
   synchronisation with the card. It keeps the states of the few
   selections the check compares (compare.py ``Kept``), and nothing that
   grows with the number of selections. With ``--trace 1`` each call sits
   in a span (CUDA events and a profiler range), and one whole selection,
   the window's second, is profiled.
3. the check (compare.py), once the program is freed, and the result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import random
import subprocess
import sys
import time
from importlib import import_module
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from . import compare
from . import trace as tracing
from .reference import Reference, RefState, as_ref_state

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "betacores_tpu")
# the window's selection that the traced run profiles (the first starts
# from the empty state)
PROFILED = 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules, each compared
    whole (betacores_tpu_torch is not betacores_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def resolve_route(cfg: dict, traffic: dict) -> dict:
    """The build a cell runs: its length, buffer, steps, subsample sizes
    (None: every row or group) and group layout."""
    N = int(cfg["n_rows"])
    sel_all, opt_all = traffic["select"] == "all", traffic["refine"] == "all"
    route = {"groups": bool(traffic["groups"]), "refit_every": int(traffic["refit_every"]),
             "n_opt": None if opt_all else int(cfg["n_subsample_opt"])}
    if traffic["groups"]:
        g = cfg["groups"]
        G = int(g["n_groups"])
        per = N // G
        route.update(n_groups=G, group_rows=per, selections=int(g["selections"]),
                     buffer_slots=int(g["buffer_groups"]) * per, opt_itrs=int(g["opt_itrs"]),
                     n_select=None if sel_all else int(g["n_subsample_select"]))
    else:
        route.update(n_groups=None, group_rows=1, selections=int(cfg["selections"]),
                     buffer_slots=int(cfg["buffer_slots"]), opt_itrs=int(cfg["opt_itrs"]),
                     n_select=None if sel_all else int(cfg["n_subsample_select"]))
    return route


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


class Cell:
    """A workload of BENCHMARK.json with its files. ``overrides`` replaces
    keys of the configuration (the CPU tests shrink it)."""

    def __init__(self, name: str, bench: Optional[dict] = None,
                 overrides: Optional[dict] = None):
        bench = bench if bench is not None else load_json(REPO / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        w = cells[name]
        entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.name, self.chips = name, int(w["chips"])
        self.config = _merge(load_json(REPO / entry["file"]), overrides or {})
        self.traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.family = import_module(f"{__package__}.families.{self.config['family']}")
        self.route = resolve_route(self.config, self.traffic)
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]


class Inputs(NamedTuple):
    """The data and one build's draws: select noise (M, S, p) and candidates
    (M, n_sel) or None; refinement noise (M, T, S, p) and rows (M, T, n_opt)
    or None."""

    data: torch.Tensor
    sel_z: torch.Tensor
    sel_idx: Optional[torch.Tensor]
    opt_z: torch.Tensor
    opt_idx: Optional[torch.Tensor]


def make_inputs(cell: Cell, seed: int, device) -> Inputs:
    """Everything a run feeds the program, made on ``device`` from ``seed``
    in a few large calls: every seed gives the same sizes."""
    cfg, r, fam = cell.config, cell.route, cell.family
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    data = fam.make_data(gen, cfg)
    M, T, S, p = r["selections"], r["opt_itrs"], int(cfg["projection_dim"]), fam.theta_dim(cfg)
    N = data.shape[0]
    n_cand = r["n_groups"] if r["groups"] else N
    kw = dict(generator=gen, device=device)
    sel_z = torch.randn((M, S, p), dtype=torch.float32, **kw)
    sel_idx = (None if r["n_select"] is None
               else torch.randint(0, n_cand, (M, r["n_select"]), **kw))
    opt_z = torch.randn((M, T, S, p), dtype=torch.float32, **kw)
    opt_idx = None if r["n_opt"] is None else torch.randint(0, N, (M, T, r["n_opt"]), **kw)
    return Inputs(data, sel_z, sel_idx, opt_z, opt_idx)


def _draw(inputs: Inputs, it: int):
    return ((inputs.sel_z[it], None if inputs.sel_idx is None else inputs.sel_idx[it]),
            (inputs.opt_z[it], None if inputs.opt_idx is None else inputs.opt_idx[it]))


class PortImpl:
    """The system under test: the port's incremental (or group) builder on
    the cell's route, fed the benchmark's draws through ``FixedDraws``."""

    def __init__(self, cell: Cell, inputs: Inputs, device):
        from betacores_tpu_torch.coresets import (FixedDraws, IncrementalConfig,
                                                  init_group_state, init_state,
                                                  make_group_incremental_builder,
                                                  make_incremental_builder)
        from betacores_tpu_torch.ops.projection import Groups

        cfg, r, fam = cell.config, cell.route, cell.family
        ic = IncrementalConfig(projection_dim=int(cfg["projection_dim"]),
                               n_subsample_select=r["n_select"], n_subsample_opt=r["n_opt"],
                               opt_itrs=r["opt_itrs"], i0=float(cfg["i0"]), use_beta=True,
                               dedup_select=False, refit_every=r["refit_every"])
        model, sampler = fam.port_model(cfg), fam.port_sampler(cfg)
        core0 = init_state(r["buffer_slots"], fam.row_dim(cfg), beta=float(cfg["beta"]),
                           sampler_aux=torch.zeros(fam.theta_dim(cfg), device=device),
                           device=device)
        if r["groups"]:
            G, per = r["n_groups"], r["group_rows"]
            groups = Groups(members=torch.arange(G * per, device=device).reshape(G, per),
                            sizes=torch.full((G,), per, dtype=torch.int64, device=device))
            self.builder = make_group_incremental_builder(inputs.data, groups, model, sampler, ic)
            self.st0 = init_group_state(core0, G)
        else:
            self.builder = make_incremental_builder(inputs.data, model, sampler, ic)
            self.st0 = core0
        M = r["selections"]
        pairs = [_draw(inputs, i) for i in range(M)]
        self.draws = FixedDraws([s for s, _ in pairs], [o for _, o in pairs])

    def select(self, st, it: int):
        return self.builder.select(st, self.draws, it)

    def optimize(self, st, it: int):
        return self.builder.optimize(st, self.draws, it)

    def capture_stats(self) -> tuple:
        return self.builder.capture_stats()

    def close(self) -> None:
        self.builder = self.draws = self.st0 = None


def make_reference(cell: Cell, data, dtype) -> Reference:
    r = cell.route
    groups = (r["n_groups"], r["group_rows"]) if r["groups"] else None
    return Reference(cell.family.reference_model(cell.config), data, cell.config, dtype, groups,
                     cell.family.BLOCK_ROWS)


@contextlib.contextmanager
def matmul_precision(mode: str):
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(mode)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


class ReferenceImpl:
    """The plain reference in the program's place: the control, in float32
    with TF32 products (matmul precision "high"), the next precision below
    the configurations' float32 with TF32 off."""

    def __init__(self, cell: Cell, inputs: Inputs, device):
        r, cfg, fam = cell.route, cell.config, cell.family
        dtype = torch.float32
        self.ref, self.inputs = make_reference(cell, inputs.data, dtype), inputs
        buf, dev = r["buffer_slots"], inputs.data.device
        self.st0 = RefState(
            wts=torch.zeros(buf, dtype=dtype, device=dev),
            idcs=torch.full((buf,), -1, dtype=torch.int64, device=dev),
            pts=torch.zeros((buf, fam.row_dim(cfg)), dtype=dtype, device=dev), m=0,
            beta=float(cfg["beta"]), aux=torch.zeros(fam.theta_dim(cfg), dtype=dtype, device=dev),
            selected=(torch.zeros(r["n_groups"], dtype=torch.bool, device=dev)
                      if r["groups"] else None))

    def select(self, st, it: int):
        (z, idx), _ = _draw(self.inputs, it)
        with matmul_precision("high"):
            return self.ref.select(st, z, idx).state

    def optimize(self, st, it: int):
        _, (z, idx) = _draw(self.inputs, it)
        with matmul_precision("high"):
            return self.ref.refine(st, z, idx)

    def capture_stats(self) -> tuple:
        return 0, 0.0

    def close(self) -> None:
        self.ref = None


def _m_of(st):
    return getattr(st, "core", st).m


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class Window(NamedTuple):
    n: int                  # selections completed
    seconds: float          # wall time, first call to the closing synchronisation
    kept: list              # (index, (state before, after select, after optimize)), compare.Kept
    live: list              # (m before, m after select) of each selection of the build
    marks: list             # (before select, before optimize, after) CUDA events
    profiled: list          # window indices of the profiled selections
    trace: Optional[tracing.TraceData]


def drive(cell: Cell, impl, seconds: float, device, traced: bool, seed: int,
          min_selections: int = 1) -> Window:
    """The measured window (module docstring)."""
    M = cell.route["selections"]
    on_card = device.type == "cuda"
    prof = tracing.Profiled(device) if traced else None
    kept = compare.Kept(int(cell.traffic["compare_selections"]), random.Random(seed))
    # each selection's live counts, copied on the card (no wait for the host)
    live = torch.zeros((M, 2), dtype=torch.int64, device=device)
    marks, profiled = [], []
    span = (lambda name: torch.profiler.record_function(tracing.SPAN_PREFIX + name)) if traced \
        else (lambda name: contextlib.nullcontext())
    _sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    st, it, n = impl.st0, 0, 0
    while True:
        if prof is not None and n == PROFILED:
            prof.start()
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
              if traced and on_card else None)
        if ev:
            ev[0].record()
        with span("select"):
            st1 = impl.select(st, it)
        if ev:
            ev[1].record()
        with span("refine"):
            st2 = impl.optimize(st1, it)
        if ev:
            ev[2].record()
            marks.append(ev)
        if n < M:
            kept.offer(n, (st, st1, st2))
            live[n, 0], live[n, 1] = _m_of(st), _m_of(st1)
        n, it, st = n + 1, it + 1, st2
        if prof is not None and n == PROFILED + 1:
            prof.stop()
            profiled = [PROFILED]
        if it == M:
            st, it = impl.st0, 0
        tracing_open = prof is not None and n <= PROFILED
        if time.perf_counter() >= deadline and n >= min_selections and not tracing_open:
            break
    _sync(device)
    t1 = time.perf_counter()
    done = live[:min(n, M)].tolist()
    return Window(n, t1 - t0, kept.items(), [tuple(done[k % M]) for k in range(n)], marks,
                  profiled, None if prof is None else prof.read())


class RunData:
    """What the per-layer readers (metrics/*.py) read of a finished run."""

    def __init__(self, cell: Cell, window: Window, capture: tuple):
        self.config, self.route, self.family = cell.config, cell.route, cell.family
        self.window, self.capture, self.live = window, capture, window.live
        self.window_s = window.seconds
        self.trace = window.trace
        self.busy_s = 0.0 if window.trace is None else tracing.busy_seconds(window.trace.ops)
        self.profiled = [self.live[k] for k in window.profiled]
        self.notes: list = []

    def spans(self, kind: str) -> list:
        """(window index, milliseconds) of the ``select``, ``refine`` or whole
        ``selection`` spans of the selections outside the profiled ones,
        which the profiler slows."""
        a, b = {"select": (0, 1), "refine": (1, 2), "selection": (0, 2)}[kind]
        skip = set(self.window.profiled)
        return [(k, ev[a].elapsed_time(ev[b])) for k, ev in enumerate(self.window.marks)
                if k not in skip]

    def span_mean(self, kind: str) -> Optional[float]:
        """Mean milliseconds of the unprofiled ``select`` or ``refine`` spans."""
        times = [t for _, t in self.spans(kind)]
        return sum(times) / len(times) if times else None

    def note(self, msg: str) -> None:
        self.notes.append(msg)


NUMBERS = ("select_gap", "start_gap", "later_gap")


def _numbers(j: int, row: dict) -> dict:
    """The numbers of compare.py's docstring that selection ``j`` reads."""
    out = {"select_gap": row["select_gap"]}
    if j == 0:
        out["start_gap"] = max(row["select_gap"], row["weight_gap"])
    else:
        out["later_gap"] = row["weight_median_gap"]
    return out


def check(cell: Cell, inputs: Inputs, window: Window, log, witness: bool = False) -> tuple:
    """The comparison of compare.py on the window's kept selections:
    ({name: (value, limit)} for the numbers the cell's limits name, every
    number read, the selections compared, those that failed). ``witness``
    also logs the gaps of the reference run in float32 (TF32 off) from the
    same states: what float32 itself gives."""
    ref = make_reference(cell, inputs.data, torch.float64)
    ref32 = make_reference(cell, inputs.data, torch.float32) if witness else None
    rows = []
    for j, record in window.kept:
        before, sel, after = (as_ref_state(s) for s in record)
        (z, idx), (z_all, idx_all) = _draw(inputs, j)
        row = {"select_gap": compare.select_gap(ref.select(before, z, idx), before, sel,
                                                inputs.data, cell.route["group_rows"])}
        w_ref = ref.refine(sel, z_all, idx_all).wts
        row["weight_gap"], row["weight_median_gap"], worst = compare.weight_gaps(sel, after, w_ref)
        rows.append((j, row))
        detail = ""
        if worst >= 0:
            med = float(w_ref[:sel.m].abs().median())
            detail = (f"; widest at slot {worst}: reference {float(w_ref[worst])!r}, program "
                      f"{float(after.wts[worst])!r}, median |w| {med!r}")
        if ref32 is not None:
            w32 = ref32.refine(sel, z_all, idx_all).wts.to(torch.float32)
            g32 = compare.weight_gaps(sel, sel._replace(wts=w32), w_ref)
            detail += f"; float32 reference: widest {g32[0]!r} at slot {g32[2]}, median {g32[1]!r}"
        log(f"check: selection {j} (m {before.m} -> {sel.m}): "
            + ", ".join(f"{k} {v!r}" for k, v in row.items()) + detail)
    per = [_numbers(j, r) for j, r in rows]
    read = {k: max((p[k] for p in per if k in p), default=math.inf) for k in NUMBERS}
    limits = {k: float(cell.limits[k]["limit"]) for k in read if k in cell.limits}
    failed = sum(any(not (v <= limits[k]) for k, v in p.items() if k in limits) for p in per)
    checks = {k: (read[k], lim) for k, lim in limits.items()}
    return checks, read, len(rows), failed


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def run(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda", impl_factory=None, log=None, witness: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object. ``impl_factory``
    (cell, inputs, device) puts another implementation in the program's
    place (the control; a test's broken program)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    on_card = device.type == "cuda"
    torch.set_float32_matmul_precision("highest")      # float32, TF32 off
    torch.manual_seed(seed % (1 << 63))
    marks = [("start", t_start), ("imports", time.perf_counter())]
    inputs = make_inputs(cell, seed, device)
    _sync(device)
    marks.append(("inputs", time.perf_counter()))
    impl = (impl_factory or PortImpl)(cell, inputs, device)
    _sync(device)
    marks.append(("builder", time.perf_counter()))
    warm = impl.select(impl.st0, 0)                     # builds, buffers, the graph capture
    impl.optimize(warm, 0)
    del warm
    _sync(device)
    marks.append(("warm-up selection", time.perf_counter()))
    capture = impl.capture_stats()
    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    window = drive(cell, impl, seconds, device, traced, seed,
                   min_selections=int(cell.traffic["compare_selections"]))
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run_data = RunData(cell, window, capture)
    e2e = {"selection_ms": 1e3 * window.seconds / window.n,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    log("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                in zip(marks, marks[1:])))
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s, {window.n} selections in "
        f"{window.seconds:.3f} s, peak {peak} B, {capture[0]} graphs captured in "
        f"{capture[1]:.4f} s")
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = import_module(f"{__package__}.metrics.{m['name']}").read(run_data)
            if value is None:
                log(f"per-layer metric {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        for msg in run_data.notes:
            log(msg)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_rec = {"platform": "gpu" if on_card else device.type,
                  "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": window.n, "failed": 0, "metrics": metrics,
              "device": device_rec}
    if traced and window.trace is not None:
        device_rec["busy_s"] = run_data.busy_s
        device_rec["window_s"] = window.trace.wall_s
        result["breakdown"] = tracing.breakdown(window.trace)
    if on_card:
        log(f"card: {card_line()}")
    # the check runs on the window's recorded states once the program is freed
    impl.close()
    del impl, run_data
    window = window._replace(marks=[], trace=None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, read, compared, failed = check(cell, inputs, window, log, witness)
    log(f"check of {compared} selections took {time.perf_counter() - t_check:.3f} s")
    result["correct"] = compared > 0 and failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    result["failed"] = failed
    result["readings"] = read
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
