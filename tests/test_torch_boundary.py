"""The port stands apart from the JAX package: importing it loads no JAX,
and its card smoke test refuses to run, and reports no result, without a
card."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_loads_no_jax():
    r = _run(["-c", "import sys, betacores_tpu_torch, betacores_tpu_torch.ops.kernels, "
                    "betacores_tpu_torch.ops._build, betacores_tpu_torch.parallel, "
                    "betacores_tpu_torch.valuation, betacores_tpu_torch.valuation.shapley, "
                    "betacores_tpu_torch.coresets.groups, betacores_tpu_torch.coresets.bpsvi, "
                    "betacores_tpu_torch.coresets.psvi, betacores_tpu_torch.coresets.dpbpsvi, "
                    "betacores_tpu_torch.models.neural_linear, betacores_tpu_torch.data.loaders, "
                    "betacores_tpu_torch.data.perturb, betacores_tpu_torch.inference.hmc, "
                    "betacores_tpu_torch.inference.nuts, betacores_tpu_torch.inference.shf, "
                    "betacores_tpu_torch.inference.diagnostics, "
                    "betacores_tpu_torch.inference.escalation, "
                    "betacores_tpu_torch.coresets.streaming, "
                    "betacores_tpu_torch.data.native_loader, "
                    "betacores_tpu_torch.utils.checkpoint, betacores_tpu_torch.utils.profiling, "
                    "betacores_tpu_torch.parallel.groups, betacores_tpu_torch.parallel.bpsvi_batch\n"
                    "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
                    " or m == 'betacores_tpu' or m.startswith('betacores_tpu.')]\n"
                    "assert not bad, bad\n"
                    "assert 'triton' not in sys.modules"])
    assert r.returncode == 0, r.stderr


def test_port_sources_never_import_jax():
    paths = list((ROOT / "betacores_tpu_torch").rglob("*.py"))
    # the group, pseudo-coreset and valuation slice, the neural-linear
    # slice, the MCMC and flow slice, the streaming and I/O slice and the
    # rest of parallel/ are among them
    names = {p.relative_to(ROOT / "betacores_tpu_torch").as_posix() for p in paths}
    assert {"valuation/__init__.py", "valuation/shapley.py", "coresets/groups.py",
            "coresets/bpsvi.py", "coresets/psvi.py", "coresets/dpbpsvi.py",
            "models/neural_linear.py", "data/loaders.py", "data/perturb.py",
            "inference/hmc.py", "inference/nuts.py", "inference/shf.py",
            "inference/diagnostics.py", "inference/escalation.py", "coresets/streaming.py",
            "data/native_loader.py", "utils/checkpoint.py", "utils/profiling.py",
            "parallel/groups.py", "parallel/bpsvi_batch.py"} <= names
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert not words[1].startswith(("jax", "flax", "optax", "betacores_tpu.")), (
                    path, line)
                assert words[1] != "betacores_tpu", (path, line)


def test_chip_smoke_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a card is present: chip_smoke.py would run for real")
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout + r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script fails and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout + r.stderr
