"""The import rules: a run holds no JAX and no JAX package (top-level names
compared whole), and the reference and the generators import nothing of
the program."""

import subprocess
import sys
from pathlib import Path

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]


def test_names_are_compared_whole(monkeypatch):
    fake = dict(sys.modules)
    fake.update({"betacores_tpu_torch.ops": None, "jaxtyping": None, "flaxen": None})
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    fake.update({"betacores_tpu.models": None, "jaxlib": None})
    assert harness.forbidden_modules() == ["betacores_tpu", "jaxlib"]


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_and_generators_import_nothing_of_the_program():
    code = """
import sys, torch
sys.path.insert(0, '.')
from benchmark import compare, peaks, reference, trace
from benchmark.families import logreg, multiclass
from benchmark.reference import Reference, RefState
gen = torch.Generator().manual_seed(1)
for fam, cfg in ((logreg, {"n_rows": 256, "d": 4, "f_rate": 0.1}),
                 (multiclass, {"n_rows": 256, "d": 4, "n_classes": 3, "spread": 2.0,
                               "f_rate": 0.2})):
    data = fam.make_data(gen, cfg)
    full = dict(cfg, projection_dim=8, n_newton=4, dtype="float32", i0=1.0)
    ref = Reference(fam.reference_model(full), data, full)
    p = fam.theta_dim(cfg)
    st = RefState(torch.zeros(4), torch.full((4,), -1), torch.zeros(4, data.shape[1]), 0, 0.3,
                  torch.zeros(p))
    out = ref.select(st, torch.randn(8, p), None)
    ref.refine(out.state, torch.randn(3, 8, p), torch.randint(0, 256, (3, 16)))
mods = {m.split('.')[0] for m in sys.modules}
print(sorted(mods & {'betacores_tpu_torch', 'betacores_tpu', 'jax', 'jaxlib', 'flax'}))
"""
    assert _python(code) == "[]"


def test_a_run_loads_no_jax():
    code = """
import sys
sys.path.insert(0, '.')
from benchmark import harness
from benchmark.tests.tiny import tiny_run
res = tiny_run('multiclass.full_select')
print(res['correct'], harness.forbidden_modules(), 'betacores_tpu_torch' in sys.modules)
"""
    assert _python(code) == "True [] True"
