"""Every public name of the JAX package resolves in the port: each
``__all__`` of betacores_tpu/**/__init__.py, read with ``ast`` (so JAX is
not imported), must name an attribute of the port's package of the same
path (betacores_tpu -> betacores_tpu_torch). The port's namespaces are lazy
(betacores_tpu_torch/_lazy.py), so each name is also imported here.

The exceptions are the names the port does not carry by design (ROADMAP
Queue A item 16, "do not port"), each with its reason."""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = sorted(os.path.relpath(dirpath, ROOT)
                  for dirpath, _, files in os.walk(os.path.join(ROOT, "betacores_tpu"))
                  if "__init__.py" in files and "__pycache__" not in dirpath)

NOT_PORTED = {
    # utils/cache.py turns on the XLA compile cache; torch has no counterpart
    # to port (ROADMAP Queue A item 16)
    ("betacores_tpu.utils", "enable_persistent_cache"),
}


def _all_of(package_dir: str) -> list:
    tree = ast.parse(open(os.path.join(ROOT, package_dir, "__init__.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


def test_every_package_is_read():
    assert "betacores_tpu" in PACKAGES and os.path.join("betacores_tpu", "ops") in PACKAGES
    assert len(PACKAGES) >= 11


@pytest.mark.parametrize("package_dir", PACKAGES)
def test_every_public_name_resolves_in_the_port(package_dir):
    jax_mod = package_dir.replace(os.sep, ".")
    names = _all_of(package_dir)
    port = importlib.import_module(jax_mod.replace("betacores_tpu", "betacores_tpu_torch", 1))
    missing = [n for n in names if (jax_mod, n) not in NOT_PORTED and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"
    for pkg, name in NOT_PORTED:
        if pkg == jax_mod:
            assert name in names, f"{pkg}.{name} is no longer public: drop its exception"


def test_sample_laplace_transforms_the_generators_normals():
    """``inference.sample_laplace(generator, lap, n)`` is
    ``sample_laplace_from_noise`` of (n, d) normals drawn from the
    generator in the fit's dtype, as the JAX function draws from its key."""
    import torch

    from betacores_tpu_torch.inference import (LaplaceApprox, sample_laplace,
                                               sample_laplace_from_noise)

    g = torch.Generator().manual_seed(0)
    L = torch.tril(torch.rand(3, 3, generator=g, dtype=torch.float64)) + torch.eye(3)
    lap = LaplaceApprox(mu=torch.rand(3, generator=g, dtype=torch.float64), prec_chol=L)
    got = sample_laplace(torch.Generator().manual_seed(5), lap, 7)
    z = torch.randn((7, 3), generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    assert got.dtype == torch.float64 and torch.equal(got, sample_laplace_from_noise(lap, z))
