"""Lazy package namespaces: a package's names resolve on first use, so that
importing one module of the port (e.g. ``utils.export`` to load a program)
imports neither the model families nor the builders."""

from __future__ import annotations

import importlib
from typing import Dict, Iterable


def lazy_namespace(package: str, names: Dict[str, Iterable[str]], submodules: Iterable[str]):
    """(__getattr__, __dir__) for ``package``: each name of ``names[mod]``
    comes from ``package.mod`` at first access, each of ``submodules`` is
    the submodule itself."""
    where = {name: mod for mod, group in names.items() for name in group}
    subs = frozenset(submodules)

    def __getattr__(name: str):
        if name in subs:
            return importlib.import_module(f"{package}.{name}")
        mod = where.get(name)
        if mod is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        return getattr(importlib.import_module(f"{package}.{mod}"), name)

    def __dir__():
        return sorted(set(where) | subs)

    return __getattr__, __dir__
