"""Experiment configuration and sweep grids (counterpart of
betacores_tpu/config.py, copied: the port imports nothing of the JAX
package).

Replaces the reference's positional sys.argv CLIs + bash cartesian sweeps +
``linearize()`` index maps (reference zellner_logreg/main.py:15-21,
zellner_neural_linear/main.py:11-26, run.sh files) with dataclass configs
and a grid enumerator for cluster array jobs.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Sequence


def linearize(grid: Dict[str, Sequence[Any]]) -> List[Dict[str, Any]]:
    """Enumerate a {name: values} grid into an index -> config-dict list
    (the reference's ``linearize``, zellner_neural_linear/main.py:11-26).

    The build-time knobs themselves live in ONE place each — the library's
    ``IncrementalConfig``/``BPSVIConfig``/``HMCConfig`` dataclasses and the
    drivers' argparse defaults (a parallel driver-level config dataclass
    existed here through round 3 but was never wired and could only drift;
    removed)."""
    keys = list(grid)
    return [dict(zip(keys, vals)) for vals in itertools.product(*(grid[k] for k in keys))]
