"""The benchmark of the PyTorch/CUDA port (betacores_tpu_torch): one cell
per model configuration and traffic mix, run by ``run.py``. The data
generators, the plain reference, the comparison, the peaks and bounds and
the trace arithmetic live here, where the program cannot move them."""
