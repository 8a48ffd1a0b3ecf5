"""Per-layer metric readers, one module per metric of BENCHMARK.json's
``per_layer``, found by the metric's name. Each has ``read(run)``, which
takes the finished run (harness.py::RunData) and returns the metric's value
or None when the run holds nothing it reads; the harness then leaves the
metric out of the result line."""
