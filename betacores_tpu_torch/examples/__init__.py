"""The experiment drivers, ported (counterparts of the scripts in the
repository's ``examples/``). Each runs as
``python -m betacores_tpu_torch.examples.<name>`` with the JAX driver's
flags and defaults, writes the JAX driver's results file (name, config tag,
pickle keys and the layout of each value), and adds ``--device`` (default
``cuda``) and ``--seed`` (an offset of every generator the driver seeds,
default 0). Each exposes ``main(argv=None)``."""
