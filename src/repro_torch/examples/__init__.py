"""The reference's ``examples/`` on the port: each module has a
``main(device=None, ...)`` with the reference script's sizes as defaults
and runs as ``python -m repro_torch.examples.<name> [--device cpu]``."""
