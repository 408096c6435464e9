"""The port's twins of the reference's ``examples/``; each runs as
``python -m repro_torch.examples.<name>`` on CUDA, or on the CPU with
``--device cpu``."""
