"""Runnable examples of the port, counterparts of the JAX package's
``examples/``: ``python -m repro_torch.examples.<name>`` (on the card by
default, ``--device cpu`` on the CPU)."""
