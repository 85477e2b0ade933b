"""Runnable examples of the port, twins of the reference's ``examples/``
scripts: ``python -m repro_torch.examples.quickstart`` and ``python -m
repro_torch.examples.long_context_serving`` (``--device cpu`` to run
them without a card)."""
