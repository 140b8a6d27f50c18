"""Training loop and checkpoints (port of ``repro.train``)."""
