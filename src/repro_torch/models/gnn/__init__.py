"""Graph neural networks (port of ``repro.models.gnn``)."""
