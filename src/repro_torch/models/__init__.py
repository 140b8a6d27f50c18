"""Models (port of ``repro.models``): the GCN slice so far."""
