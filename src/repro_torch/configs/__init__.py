"""Architecture registry and shapes (port of ``repro.configs``)."""
