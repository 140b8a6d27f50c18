"""Graph substrate and single-source BFS steps (port of ``repro.core``)."""
