"""Graph500 generator, validator and harness (port of ``repro.graph``)."""
