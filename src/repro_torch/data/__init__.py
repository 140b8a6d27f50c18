"""Synthetic, step-keyed data pipelines (port of ``repro.data``)."""
