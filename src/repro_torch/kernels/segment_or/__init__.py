"""Fused row-parallel lane-word OR (the packed steps' segmented OR)."""
