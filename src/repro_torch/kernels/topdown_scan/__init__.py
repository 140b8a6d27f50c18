"""Top-down edge scan kernel, fused with the scatter-min."""
