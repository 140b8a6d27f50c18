"""ELL-slab sum aggregation kernel (SpMM over the first k_max slots)."""
