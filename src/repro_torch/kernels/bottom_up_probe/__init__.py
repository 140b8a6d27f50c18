"""Bottom-up probe kernel (paper Listing 1)."""
