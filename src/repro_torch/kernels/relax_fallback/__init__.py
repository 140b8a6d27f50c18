"""Residue fold of the tropical gather-relax (rows deeper than max_pos)."""
