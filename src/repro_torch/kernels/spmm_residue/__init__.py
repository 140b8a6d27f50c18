"""Residue fold of the ELL sum aggregation (rows deeper than k_max)."""
