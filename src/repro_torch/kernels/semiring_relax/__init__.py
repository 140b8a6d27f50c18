"""Masked min-plus gather-relax kernel (the tropical MAX_POS probe)."""
