"""Recommender models (port of ``repro.models.recsys``): DIEN."""
