"""Synthetic data (``repro/data``)."""
