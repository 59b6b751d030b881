"""Datasets and per-round client sampling."""
