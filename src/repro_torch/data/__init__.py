"""Deterministic, resumable synthetic-text data pipeline."""
