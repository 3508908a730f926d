"""Continuous-batching adaptive serving engine (single device)."""
