"""Fault tolerance: checkpoints and elastic recovery."""
