"""Synthetic data for the port's transformer paths."""
