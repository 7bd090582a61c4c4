"""Serving tiers of the port."""
