"""Trunk, heads, model zoo and the flat weight-format bridge."""
