"""Eval metrics and run logging."""
