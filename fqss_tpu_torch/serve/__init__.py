"""Serving: weight folding."""
