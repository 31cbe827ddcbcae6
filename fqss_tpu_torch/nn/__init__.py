"""Quantized layers in NCT layout."""
