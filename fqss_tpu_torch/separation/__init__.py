"""Splitter/combiner and OLA chunked inference."""
