"""Synthetic streams and crop pixel differencing."""
