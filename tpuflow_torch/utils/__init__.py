"""Tracing and state carry-across helpers."""
