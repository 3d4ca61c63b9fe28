"""Solvers."""
