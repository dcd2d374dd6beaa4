"""Compute-dtype policy."""
