"""Tsetlin Machine, confidence and cluster aggregation (paper §4)."""
