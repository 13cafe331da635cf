"""Federated learning runtime."""
