"""Serving engine."""
