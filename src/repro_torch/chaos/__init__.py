"""Fault taxonomy and protection-surface registry (registry only so far)."""
