"""Iteration rules."""
