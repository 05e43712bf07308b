"""Analytical cost models."""
