"""Tensor specs: parameter accounting and initialization (single device)."""
