"""Tensor specs (parameter accounting and initialization, single device), mesh scan axes, and bfloat16 gradient compression."""
