"""Step builders (serving steps so far)."""
