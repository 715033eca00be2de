"""Step builders (train, prefill, decode) and the optimizer."""
