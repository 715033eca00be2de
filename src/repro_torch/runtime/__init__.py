"""Serving runtime: the simulated cluster and its scheduler, the background
scrubber, and the multi-tenant ``HailServer`` with its latency-SLO
frontend."""
