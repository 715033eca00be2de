"""Checkpoints: per-leaf files, CRC checksums, atomic publish, resume."""
