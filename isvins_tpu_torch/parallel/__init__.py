"""Synthetic batch problems for the window solver (port of
isvins_tpu/parallel; the multi-sequence solver and the distributed paths
are not ported yet)."""
