"""Sliding-window VIO estimator on torch (port of isvins_tpu/estimator)."""
