"""Dataset IO: the EuRoC MAV format loader (port of isvins_tpu/data;
replaces test/run_euroc.cpp's CSV parsing, without its real-time throttle
sleeps) and the PNG codec its images need."""

from .euroc import EurocDataset  # noqa: F401
