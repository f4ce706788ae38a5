"""A frozen copy of the plain PyTorch code of isvins_tpu_torch that the
benchmark's reference runs: the geometry, the factors, the window solver
with every kernel replaced by its plain version, the steady frame solve,
the marginalization, the pose graph's dense solve, PnP, and the tracker's
CLAHE, pyramid and Lucas-Kanade. It imports nothing of the port, so that a
later change to the port cannot move the yardstick."""
