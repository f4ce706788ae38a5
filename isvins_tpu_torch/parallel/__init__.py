"""Sequence-parallel paths (port of isvins_tpu/parallel): batched window
solves over a list of devices (sharded.py) and the multi-sequence
coordinator that batches the steady solves of several estimators
(multi_seq.py). The pose-graph paths across devices (distributed.py,
dd_solver.py) are not ported yet."""

from .multi_seq import MultiSequenceSolver  # noqa: F401
from .sharded import make_batch_problem, make_mesh, sharded_batch_solve  # noqa: F401
