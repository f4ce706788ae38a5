"""Parallel paths (port of isvins_tpu/parallel): batched window solves over
a list of devices (sharded.py), the multi-sequence coordinator that batches
the steady solves of several estimators (multi_seq.py), and the pose graph
across devices: the edge-sharded dense Gauss-Newton (distributed.py) and the
nested-dissection solve (dd_solver.py) that posegraph.optimize_pose_graph
routes long segments to when it is given more than one device. A mesh is a
list of torch devices driven by one process; a device may be listed several
times."""

from .dd_solver import dd_pose_graph_solve  # noqa: F401
from .distributed import distributed_pose_graph_solve  # noqa: F401
from .multi_seq import MultiSequenceSolver  # noqa: F401
from .sharded import cycle_mesh, make_batch_problem, make_mesh, sharded_batch_solve  # noqa: F401
