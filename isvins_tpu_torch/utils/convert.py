"""numpy <-> torch conversion of the solver's NamedTuple trees.

`from_numpy_tree` takes any tree of NamedTuples/tuples/lists whose leaves
are array-likes — the port's own host trees, or the JAX package's
NamedTuples after `np.asarray` of each leaf — and returns the PORT's
NamedTuple types (matched by class name) holding tensors on `device`.
Float leaves are cast to `dtype` when it is given; integer and bool leaves
keep their types. `to_numpy_tree` goes the other way. `tree_map` applies a
function leaf by leaf to one tree or to several of one structure (stacking
the argument trees of several sequences, taking one sequence's row).
"""

from __future__ import annotations

import numpy as np
import torch


def _port_types():
    from ..estimator.marginalization import PoseGraphPacket
    from ..factors.preintegration import Preintegration
    from ..solver.window import (ImuFactors, PriorState, ProjFactors,
                                 RollPitchFactors, WindowState)

    return {c.__name__: c for c in (WindowState, ProjFactors, ImuFactors, PriorState,
                                    RollPitchFactors, Preintegration, PoseGraphPacket)}


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_numpy_tree(tree, device, dtype=None):
    types = _port_types()

    def conv(x):
        if _is_namedtuple(x):
            cls = types.get(type(x).__name__)
            if cls is None:
                raise TypeError(f"no port type for {type(x).__name__}")
            return cls(*(conv(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, torch.Tensor):
            t = x.to(device)
        else:
            a = np.asarray(x)
            if not (a.flags.writeable and a.flags.c_contiguous):
                a = np.array(a)  # torch wants a writable, contiguous buffer
            t = torch.as_tensor(a, device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    return conv(tree)


def to_numpy_tree(tree):
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy_tree(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def tree_map(fn, tree, *rest):
    """fn(leaf, *leaves of rest) over trees of NamedTuples/tuples/lists."""
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)
