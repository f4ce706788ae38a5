"""Two-stage marginalization of the port (init_sparsify, marg_forward,
marg_backward) against isvins_tpu's in f64, on the problem of
tests/test_marginalization.py. Information matrices (S^T S, i.e.
U diag(w) U^T) are compared, not raw eigenvectors or square roots, whose
signs and order are free; the KLD bounds of test_marginalization.py apply
to the port as well."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import isvins_tpu  # noqa: F401
from isvins_tpu.estimator import init_sparsify, marg_backward, marg_forward
from isvins_tpu_torch.estimator import marginalization as tm
from isvins_tpu_torch.utils.convert import from_numpy_tree

from test_solver import build_problem

VO = 4


def _port(tree):
    return from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree), "cpu", torch.float64)


def _info(S):
    S = np.asarray(S)
    return np.swapaxes(S, -1, -2) @ S


def _close_info(a, b, rtol=1e-5):
    """Information matrices agree relative to their own scale: they are
    built from eigen-truncated inverses of marginal informations with
    condition numbers up to ~1e10, so f64 round-off (LAPACK vs XLA eigh and
    Cholesky) reaches ~1e-6 of the largest entry (measured 1.5e-6)."""
    a, b = _info(a), _info(b)
    scale = np.abs(b).max(axis=(-1, -2), keepdims=True) + 1e-300
    np.testing.assert_allclose(a / scale, b / scale, atol=rtol)


def _setup():
    cfg, world, gt, imu_f, proj_f, dims, nf = build_problem(B=10, seed=2)
    G = jnp.asarray(world.gravity)
    pre_vo = jax.tree_util.tree_map(lambda a: a[: VO - 1], imu_f.pre)
    return cfg, world, gt, imu_f, proj_f, G, pre_vo


def test_init_sparsify_matches():
    cfg, world, gt, imu_f, proj_f, G, pre_vo = _setup()
    pr_j, kld_j = init_sparsify(gt, pre_vo, G, VO, alpha=cfg.solver.alpha)
    pr_t, kld_t = tm.init_sparsify(_port(gt), _port(pre_vo), _port(G), VO, cfg.solver.alpha)
    np.testing.assert_allclose(float(kld_t), float(kld_j), rtol=1e-6)
    assert float(kld_t) < 170.0  # test_marginalization.py golden bound
    for name in ("se3_t", "se3_q", "vb", "rel_dt", "rel_dq"):
        np.testing.assert_allclose(getattr(pr_t, name).numpy(), np.asarray(getattr(pr_j, name)),
                                   atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(pr_t.rel_valid.numpy(), [False, True, True, True])
    for name in ("se3_sqrt", "vb_sqrt", "rel_sqrt"):
        _close_info(getattr(pr_t, name).numpy(), getattr(pr_j, name))


def _marg_rows(proj_f, L=64):
    ii, jj, vv = (np.asarray(a) for a in (proj_f.idx_i, proj_f.idx_j, proj_f.valid))
    sel = (ii == 0) & (jj == 1) & vv
    n = min(int(sel.sum()), L)
    pts_i, pts_j = np.tile([[0, 0, 1.0]], (L, 1)), np.tile([[0, 0, 1.0]], (L, 1))
    fidx, valid = np.zeros(L, np.int32), np.zeros(L, bool)
    pts_i[:n] = np.asarray(proj_f.pts_i)[sel][:n]
    pts_j[:n] = np.asarray(proj_f.pts_j)[sel][:n]
    fidx[:n] = np.asarray(proj_f.fidx)[sel][:n]
    valid[:n] = True
    assert n > 5
    return pts_i, pts_j, fidx, valid


def test_marg_forward_matches():
    cfg, world, gt, imu_f, proj_f, G, pre_vo = _setup()
    pr_j, _ = init_sparsify(gt, pre_vo, G, VO, alpha=cfg.solver.alpha)
    rows = _marg_rows(proj_f)
    psi, alpha, ts0 = cfg.noise.pixel_sqrt_info, cfg.solver.alpha, world.frame_times[0]
    out_j = marg_forward(gt, pr_j, *(jnp.asarray(a) for a in rows), jnp.asarray(psi), alpha, ts0)
    out_t = tm.marg_forward(_port(gt), _port(pr_j), *(torch.as_tensor(a) for a in rows),
                            psi, alpha, ts0)
    t1, q1, sq1, packet, kld = out_t
    np.testing.assert_allclose(t1.numpy(), np.asarray(out_j[0]), atol=1e-14)
    np.testing.assert_allclose(q1.numpy(), np.asarray(out_j[1]), atol=1e-14)
    _close_info(sq1.numpy(), out_j[2])
    assert float(kld) < 1.0  # golden: 0 nats
    np.testing.assert_allclose(float(kld), float(out_j[4]), atol=1e-6)
    for name in packet._fields:
        a, b = getattr(packet, name).numpy(), np.asarray(getattr(out_j[3], name))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)


def test_marg_backward_matches():
    cfg, world, gt, imu_f, proj_f, G, pre_vo = _setup()
    pr_j, _ = init_sparsify(gt, pre_vo, G, VO, alpha=cfg.solver.alpha)
    pre_ij = jax.tree_util.tree_map(lambda a: a[VO - 1], imu_f.pre)
    out_j = marg_backward(gt, pre_ij, pr_j, G, VO, cfg.solver.alpha)
    out_t = tm.marg_backward(_port(gt), _port(pre_ij), _port(pr_j), _port(G), VO,
                             cfg.solver.alpha)
    dt_m, dq_m, rel_sqrt, vb_m, vb_sqrt, rp_q, rp_sqrt, kld = out_t
    for a, b in ((dt_m, out_j[0]), (dq_m, out_j[1]), (vb_m, out_j[3]), (rp_q, out_j[5])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-13)
    for a, b in ((rel_sqrt, out_j[2]), (vb_sqrt, out_j[4]), (rp_sqrt, out_j[6])):
        _close_info(a.numpy(), b)
    assert float(kld) < 60.0  # test_marginalization.py golden bound
    np.testing.assert_allclose(float(kld), float(out_j[7]), rtol=1e-6)
