"""K6: batched Hamming retrieval scoring (csrc/hamming.cu).

Replaces isvins_tpu/ops/hamming_pallas.py::retrieval_scores_pallas. The
plain version is retrieval_scores_ref.

Descriptors are 256-bit BRIEF packed into 8 words. torch has no usable
uint32 (`>>` on a uint32 CPU tensor raises), so the port carries each word
as an int32 holding the same bits (`np.ndarray.view(np.int32)`); popcount32
counts them with the SWAR bit trick on int64.
"""

from __future__ import annotations

import torch

from ._lib import check, launch

RET_R = 64  # descriptors per keyframe: the kernel's block size (KeyframeDB.R)


def popcount32(x):
    """Set bits of each 32-bit word of an int32 tensor (int32 result)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_matrix(desc_a, desc_b):
    """(Na, 8), (Nb, 8) int32 descriptors -> (Na, Nb) int32 Hamming
    distances, accumulated word by word."""
    d = popcount32(desc_a[:, None, 0] ^ desc_b[None, :, 0])
    for w in range(1, desc_a.shape[1]):
        d += popcount32(desc_a[:, None, w] ^ desc_b[None, :, w])
    return d


def retrieval_scores_ref(qd, qv, dbd, dbv, thresh: int):
    """qd (R,8) int32 query descriptors, qv (R,) bool, dbd (K,R,8) int32,
    dbv (K,R) bool -> (K,) f32: per database keyframe, the fraction of valid
    query descriptors whose min Hamming distance there is below `thresh`.
    The distances are one (R, K*R) int32 matrix; no (R,K,R,8) intermediate."""
    K, R, _ = dbd.shape
    d = hamming_matrix(qd, dbd.reshape(K * R, -1)).reshape(-1, K, R)
    d = torch.where(dbv[None], d, torch.full_like(d, 512))
    hit = (d.amin(dim=-1) < thresh) & qv[:, None]  # (R,K)
    n = torch.clamp(qv.sum().to(torch.float32), min=1.0)
    return hit.sum(dim=0).to(torch.float32) / n


def retrieval_scores(qd, qv, dbd, dbv, thresh: int):
    """Kernel wrapper with retrieval_scores_ref's signature and return. CPU
    tensors take the plain version; CUDA tensors launch the kernel (R = 64
    descriptors per keyframe, the database's subsample; the distances from
    popc(a & b) of every pair on the tensor cores, binary wgmma, exact) or
    raise."""
    if not dbd.is_cuda:
        return retrieval_scores_ref(qd, qv, dbd, dbv, thresh)
    dev = dbd.device
    K, R, W = dbd.shape
    if W != 8 or R != RET_R:
        raise ValueError(f"dbd: shape {tuple(dbd.shape)}: need (K, {RET_R}, 8)")
    check(qd, "qd", (R, 8), torch.int32, dev)
    check(qv, "qv", (R,), torch.bool, dev)
    check(dbd, "dbd", (K, R, 8), torch.int32, dev)
    check(dbv, "dbv", (K, R), torch.bool, dev)
    # the kernel copies dbd and dbv in 16-byte chunks by cp.async
    qd, dbd, dbv = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (qd, dbd, dbv))
    scores = torch.empty((K,), dtype=torch.float32, device=dev)
    launch("isv_retrieval_scores", qd, qv, dbd, dbv, scores, K, int(thresh), device=dev)
    retrieval_scores.launches += 1
    return scores


retrieval_scores.launches = 0
