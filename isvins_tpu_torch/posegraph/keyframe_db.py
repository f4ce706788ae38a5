"""Fixed-capacity keyframe database (torch port of
isvins_tpu/posegraph/keyframe_db.py; reference `list<KeyFrame*>` + DBoW2,
pose_graph.h:59).

Keyframe payloads live in preallocated host numpy SoA arrays (f64 poses,
uint32 descriptor words, as in the reference, so `load_pose_graph` reads
the JAX snapshots unchanged). Retrieval (detectLoop semantics: top-k, skip
the most recent keyframes, absolute score gate; pose_graph.cpp:138-218)
scores with the host-numpy tf-idf bag of binary words once the online
vocabulary is frozen, and before that with the match-count score of kernel
K6 (ops.retrieval_scores) on the database's device. The retrieval
subsample has a device mirror (`ret_desc_dev`, `ret_valid_dev`) that `add`
writes one row into, so a query uploads nothing.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import ops


class KeyframeDB:
    def __init__(self, capacity: int, max_kp: int, max_win_pts: int, *, device):
        K, D, P = capacity, max_kp, max_win_pts
        self.K, self.D, self.P = K, D, P
        self.n = 0
        self.device = torch.device(device)
        self.match_count_queries: list = []  # idx of each query scored by K6 (pre-freeze)

        self.ts = np.zeros(K)
        # sequence id; 0 is reserved for a loaded map whose poses are held
        # constant in optimization (pose_graph.cpp:299-302)
        self.seq = np.ones(K, dtype=np.int32)
        self.vio_t = np.zeros((K, 3))
        self.vio_q = np.tile(np.array([1.0, 0, 0, 0]), (K, 1))
        self.opt_t = np.zeros((K, 3))
        self.opt_q = np.tile(np.array([1.0, 0, 0, 0]), (K, 1))
        self.cov = np.zeros((K, 6, 6))

        # sequential edge to the NEXT keyframe (pose_graph_builder.cpp:192-204)
        self.edge_dt = np.zeros((K, 3))
        self.edge_dq = np.tile(np.array([1.0, 0, 0, 0]), (K, 1))
        self.edge_sqrt = np.zeros((K, 6, 6))
        self.edge_valid = np.zeros(K, dtype=bool)
        # roll-pitch edge on this keyframe
        self.rp_q = np.tile(np.array([1.0, 0, 0, 0]), (K, 1))
        self.rp_sqrt = np.zeros((K, 2, 2))
        self.rp_valid = np.zeros(K, dtype=bool)
        # loop edge: this kf -> older kf loop_idx
        self.loop_idx = np.full(K, -1, dtype=np.int32)
        self.loop_dt = np.zeros((K, 3))
        self.loop_dq = np.tile(np.array([1.0, 0, 0, 0]), (K, 1))
        self.loop_weight = np.zeros(K)

        # descriptors: detected keypoints (matched against) and window
        # points (with 3D, matched forward)
        self.kp_desc = np.zeros((K, D, 8), dtype=np.uint32)
        self.kp_norm = np.zeros((K, D, 2))
        self.kp_valid = np.zeros((K, D), dtype=bool)
        self.win_pts3d = np.zeros((K, P, 3))
        self.win_desc = np.zeros((K, P, 8), dtype=np.uint32)
        self.win_valid = np.zeros((K, P), dtype=bool)

        # retrieval descriptors: a fixed-size subsample of each keyframe's
        # descriptors, matched by brute-force batched Hamming (K6)
        self.R = 64
        self.ret_desc = np.zeros((K, self.R, 8), dtype=np.uint32)
        self.ret_valid = np.zeros((K, self.R), dtype=bool)
        self.ret_desc_dev = torch.zeros((K, self.R, 8), dtype=torch.int32, device=self.device)
        self.ret_valid_dev = torch.zeros((K, self.R), dtype=torch.bool, device=self.device)

        # TF-IDF bag of binary words over an ONLINE vocabulary of W words
        # sampled from the first keyframes' own descriptors, with a 2-level
        # word index (n_groups coarse centers, group_probe-way multi-probe)
        self.W = 4096
        self.n_groups = 64
        self.group_probe = 3
        self.vocab = np.zeros((self.W, 8), dtype=np.uint32)
        self.vocab_frozen = False
        self._bow_backlog: list = []  # post-freeze amortized tf backfill
        self.tf = np.zeros((K, self.W), dtype=np.float32)
        self.df = np.zeros(self.W, dtype=np.float64)  # document frequency
        self._wg_centers = None  # (C, 8) coarse centers
        self._wg_words = None  # (C, Gmax) word ids per group
        self._wg_valid = None  # (C, Gmax)

    def _grow(self):
        """Double the capacity of every per-keyframe SoA array and of the
        device mirror."""
        K2 = self.K * 2
        quat_fields = {"vio_q", "opt_q", "edge_dq", "rp_q", "loop_dq"}
        vocab_fields = {"vocab", "df"}  # sized by W, never by capacity
        for name, arr in list(vars(self).items()):
            if isinstance(arr, torch.Tensor):
                new = arr.new_zeros((K2,) + tuple(arr.shape[1:]))
                new[: self.K] = arr
                setattr(self, name, new)
                continue
            if (name in vocab_fields or not isinstance(arr, np.ndarray) or arr.ndim == 0
                    or arr.shape[0] != self.K):
                continue
            new = np.zeros((K2,) + arr.shape[1:], dtype=arr.dtype)
            new[: self.K] = arr
            if name in quat_fields:
                new[self.K:, 0] = 1.0
            elif name == "loop_idx":
                new[self.K:] = -1
            elif name == "seq":
                new[self.K:] = 1
            setattr(self, name, new)
        self.K = K2

    def add(self, **kw) -> int:
        if self.n >= self.K:
            self._grow()
        i = self.n
        for k, v in kw.items():
            getattr(self, k)[i] = v
        rows = np.where(self.kp_valid[i])[0]
        take = rows[:: max(1, len(rows) // self.R)][: self.R]
        self.ret_desc[i, : len(take)] = self.kp_desc[i][take]
        self.ret_valid[i, : len(take)] = True
        self.sync_ret_row(i)
        self._bow_add(i)
        self.n += 1
        return i

    def sync_ret_row(self, i: int):
        """Copy retrieval row i of the host arrays into the device mirror."""
        self.ret_desc_dev[i] = torch.from_numpy(self.ret_desc[i].view(np.int32)).to(self.device)
        self.ret_valid_dev[i] = torch.from_numpy(self.ret_valid[i]).to(self.device)

    # ---- TF-IDF bag-of-binary-words (host numpy, as in the reference) ----

    def _build_word_index(self):
        """2-level index over the frozen vocabulary: `n_groups` coarse
        centers (sampled words), each word attached to its nearest center
        (DBoW's hierarchical tree at depth 2, TemplatedVocabulary.h)."""
        C = self.n_groups
        rng = np.random.default_rng(23)
        sel = rng.choice(self.W, C, replace=False)
        self._wg_centers = self.vocab[sel]
        x = np.bitwise_xor(self.vocab[:, None, :], self._wg_centers[None])
        gid = np.bitwise_count(x).sum(axis=-1).argmin(axis=1)  # (W,)
        counts = np.bincount(gid, minlength=C)
        Gmax = int(counts.max())
        self._wg_words = np.zeros((C, Gmax), np.int32)
        self._wg_valid = np.zeros((C, Gmax), bool)
        for c in range(C):
            rows = np.where(gid == c)[0]
            self._wg_words[c, : len(rows)] = rows
            self._wg_valid[c, : len(rows)] = True

    def _assign_words(self, desc: np.ndarray) -> np.ndarray:
        """(n, 8) uint32 descriptors -> (n,) word ids: coarse argmin over
        the group centers, then exact min-Hamming within the probed groups."""
        if self._wg_centers is None:
            self._build_word_index()
        P = self.group_probe
        dc = np.bitwise_count(np.bitwise_xor(desc[:, None, :], self._wg_centers[None])).sum(axis=-1)
        probe = np.argpartition(dc, P - 1, axis=1)[:, :P]  # (n, P)
        cand = self._wg_words[probe].reshape(len(desc), -1)  # (n, P*Gmax)
        ok = self._wg_valid[probe].reshape(len(desc), -1)
        d = np.bitwise_count(np.bitwise_xor(desc[:, None, :], self.vocab[cand])).sum(axis=-1)
        d[~ok] = 1 << 30
        return cand[np.arange(len(desc)), d.argmin(axis=1)]

    def _tf_from_desc(self, desc: np.ndarray) -> np.ndarray:
        words = self._assign_words(desc)
        counts = np.bincount(words, minlength=self.W).astype(np.float32)
        s = counts.sum()
        return counts / s if s > 0 else counts

    def _bow_add(self, i: int):
        """Quantize keyframe i's descriptors into the online vocabulary;
        freeze the vocabulary from the stored keyframes' own descriptors
        (sampled, deduplicated) and queue the backfill of earlier keyframes
        (drained a few per later keyframe)."""
        if not self.vocab_frozen:
            pooled = int(self.kp_valid[: i + 1].sum())
            if pooled >= 4 * self.W or self.n >= 48:
                pool = self.kp_desc[: i + 1][self.kp_valid[: i + 1]]
                pool = (np.unique(pool, axis=0) if len(pool)
                        else np.zeros((0, 8), np.uint32))
                rng = np.random.default_rng(17)
                if len(pool) >= self.W:
                    self.vocab = pool[rng.choice(len(pool), self.W, replace=False)]
                else:  # degenerate start: pad with random bit patterns
                    pad = rng.integers(0, 2**32, size=(self.W - len(pool), 8), dtype=np.uint32)
                    self.vocab = np.concatenate([pool, pad], axis=0)
                self.vocab_frozen = True
                self._wg_centers = None  # (re)build the 2-level index lazily
                self._bow_backlog = list(range(i + 1))
            return
        self._drain_bow_backlog(16)
        if i not in self._bow_backlog:
            desc = self.kp_desc[i][self.kp_valid[i]]
            if len(desc):
                self.tf[i] = self._tf_from_desc(desc)
                self.df += self.tf[i] > 0

    def flush_bow(self):
        """Complete any amortized post-freeze tf backfill."""
        self._drain_bow_backlog(len(self._bow_backlog))

    def flushed_bow(self):
        """(tf, df) as flush_bow() would leave them, computed on a shallow
        copy that owns copies of tf, df and the backlog (and builds its own
        word index): the database itself is not written, so a snapshot
        never races the builder that fills it."""
        shadow = copy.copy(self)
        shadow.tf, shadow.df = self.tf.copy(), self.df.copy()
        shadow._bow_backlog = list(self._bow_backlog)
        shadow.flush_bow()
        return shadow.tf, shadow.df

    def _drain_bow_backlog(self, k: int):
        for j in self._bow_backlog[:k]:
            dj = self.kp_desc[j][self.kp_valid[j]]
            if len(dj):
                self.tf[j] = self._tf_from_desc(dj)
                self.df += self.tf[j] > 0
        del self._bow_backlog[:k]

    def _bow_scores(self, idx: int, hi: int, stop_df_frac: float = 1.0):
        """DBoW2 L1 scoring (TemplatedVocabulary.h L1_NORM): s(v, w) =
        1 - 0.5 * || v - w ||_1 over idf-weighted, L1-normalized tf vectors.
        Words in more than `stop_df_frac` of the keyframes are stop words."""
        if any(j < hi for j in self._bow_backlog):
            pending = [j for j in self._bow_backlog if j < hi]
            rest = [j for j in self._bow_backlog if j >= hi]
            self._bow_backlog = pending + rest
            self._drain_bow_backlog(len(pending))
        idf = np.log((self.n + 1.0) / (self.df + 1.0)).astype(np.float32)
        if stop_df_frac < 1.0:
            idf[self.df > stop_df_frac * max(self.n, 1)] = 0.0
        vq = self.tf[idx] * idf
        nq = vq.sum()
        if nq <= 0:
            return None
        vq = vq / nq
        Vdb = self.tf[:hi] * idf
        nd = Vdb.sum(axis=1, keepdims=True)
        Vdb = Vdb / np.maximum(nd, 1e-12)
        s = 1.0 - 0.5 * np.abs(Vdb - vq).sum(axis=1)
        s[nd[:, 0] <= 0] = 0.0
        return s

    def query(self, idx: int, skip_recent: int = 50, top_k: int = 4,
              match_thresh: int = 40, abs_frac: float = 0.2,
              bow_abs: float = 0.05, bow_rel: float = 0.0,
              stop_df_frac: float = 1.0):
        """detectLoop (pose_graph.cpp:138-218): up to top_k candidate
        indices among keyframes [0, idx - skip_recent), best first, above
        the absolute gate. Scoring: the tf-idf L1 similarity once the
        vocabulary is frozen; before that, K6's match-count score over the
        retrieval subsample, rows [0, hi) only. Geometric verification
        (find_connection) arbitrates among the candidates."""
        hi = idx - skip_recent
        if hi <= 0:
            return []
        if self.vocab_frozen:
            scores = self._bow_scores(idx, hi, stop_df_frac=stop_df_frac)
            if scores is not None:
                order = np.argsort(-scores)[: min(top_k, hi)]
                gate = max(bow_abs, bow_rel * float(scores[order[0]]))
                return [int(o) for o in order if scores[o] >= gate]
        self.match_count_queries.append(idx)
        scores = ops.retrieval_scores(self.ret_desc_dev[idx], self.ret_valid_dev[idx],
                                      self.ret_desc_dev[:hi], self.ret_valid_dev[:hi],
                                      match_thresh)
        # f64 on the host: the reference's CPU path ranks f64 scores, and
        # numpy's argsort breaks ties per dtype
        scores = scores.cpu().numpy().astype(np.float64)
        order = np.argsort(-scores)[: min(top_k, hi)]
        return [int(o) for o in order if scores[o] >= abs_frac]
