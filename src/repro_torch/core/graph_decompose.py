"""Stage 1 of da4ml: graph-based decomposition M = M1 @ M2 (paper §4.3).

Each column v_i of the constant matrix M is a vertex; the root vertex v_0
carries the zero vector.  The distance between vertices is

    dist(v_i, v_j) = min( nnz_csd(v_i - v_j), nnz_csd(v_i + v_j) )

i.e. the CSD digit count of the cheaper transfer vector.  A depth-capped
approximate minimum spanning tree is grown with Prim's algorithm (cap
2^dc vertices from the root for delay constraint dc >= 0; unbounded for
dc = -1).  Every MST edge contributes one column (its transfer vector) to
M1; tracing root->vertex paths yields the {-1, 0, +1} combination matrix
M2 with M == M1 @ M2.

For matrices with uncorrelated columns the decomposition degrades to the
trivial M1 = M, M2 = I (shuffled), exactly as the paper describes; the
tie-break below prefers the root parent so no depth is added in that
case.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .csd import csd_nnz


@dataclass
class Decomposition:
    m1: np.ndarray  # [d_in, K]   transfer vectors (non-zero MST edges)
    m2: np.ndarray  # [K, d_out]  {-1,0,+1} path-combination matrix
    path_len: np.ndarray  # [d_out] number of M1 columns feeding each output
    mst_depth: np.ndarray  # [d_out] MST depth of each column's vertex

    @property
    def is_trivial(self) -> bool:
        return bool(np.all(self.mst_depth <= 1))


def decompose(m: np.ndarray, dc: int = -1) -> Decomposition:
    """Decompose integer matrix m [d_in, d_out] into m1 @ m2."""
    m = np.asarray(m, dtype=np.int64)
    d_in, d_out = m.shape
    cap = (1 << dc) if dc >= 0 else d_out + 1

    visited = np.zeros(d_out, dtype=bool)
    depth = np.zeros(d_out, dtype=np.int64)
    # best known connection for each unvisited vertex
    best_dist = csd_nnz(m).sum(axis=0)  # distance to root (v_0 = 0)
    best_parent = np.full(d_out, -1, dtype=np.int64)  # -1 = root
    best_flip = np.zeros(d_out, dtype=bool)  # True: v_j = w - v_parent

    edges: list[tuple[int, int, bool]] = []  # (child, parent, flip)
    for _ in range(d_out):
        cand = np.where(~visited, best_dist, np.iinfo(np.int64).max)
        j = int(np.argmin(cand))
        visited[j] = True
        par = int(best_parent[j])
        depth[j] = 1 if par < 0 else depth[par] + 1
        edges.append((j, par, bool(best_flip[j])))
        if depth[j] < cap:
            # relax unvisited vertices through the new vertex
            unv = ~visited
            if unv.any():
                diff = csd_nnz(m[:, unv] - m[:, j : j + 1]).sum(axis=0)
                summ = csd_nnz(m[:, unv] + m[:, j : j + 1]).sum(axis=0)
                d_new = np.minimum(diff, summ)
                flip_new = summ < diff
                idx = np.where(unv)[0]
                # strict improvement only: ties keep the shallower parent
                upd = d_new < best_dist[idx]
                best_dist[idx[upd]] = d_new[upd]
                best_parent[idx[upd]] = j
                best_flip[idx[upd]] = flip_new[upd]

    # Translate MST edges into M1 columns and M2 path combinations.
    m1_cols: list[np.ndarray] = []
    contrib: dict[int, dict[int, int]] = {}  # vertex -> {m1_col: sign}
    # process in insertion order: parents always precede children
    for child, par, flip in edges:
        parent_contrib = {} if par < 0 else contrib[par]
        base = {k: -v for k, v in parent_contrib.items()} if flip else dict(parent_contrib)
        pvec = np.zeros(d_in, dtype=np.int64) if par < 0 else m[:, par]
        w = m[:, child] + pvec if flip else m[:, child] - pvec
        if np.any(w != 0):
            e = len(m1_cols)
            m1_cols.append(w)
            base[e] = 1
        contrib[child] = base

    k = len(m1_cols)
    m1 = np.stack(m1_cols, axis=1) if k else np.zeros((d_in, 0), dtype=np.int64)
    m2 = np.zeros((k, d_out), dtype=np.int64)
    for j in range(d_out):
        for e, sgn in contrib[j].items():
            m2[e, j] = sgn

    assert np.array_equal(m1 @ m2, m), "decomposition must be exact"
    path_len = np.count_nonzero(m2, axis=0).astype(np.int64)
    return Decomposition(m1, m2, path_len, depth)
