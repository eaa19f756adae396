"""Offline item / user clustering — prior-dictionary builders.

Counterparts of the reference offline tools (``code/item-clustering.py``,
``code/user-clustering.py``): build a co-occurrence graph from interaction
windows (item–item) or co-interaction counts (user–user), detect
communities, and emit the cluster → category mapping in the prior-dict JSON
schema consumed by :mod:`mhrec_tpu_torch.data.tag_dicts` (a copy of
``mhrec_tpu/tools/clustering.py``).

The reference calls igraph ``community_leiden(objective_function=
'modularity', resolution=r, n_iterations=-1)`` (item-clustering.py:241-247);
igraph isn't in this environment, so :func:`leiden` is a first-party
scipy/numpy implementation of the Leiden algorithm (Traag et al. 2019:
local moving → refinement → aggregation, modularity objective with a
resolution parameter), deterministic under a seed. Weighted label
propagation remains available as a cheaper alternative
(``algorithm='label_prop'``).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Optional

import numpy as np
from scipy import sparse


def cooccurrence_graph(
    seqs, num_nodes: int, window: int = 5, min_count: int = 2
) -> sparse.csr_matrix:
    """Symmetric item–item co-occurrence counts over sliding windows."""
    rows, cols = [], []
    for seq in seqs:
        arr = np.asarray(seq)
        for off in range(1, window + 1):
            if len(arr) <= off:
                continue
            rows.append(arr[:-off])
            cols.append(arr[off:])
    if not rows:
        return sparse.csr_matrix((num_nodes, num_nodes))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    m = sparse.coo_matrix(
        (np.ones(len(r)), (r, c)), shape=(num_nodes, num_nodes)
    ).tocsr()
    m = m + m.T
    m.data[m.data < min_count] = 0
    m.eliminate_zeros()
    m.setdiag(0)
    m.eliminate_zeros()
    return m


def co_interaction_graph(seqs, num_users: int, num_items: int,
                         min_count: int = 2) -> sparse.csr_matrix:
    """User–user graph weighted by shared-item counts (B Bᵀ)."""
    rows, cols = [], []
    for uid, seq in enumerate(seqs):
        arr = np.unique(np.asarray(seq))
        rows.append(np.full(len(arr), uid))
        cols.append(arr)
    if not rows:
        return sparse.csr_matrix((num_users, num_users))
    b = sparse.coo_matrix(
        (np.ones(sum(len(x) for x in cols)), (np.concatenate(rows), np.concatenate(cols))),
        shape=(num_users, num_items),
    ).tocsr()
    m = (b @ b.T).tocsr()
    m.data[m.data < min_count] = 0
    m.setdiag(0)
    m.eliminate_zeros()
    return m


def modularity(graph: sparse.csr_matrix, labels: np.ndarray,
               resolution: float = 1.0) -> float:
    """Weighted Newman modularity of a partition (labels < 0 = singleton)."""
    m2 = graph.sum()                       # 2m for a symmetric matrix
    if m2 == 0:
        return 0.0
    labs = labels.copy()
    neg = labs < 0
    labs[neg] = labs.max() + 1 + np.arange(int(neg.sum()))  # singletons
    deg = np.asarray(graph.sum(axis=1)).ravel()
    n_comm = int(labs.max()) + 1
    # sum of intra-community edge weights
    coo = graph.tocoo()
    intra = np.zeros(n_comm)
    same = labs[coo.row] == labs[coo.col]
    np.add.at(intra, labs[coo.row[same]], coo.data[same])
    tot = np.zeros(n_comm)
    np.add.at(tot, labs, deg)
    return float(intra.sum() / m2 - resolution * np.sum((tot / m2) ** 2))


def _local_move(indptr, indices, data, deg, labels, m2, resolution, rng,
                restrict: Optional[np.ndarray] = None) -> int:
    """Queue-based local moving phase (Leiden §local move). Mutates labels
    in place; returns the number of moves made.

    ``restrict``: optional coarse partition; nodes may only join communities
    inside their own coarse block (used by the refinement phase).
    """
    n = len(labels)
    moves = 0
    comm_tot = np.zeros(int(labels.max()) + 2 + n)
    np.add.at(comm_tot, labels, deg)
    in_queue = np.ones(n, dtype=bool)
    queue = list(rng.permutation(n))
    gamma = resolution / m2
    while queue:
        node = queue.pop()
        in_queue[node] = False
        lo, hi = indptr[node], indptr[node + 1]
        if lo == hi:
            continue
        neigh = indices[lo:hi]
        w = data[lo:hi]
        keep = neigh != node          # self-loops follow the node; no k_in
        neigh, w = neigh[keep], w[keep]
        if len(w) == 0:
            continue
        cur = labels[node]
        k_i = deg[node]
        # edge weight from node into each candidate community
        cand_labels = labels[neigh]
        if restrict is not None:
            ok = restrict[neigh] == restrict[node]
            cand_labels = cand_labels[ok]
            neigh = neigh[ok]
            w = w[ok]
            if len(w) == 0:
                continue
        uniq, inv = np.unique(cand_labels, return_inverse=True)
        k_in = np.zeros(len(uniq))
        np.add.at(k_in, inv, w)
        # gain of joining community c from a singleton baseline (node
        # removed from cur first): k_in(c) - gamma * k_i * tot(c\{i});
        # the gain of staying is the same expression evaluated at cur
        tot = comm_tot[uniq] - np.where(uniq == cur, k_i, 0.0)
        gain = k_in - gamma * k_i * tot
        is_cur = uniq == cur
        stay = float(gain[is_cur][0]) if is_cur.any() else (
            -gamma * k_i * (comm_tot[cur] - k_i)
        )
        best = int(np.argmax(gain))
        if uniq[best] != cur and gain[best] > stay + 1e-12:
            new = uniq[best]
            comm_tot[cur] -= k_i
            comm_tot[new] += k_i
            labels[node] = new
            moves += 1
            # re-queue neighbors not in the new community
            requeue = neigh[(labels[neigh] != new) & ~in_queue[neigh]]
            for r in requeue:
                in_queue[r] = True
                queue.append(int(r))
    return moves


def leiden(
    graph: sparse.csr_matrix,
    resolution: float = 1.0,
    n_iterations: int = -1,
    seed: int = 0,
    min_cluster_size: int = 2,
) -> np.ndarray:
    """Leiden community detection (modularity objective) → compact ids.

    Mirrors igraph ``community_leiden`` semantics used by the reference:
    ``n_iterations=-1`` runs until the partition stops changing. Isolated
    nodes and clusters smaller than ``min_cluster_size`` map to -1.
    """
    n = graph.shape[0]
    g = graph.tocsr().astype(np.float64)
    m2 = float(g.sum())
    deg_full = np.asarray(g.sum(axis=1)).ravel()
    if m2 == 0:
        return np.full(n, -1, dtype=np.int64)
    rng = np.random.default_rng(seed)

    level_graph = g
    level_of_node = np.arange(n)          # original node → current-level vertex
    init: Optional[np.ndarray] = None     # next level starts from the coarse
    node_labels = np.arange(n)            # partition (Leiden's key invariant)
    it = 0
    while True:
        it += 1
        nv = level_graph.shape[0]
        deg = np.asarray(level_graph.sum(axis=1)).ravel()
        labels = np.arange(nv) if init is None else init.copy()
        moved = _local_move(
            level_graph.indptr, level_graph.indices, level_graph.data,
            deg, labels, m2, resolution, rng,
        )
        _, labels = np.unique(labels, return_inverse=True)
        n_comm = int(labels.max()) + 1
        node_labels = labels[level_of_node]   # flat partition = coarse labels
        if (moved == 0 and init is not None) or n_comm == nv or (
            0 < n_iterations <= it
        ):
            break
        # refinement: singleton start, moves restricted to the coarse blocks
        refined = np.arange(nv)
        _local_move(level_graph.indptr, level_graph.indices, level_graph.data,
                    deg, refined, m2, resolution, rng, restrict=labels)
        _, refined = np.unique(refined, return_inverse=True)
        n_ref = int(refined.max()) + 1
        if n_ref == nv and n_comm == nv:
            break                              # nothing to aggregate
        # aggregate on the refined partition; the aggregated vertices start
        # the next level in their COARSE community (refined ⊆ coarse blocks)
        proj = sparse.coo_matrix(
            (np.ones(nv), (np.arange(nv), refined)), shape=(nv, n_ref)
        ).tocsr()
        level_graph = (proj.T @ level_graph @ proj).tocsr()
        level_graph.sum_duplicates()
        init = np.empty(n_ref, dtype=np.int64)
        init[refined] = labels
        level_of_node = refined[level_of_node]

    # compact ids; isolated/small clusters → -1
    out = np.full(n, -1, dtype=np.int64)
    active = deg_full > 0
    counts = Counter(node_labels[active].tolist())
    keep = sorted(
        (lab for lab, cnt in counts.items() if cnt >= min_cluster_size),
        key=lambda lab: -counts[lab],
    )
    remap = {lab: i for i, lab in enumerate(keep)}
    for node in np.where(active)[0]:
        out[node] = remap.get(node_labels[node], -1)
    return out


def label_propagation(
    graph: sparse.csr_matrix, max_iter: int = 30, seed: int = 0,
    min_cluster_size: int = 2,
) -> np.ndarray:
    """Weighted label propagation; returns compact cluster ids [num_nodes].

    Nodes without edges get cluster -1. Small clusters (< min_cluster_size)
    are merged into -1.
    """
    n = graph.shape[0]
    rng = np.random.default_rng(seed)
    labels = np.arange(n)
    degrees = np.asarray(graph.sum(axis=1)).ravel()
    active = np.where(degrees > 0)[0]
    indptr, indices, data = graph.indptr, graph.indices, graph.data
    for _ in range(max_iter):
        order = rng.permutation(active)
        changed = 0
        for node in order:
            lo, hi = indptr[node], indptr[node + 1]
            if lo == hi:
                continue
            neigh_labels = labels[indices[lo:hi]]
            weights = data[lo:hi]
            best = Counter()
            for lab, w in zip(neigh_labels, weights):
                best[lab] += w
            new_label = max(best.items(), key=lambda kv: (kv[1], -kv[0]))[0]
            if new_label != labels[node]:
                labels[node] = new_label
                changed += 1
        if changed == 0:
            break
    # compact ids; isolated/small clusters → -1
    out = np.full(n, -1, dtype=np.int64)
    counts = Counter(labels[active].tolist())
    keep = sorted(
        (lab for lab, cnt in counts.items() if cnt >= min_cluster_size),
        key=lambda lab: -counts[lab],
    )
    remap = {lab: i for i, lab in enumerate(keep)}
    for node in active:
        out[node] = remap.get(labels[node], -1)
    return out


def _detect(graph, algorithm, resolution, seed):
    if algorithm == "label_prop":
        return label_propagation(graph, seed=seed)
    return leiden(graph, resolution=resolution, seed=seed)


def build_item_cluster_dict(
    data, window: int = 5, min_count: int = 2, max_clusters: int = 32,
    tag_version: str = "v1", seed: int = 0, algorithm: str = "leiden",
    resolution: float = 1.0, max_user_seq_len: Optional[int] = None,
) -> Dict:
    """Cluster items; returns (prior-dict JSON payload, per-item cluster ids).

    max_user_seq_len: skip users with longer sequences when building the
    item–item graph (reference item-clustering.py:45-69 caps at 200–2000 per
    dataset — power users otherwise dominate the co-occurrence counts)."""
    seqs = [data.seq_of(u) for u in range(1, data.user_num)]
    if max_user_seq_len is not None:
        seqs = [s for s in seqs if len(s) <= max_user_seq_len]
    graph = cooccurrence_graph(seqs, data.item_num, window, min_count)
    clusters = _detect(graph, algorithm, resolution, seed)
    clusters = np.where(clusters >= max_clusters, -1, clusters)
    counts = Counter(int(c) for c in clusters if c >= 0)
    payload = {
        tag_version: {
            "category_counts": {f"cluster_{c}": n for c, n in sorted(counts.items())},
            "tag_to_category": {
                str(c): [f"cluster_{c}"] for c in sorted(counts.keys())
            },
        }
    }
    return payload, clusters


def build_user_cluster_dict(
    data, min_count: int = 2, max_clusters: int = 32,
    tag_version: str = "v1", seed: int = 0, algorithm: str = "leiden",
    resolution: float = 1.0,
) -> Dict:
    seqs = [data.seq_of(u) for u in range(1, data.user_num)]
    graph = co_interaction_graph(seqs, data.user_num - 1, data.item_num, min_count)
    clusters = _detect(graph, algorithm, resolution, seed)
    clusters = np.where(clusters >= max_clusters, -1, clusters)
    counts = Counter(int(c) for c in clusters if c >= 0)
    payload = {
        tag_version: {
            "category_counts": {f"cluster_{c}": n for c, n in sorted(counts.items())},
            "tag_to_category": {
                str(c): [f"cluster_{c}"] for c in sorted(counts.keys())
            },
        }
    }
    # user_cluster column is indexed by uid (0 = pad)
    user_clusters = np.concatenate([[-1], clusters])
    return payload, user_clusters


def write_prior_dict(payload: Dict, data_path: str, dataset: str, kind: str):
    path = os.path.join(data_path, f"{dataset}_{kind}.json")
    with open(path, "w") as fh:
        json.dump(payload, fh)
    return path
