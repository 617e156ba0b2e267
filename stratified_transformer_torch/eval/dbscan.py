"""DBSCAN on scipy, with the labels of ``sklearn.cluster.DBSCAN(eps,
min_samples).fit(x).labels_`` (the JAX package's instance decomposition and
scene cleaning cluster with scikit-learn, which the port does not use).

sklearn's rules, which `dbscan_labels` keeps:

- a point's neighbourhood is every point within ``eps``, itself included,
  the distance compared as ``sum((x - y)**2) <= eps * eps`` in float64, the
  form of sklearn's k-d tree;
- a point is core when its neighbourhood holds at least ``min_samples``
  points;
- clusters are the connected components of the core points' neighbour
  graph, numbered in the index order of their first core point;
- a border point (not core, a core point in its neighbourhood) takes the
  lowest cluster number among its core neighbours, since sklearn grows the
  clusters one after another in that order;
- every other point is noise, -1.

sklearn searches by brute force instead of its k-d tree for fewer than 12
points (``NearestNeighbors``' default 5 neighbours reach half of them), and
there computes the distance by the dot-product form ``|x|^2 - 2 x.y +
|y|^2``, which can round the other way for a pair within an ulp of
``eps``; both forms are exact on coordinates with few significant bits.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree


def candidate_pairs(x, radius):
    """``(i, j, d2)``: every pair ``i < j`` of rows of ``x`` that a k-d tree
    finds within a little more than ``radius``, with ``d2 = sum((x_i -
    x_j)**2)`` summed over the columns in order (the sum of sklearn's k-d
    tree and of scipy's ``cdist``), so that a caller tests the threshold
    exactly as they do."""
    x = np.asarray(x, np.float64)
    pairs = cKDTree(x).query_pairs(float(radius) * (1 + 1e-9),
                                   output_type="ndarray")
    i, j = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
    d2 = np.zeros(len(i))
    for c in range(x.shape[1]):
        d = x[i, c] - x[j, c]
        d2 = d2 + d * d
    return i, j, d2


def dbscan_labels(x, eps, min_samples):
    """Cluster labels of the rows of ``x`` ``[n, d]``: 0, 1, ... per cluster,
    -1 for noise, int64 (module docstring)."""
    x = np.asarray(x, np.float64)
    n = len(x)
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    i, j, d2 = candidate_pairs(x, eps)
    keep = d2 <= float(eps) * float(eps)
    i, j = i[keep], j[keep]
    count = 1 + np.bincount(i, minlength=n) + np.bincount(j, minlength=n)
    core = count >= min_samples
    if not core.any():
        return labels
    # components of the core graph, numbered by their first core point
    both = core[i] & core[j]
    graph = coo_matrix((np.ones(int(both.sum()), np.int8),
                        (i[both], j[both])), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    core_idx = np.flatnonzero(core)
    first = np.full(n, n, np.int64)
    np.minimum.at(first, comp[core_idx], core_idx)
    starts = np.sort(first[first < n])
    number = np.empty(n, np.int64)
    number[comp[starts]] = np.arange(len(starts))
    labels[core_idx] = number[comp[core_idx]]
    # border points: the lowest cluster among their core neighbours
    big = np.iinfo(np.int64).max
    border = np.full(n, big, np.int64)
    for a, b in ((i, j), (j, i)):
        sel = core[a] & ~core[b]
        np.minimum.at(border, b[sel], labels[a[sel]])
    hit = border < big
    labels[hit] = border[hit]
    return labels
