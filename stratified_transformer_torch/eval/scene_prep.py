"""Custom-scene preparation of the layout-removal pipeline (the JAX
package's ``eval/scene_prep.py``; reference fork ``data_load_custom``,
``test.py:117-156``): an ``.obj`` mesh's vertices, DBSCAN outlier removal
(`dbscan.dbscan_labels`: the largest clusters kept, noise dropped),
rotation about the upright axis that aligns the dominant horizontal
direction with +x (the PCA of the cleaned points, in place of the
reference's open3d box), and a shift to the minimum corner.
"""

from __future__ import annotations

import numpy as np

from stratified_transformer_torch.data.ply import load_obj_vertices
from stratified_transformer_torch.eval.dbscan import dbscan_labels


def remove_outliers(points, eps=0.2, min_samples=10, keep_ratio=0.05):
    """Drop DBSCAN noise and clusters under ``keep_ratio`` of the largest
    one's size. Returns ``(kept points, keep mask)``; all points when no
    cluster forms."""
    labels = dbscan_labels(points, eps, min_samples)
    sizes = np.bincount(labels[labels >= 0])
    if not len(sizes):
        return points, np.ones(len(points), bool)
    big = np.flatnonzero(sizes >= keep_ratio * sizes.max())
    keep = np.isin(labels, big)
    return points[keep], keep


def horizontal_obb_align(points, upright_axis=2):
    """Rotate about the upright axis so that the dominant horizontal
    direction aligns with +x. Returns ``(aligned float32 points, rotation)``
    with ``aligned = points @ rotation``."""
    pts = np.asarray(points, np.float64)
    horiz = [a for a in range(3) if a != upright_axis]
    centered = pts[:, horiz] - pts[:, horiz].mean(0)
    cov = centered.T @ centered / max(len(pts), 1)
    w, v = np.linalg.eigh(cov)
    major = v[:, np.argmax(w)]
    angle = np.arctan2(major[1], major[0])
    # row vectors: ``x @ rot`` rotates by -angle, the major axis onto +x
    c, s = np.cos(angle), np.sin(angle)
    rot = np.eye(3)
    rot[np.ix_(horiz, horiz)] = np.array([[c, -s], [s, c]])
    return (pts @ rot).astype(np.float32), rot


def prepare_custom_scene(path_or_points, eps=0.2, min_samples=10):
    """Load (an ``.obj`` path or points), remove outliers, align, shift to
    the minimum corner. Returns ``(points, rotation, keep_mask)``."""
    if isinstance(path_or_points, str):
        points = load_obj_vertices(path_or_points)
    else:
        points = np.asarray(path_or_points, np.float32)
    cleaned, keep = remove_outliers(points, eps, min_samples)
    aligned, rot = horizontal_obb_align(cleaned)
    return aligned - aligned.min(0), rot, keep
