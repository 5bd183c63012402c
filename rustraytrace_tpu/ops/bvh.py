"""SAH BVH build in NumPy — the portable reference for native/src/bvh.cpp.

Same algorithm as the reference's BvhNode (src/books/*/bvh.rs:16-156):
binary tree, 12-bucket surface-area heuristic over the centroid bounds'
longest axis (bvh.rs:63-117), sorted-median fallback on degenerate centroids
or non-improving splits (bvh.rs:56-61,118-123,140-145).  Node ids are
assigned preorder so SAH leaves cover contiguous ascending ranges of the
primitive order — the property the cluster cut relies on.  The builders
are platform-independent host code; no render path consumes them yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_NB = 12  # bvh.rs:66 bucket count


def _area(mn, mx) -> float:
    d = np.maximum(mx - mn, 0.0)
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def build_bvh_numpy(centers: np.ndarray, radii: np.ndarray, max_leaf: int = 2):
    centers = np.asarray(centers, np.float32)
    radii = np.abs(np.asarray(radii, np.float32))
    return build_bvh_aabb_numpy(
        centers - radii[:, None], centers + radii[:, None], max_leaf)


def build_bvh_aabb_numpy(pmin: np.ndarray, pmax: np.ndarray,
                         max_leaf: int = 2):
    """Same SAH build over arbitrary primitive AABBs (bucket keys = AABB
    centroids).  Spheres are the centers±radius special case; box primitives
    pass their slabs directly (tight cluster bounds, no bounding-sphere
    inflation)."""
    pmin = np.asarray(pmin, np.float32)
    pmax = np.asarray(pmax, np.float32)
    centers = 0.5 * (pmin + pmax)
    n = centers.shape[0]

    order = np.arange(n)
    bmin, bmax, left, right, leaf = [], [], [], [], []

    def new_node():
        bmin.append(None); bmax.append(None)
        left.append(0); right.append(0); leaf.append(0)
        return len(left) - 1

    def build(lo: int, hi: int) -> int:
        node = new_node()
        ids = order[lo:hi]
        box_mn = pmin[ids].min(axis=0)
        box_mx = pmax[ids].max(axis=0)
        bmin[node] = box_mn
        bmax[node] = box_mx
        cnt = hi - lo
        if cnt <= max_leaf:
            left[node] = -1
            right[node] = -cnt
            leaf[node] = lo
            return node

        cen = centers[ids]
        cmin = cen.min(axis=0)
        cmax = cen.max(axis=0)
        axis = int(np.argmax(cmax - cmin))
        mid = -1
        if cmax[axis] - cmin[axis] > 1e-12:
            key = cen[:, axis]
            b = np.minimum(
                ((key - cmin[axis]) * (_NB / (cmax[axis] - cmin[axis])))
                .astype(np.int32), _NB - 1)
            best_cost, best_split = np.inf, -1
            for s in range(1, _NB):
                lsel = b < s
                lc = int(lsel.sum()); rc = cnt - lc
                if not lc or not rc:
                    continue
                la = _area(pmin[ids[lsel]].min(axis=0), pmax[ids[lsel]].max(axis=0))
                ra = _area(pmin[ids[~lsel]].min(axis=0), pmax[ids[~lsel]].max(axis=0))
                cost = lc * la + rc * ra
                if cost < best_cost:
                    best_cost, best_split = cost, s
            if best_split > 0 and best_cost < cnt * _area(box_mn, box_mx):
                pivot = cmin[axis] + best_split * (cmax[axis] - cmin[axis]) / _NB
                lsel = cen[:, axis] < pivot
                if 0 < lsel.sum() < cnt:
                    order[lo:hi] = np.concatenate([ids[lsel], ids[~lsel]])
                    mid = lo + int(lsel.sum())
        if mid < 0:
            k = np.argsort(cen[:, axis], kind="stable")
            order[lo:hi] = ids[k]
            mid = lo + cnt // 2

        l = build(lo, mid)
        r = build(mid, hi)
        left[node] = l
        right[node] = r
        leaf[node] = -1
        return node

    build(0, n)
    return (np.asarray(bmin, np.float32), np.asarray(bmax, np.float32),
            np.asarray(left, np.int32), np.asarray(right, np.int32),
            np.asarray(leaf, np.int32), order.astype(np.int32))


def cluster_spheres_numpy(centers, radii, max_leaf: int = 16
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    centers = np.asarray(centers, np.float32)
    radii = np.abs(np.asarray(radii, np.float32))
    return cluster_aabbs_numpy(
        centers - radii[:, None], centers + radii[:, None], max_leaf)


def cluster_aabbs_numpy(pmin, pmax, max_leaf: int = 16
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    bmin, bmax, left, right, leaf, order = build_bvh_aabb_numpy(
        pmin, pmax, max_leaf)
    is_leaf = leaf >= 0
    starts = leaf[is_leaf]
    counts = -right[is_leaf]
    assert np.all(starts == np.concatenate([[0], np.cumsum(counts)[:-1]]))
    cluster_start = np.concatenate([starts, [starts[-1] + counts[-1]]]).astype(np.int32)
    return order, cluster_start, bmin[is_leaf], bmax[is_leaf]
