"""OPTICS clustering of 2-D points: scikit-learn's algorithm, with the
distances and the ordering loop in float64 torch on a device, batched over
many point sets.

The geocell generator of the JAX package clusters each cell with
``sklearn.cluster.OPTICS(min_samples, xi, min_cluster_size)`` and its
other defaults (``max_eps=inf``, minkowski p=2, ``cluster_method="xi"``,
``predecessor_correction=True``).  The card's machine has no scikit-learn,
so this module is the port's copy of that algorithm.  It follows
scikit-learn 1.9.0's ``sklearn/cluster/_optics.py`` (BSD-3-Clause,
https://github.com/scikit-learn/scikit-learn): ``compute_optics_graph``
and ``_set_reach_dist`` become the batched torch loop below;
``cluster_optics_xi``, ``_extend_region``, ``_update_filter_sdas``,
``_correct_predecessor``, ``_xi_cluster`` and ``_extract_xi_labels`` are
copied as numpy on the host, since they walk the reachability plot in
order.  Every array equals scikit-learn's bit for bit:

* A core distance is the ``min_samples``-th smallest distance to the
  set's points, the point itself included, rounded to 15 decimals.
  scikit-learn's k-nearest-neighbour query takes it from a kd-tree,
  ``sqrt(dx*dx + dy*dy)``, except where ``min_samples >= n // 2`` (at the
  default ``min_samples=5``: sets of 11 points or fewer), where it runs
  brute force through BLAS: ``|x|^2 - 2 x.y + |y|^2`` with each 2-term dot
  product one fused multiply-add, ``fma(x1, y1, x0 * y0)``, clipped at 0
  before the square root.  ``_fma`` computes that fused multiply-add
  exactly from correctly rounded float64 operations (Boldo and
  Melquiond's emulation through rounding to odd), so the CPU and the card
  give the same bits.
* The loop's distances are ``pairwise_distances(..., "minkowski", p=2)``:
  ``sqrt(dx*dx + dy*dy)`` computed directly (never ``torch.cdist``'s
  matrix-product route), then ``max(d, core[p])`` rounded to 15
  decimals; an unprocessed point's reachability and predecessor change
  only where that is strictly smaller.
* The next point is the unprocessed one of least reachability, the
  smallest index on a tie, +inf ties included: a processed point never
  competes, whatever its value.

``optics_many`` takes many point sets at once.  They go into (B, N)
buckets by size (sets of ``min_samples >= n // 2`` apart, since their
core distances take the brute-force route), and each step of a bucket's
loop is one batched argmin and one batched update over the sets still
running, so a bucket takes its largest n in steps.  Pad slots are never
picked, never a neighbour, and never change a real slot.  Every reduction
is a min or a comparison, so a set's arrays do not depend on what it was
batched with.  The k-nearest-neighbour pass goes by chunks of rows, so a
20,000-point set never forms its whole N x N matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from geoguessr_ai_torch.config import resolve_device

#: Veltkamp's splitter for float64: 2^27 + 1.
_SPLITTER = 134217729.0
#: Distance elements the k-nearest-neighbour pass forms at once.
_KNN_CHUNK_ELEMS = 1 << 24
#: Slots (sets x largest set) of one bucket.
_BUCKET_ELEMS = 1 << 24
#: A bucket takes sets down to this fraction of its largest.
_BUCKET_SPAN = 0.5


@dataclass
class OpticsResult:
    """scikit-learn's ``ordering_``, ``core_distances_``,
    ``reachability_``, ``predecessor_`` and ``labels_`` of one set."""

    ordering: np.ndarray
    core_distances: np.ndarray
    reachability: np.ndarray
    predecessor: np.ndarray
    labels: np.ndarray


# ---------------------------------------------------------------------------
# Exact float64 arithmetic for the brute-force core distances
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    """(s, e): s = a + b rounded, e its exact error (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    """(p, e): p = a * b rounded, e its exact error (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _round_to_odd(v, err):
    """Round-to-odd of v + err, where v is v + err rounded to nearest:
    v itself when exact or odd, else its neighbour toward err."""
    odd = (v.view(torch.int64) & 1) == 1
    toward = torch.nextafter(v, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where((err == 0) | odd, v, toward)


def _fma(a, b, c):
    """a * b + c rounded once, from float64 operations that each round
    once (Boldo and Melquiond, "Emulation of a FMA and correctly rounded
    sums: proved algorithms using rounding to odd", IEEE Trans. Computers
    57(4), 2008); exact for operands whose products neither overflow nor
    fall below 2^-960."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    v, err = _two_sum(tl, ul)
    return th + _round_to_odd(v, err)


def _sqrt_rn(x):
    """Square root rounded to nearest.  The card's float64 sqrt is
    (IEEE 754); PyTorch's vectorised CPU sqrt can be one unit in the last
    place off, so on the CPU numpy takes it (the processor's square-root
    instruction)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _sq_brute(x0, x1, y0, y1):
    """scikit-learn's brute-force squared distance: |x|^2 + (-2 x.y) +
    |y|^2, each dot product one fused multiply-add, clipped at 0."""
    nx = _fma(x1, x1, x0 * x0)
    ny = _fma(y1, y1, y0 * y0)
    mid = -2.0 * _fma(x1, y1, x0 * y0)
    return torch.clamp_min((nx + mid) + ny, 0.0)


# ---------------------------------------------------------------------------
# The reachability graph on the device
# ---------------------------------------------------------------------------


def _core_distances(xy, valid, min_samples, brute):
    """(B, N) core distances of a bucket, rounded to 15 decimals."""
    B, N, _ = xy.shape
    x0, x1 = xy[..., 0], xy[..., 1]
    out = torch.empty(B, N, dtype=torch.float64, device=xy.device)
    rows = max(1, _KNN_CHUNK_ELEMS // (B * N))
    far = ~valid[:, None, :]
    for r0 in range(0, N, rows):
        a0 = x0[:, r0:r0 + rows, None]
        a1 = x1[:, r0:r0 + rows, None]
        if brute:
            sq = _sq_brute(a0, a1, x0[:, None, :], x1[:, None, :])
        else:
            dx = a0 - x0[:, None, :]
            dy = a1 - x1[:, None, :]
            sq = dx * dx + dy * dy
        sq = sq.masked_fill(far, torch.inf)
        kth = sq.topk(min_samples, dim=2, largest=False).values[..., -1]
        out[:, r0:r0 + rows] = _sqrt_rn(kth)
    return torch.round(out, decimals=15)


def _optics_graph(xy, sizes, min_samples, brute):
    """compute_optics_graph over one bucket: xy (B, N, 2) float64 with
    the sets in descending size; returns numpy (ordering, core,
    reachability, predecessor), each (B, N)."""
    B, N, _ = xy.shape
    dev = xy.device
    slot = torch.arange(N, device=dev)
    valid = slot[None, :] < torch.as_tensor(sizes, device=dev)[:, None]
    core = _core_distances(xy, valid, min_samples, brute)
    # x, y and core distance of every slot, gathered at once for the point
    xyc = torch.cat([xy, core[..., None]], dim=2)
    reach = torch.full((B, N), torch.inf, dtype=torch.float64, device=dev)
    pred = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    unproc = valid.clone()
    ordering = torch.zeros((B, N), dtype=torch.int64, device=dev)
    # sets still running at each step: a prefix, the sizes descending
    running = np.searchsorted(-np.asarray(sizes), -np.arange(N), side="left")
    for t in range(int(sizes[0])):
        k = int(running[t])
        r, u = reach[:k], unproc[:k]
        key = torch.where(u, r, torch.inf)
        cand = (key == key.amin(1, keepdim=True)) & u
        point = torch.where(cand, slot, N).amin(1, keepdim=True)  # (k, 1)
        ordering[:k, t:t + 1] = point
        u.scatter_(1, point, False)
        p = xyc[:k].gather(1, point[..., None].expand(k, 1, 3))
        dx = xyc[:k, :, 0] - p[..., 0]
        dy = xyc[:k, :, 1] - p[..., 1]
        # max_eps is inf, so every core distance is finite and every
        # unprocessed point is a neighbour (_set_reach_dist)
        rd = torch.round(torch.maximum(_sqrt_rn(dx * dx + dy * dy),
                                       p[..., 2]), decimals=15)
        better = (rd < r) & u
        reach[:k] = torch.where(better, rd, r)
        pred[:k] = torch.where(better, point, pred[:k])
    return (ordering.cpu().numpy(), core.cpu().numpy(),
            reach.cpu().numpy(), pred.cpu().numpy())


def _buckets(sizes, min_samples):
    """Index lists of the sets, each in descending size: brute-force sets
    apart, a bucket spanning at most a factor 1 / _BUCKET_SPAN of sizes
    and _BUCKET_ELEMS slots."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    buckets: List[List[int]] = []
    for i in order:
        n = sizes[i]
        brute = min_samples >= n // 2
        if buckets:
            head = sizes[buckets[-1][0]]
            if (brute == (min_samples >= head // 2)
                    and n >= _BUCKET_SPAN * head
                    and (len(buckets[-1]) + 1) * head <= _BUCKET_ELEMS):
                buckets[-1].append(i)
                continue
        buckets.append([i])
    return buckets


# ---------------------------------------------------------------------------
# The xi cluster extraction, on the host (scikit-learn's, as it is)
# ---------------------------------------------------------------------------


def _extend_region(steep_point, xward_point, start, min_samples):
    n_samples = len(steep_point)
    non_xward_points = 0
    index = start
    end = start
    # find a maximal area
    while index < n_samples:
        if steep_point[index]:
            non_xward_points = 0
            end = index
        elif not xward_point[index]:
            # it's not a steep point, but still goes up.
            non_xward_points += 1
            # region should include no more than min_samples consecutive
            # non steep xward points.
            if non_xward_points > min_samples:
                break
        else:
            return end
        index += 1
    return end


def _update_filter_sdas(sdas, mib, xi_complement, reachability_plot):
    if np.isinf(mib):
        return []
    res = [
        sda for sda in sdas
        if mib <= reachability_plot[sda["start"]] * xi_complement
    ]
    for sda in res:
        sda["mib"] = max(sda["mib"], mib)
    return res


def _correct_predecessor(reachability_plot, predecessor_plot, ordering, s,
                         e):
    while s < e:
        if reachability_plot[s] > reachability_plot[e]:
            return s, e
        p_e = predecessor_plot[e]
        for i in range(s, e):
            if p_e == ordering[i]:
                return s, e
        e -= 1
    return None, None


def _xi_cluster(reachability_plot, predecessor_plot, ordering, xi,
                min_samples, min_cluster_size):
    # an inf at the end of the plot finds clusters that end there
    reachability_plot = np.hstack((reachability_plot, np.inf))
    xi_complement = 1 - xi
    sdas = []  # steep down areas
    clusters = []
    index = 0
    mib = 0.0  # maximum in between
    # inf / inf is nan on purpose: it is neither steep nor up nor down (a
    # zero reachability divides by zero too; errstate only hushes both)
    with np.errstate(invalid="ignore", divide="ignore"):
        ratio = reachability_plot[:-1] / reachability_plot[1:]
        steep_upward = ratio <= xi_complement
        steep_downward = ratio >= 1 / xi_complement
        downward = ratio > 1
        upward = ratio < 1

    for steep_index in iter(np.flatnonzero(steep_upward | steep_downward)):
        if steep_index < index:
            continue
        mib = max(mib, np.max(reachability_plot[index:steep_index + 1]))
        if steep_downward[steep_index]:
            sdas = _update_filter_sdas(sdas, mib, xi_complement,
                                       reachability_plot)
            D_start = steep_index
            D_end = _extend_region(steep_downward, upward, D_start,
                                   min_samples)
            D = {"start": D_start, "end": D_end, "mib": 0.0}
            sdas.append(D)
            index = D_end + 1
            mib = reachability_plot[index]
        else:
            sdas = _update_filter_sdas(sdas, mib, xi_complement,
                                       reachability_plot)
            U_start = steep_index
            U_end = _extend_region(steep_upward, downward, U_start,
                                   min_samples)
            index = U_end + 1
            mib = reachability_plot[index]

            U_clusters = []
            for D in sdas:
                c_start = D["start"]
                c_end = U_end
                if reachability_plot[c_end + 1] * xi_complement < D["mib"]:
                    continue
                D_max = reachability_plot[D["start"]]
                if D_max * xi_complement >= reachability_plot[c_end + 1]:
                    while (reachability_plot[c_start + 1]
                           > reachability_plot[c_end + 1]
                           and c_start < D["end"]):
                        c_start += 1
                elif reachability_plot[c_end + 1] * xi_complement >= D_max:
                    while (reachability_plot[c_end - 1] > D_max
                           and c_end > U_start):
                        c_end -= 1
                c_start, c_end = _correct_predecessor(
                    reachability_plot, predecessor_plot, ordering, c_start,
                    c_end)
                if c_start is None:
                    continue
                if c_end - c_start + 1 < min_cluster_size:
                    continue
                if c_start > D["end"]:
                    continue
                if c_end < U_start:
                    continue
                U_clusters.append((c_start, c_end))
            # smaller clusters first
            U_clusters.reverse()
            clusters.extend(U_clusters)

    return np.array(clusters)


def _extract_xi_labels(ordering, clusters):
    labels = np.full(len(ordering), -1, dtype=int)
    label = 0
    for c in clusters:
        if not np.any(labels[c[0]:(c[1] + 1)] != -1):
            labels[c[0]:(c[1] + 1)] = label
            label += 1
    labels[ordering] = labels.copy()
    return labels


def _xi_labels(reachability, predecessor, ordering, min_samples,
               min_cluster_size, xi):
    """Labels of one set's reachability graph by the xi-steep method
    (``sklearn.cluster.cluster_optics_xi`` with predecessor correction;
    min_samples an int)."""
    n_samples = len(reachability)
    if min_cluster_size <= 1:
        min_cluster_size = max(2, int(min_cluster_size * n_samples))
    clusters = _xi_cluster(reachability[ordering], predecessor[ordering],
                           ordering, xi, min_samples, min_cluster_size)
    return _extract_xi_labels(ordering, clusters)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _check(sizes, min_samples, xi, min_cluster_size):
    if isinstance(min_samples, bool) or not isinstance(
            min_samples, (int, np.integer)) or min_samples < 2:
        raise ValueError(f"min_samples must be an int >= 2, got "
                         f"{min_samples!r}")
    if not 0 <= xi <= 1:
        raise ValueError(f"xi must be in [0, 1], got {xi!r}")
    if not (0 < min_cluster_size <= 1 or (
            float(min_cluster_size).is_integer() and min_cluster_size >= 2)):
        raise ValueError(f"min_cluster_size must be a fraction in (0, 1] or "
                         f"an int >= 2, got {min_cluster_size!r}")
    for n in sizes:
        if min_samples > n:
            raise ValueError(f"min_samples must be no greater than the "
                             f"number of samples ({n}), got {min_samples}")
        if min_cluster_size > n:
            raise ValueError(f"min_cluster_size must be no greater than the "
                             f"number of samples ({n}), got "
                             f"{min_cluster_size}")


def optics_many(coords: Sequence[np.ndarray], min_samples: int = 5,
                xi: float = 0.05, min_cluster_size: float = 0.05,
                device=None) -> List[OpticsResult]:
    """``OPTICS(min_samples, xi, min_cluster_size).fit`` of each (n_i, 2)
    array in ``coords``, every ordering loop on ``device`` (None: the
    GPU), batched over the sets.  Returns one OpticsResult a set, in
    order, each equal to the set's own call bit for bit."""
    dev = resolve_device(device)
    sets = [np.ascontiguousarray(c, dtype=np.float64) for c in coords]
    for c in sets:
        if c.ndim != 2 or c.shape[1] != 2:
            raise ValueError(f"each set must be (n, 2), got {c.shape}")
    sizes = [len(c) for c in sets]
    _check(sizes, min_samples, xi, min_cluster_size)
    results: List[OpticsResult] = [None] * len(sets)
    for bucket in _buckets(sizes, min_samples):
        bsizes = [sizes[i] for i in bucket]
        xy = np.zeros((len(bucket), bsizes[0], 2))
        for row, i in enumerate(bucket):
            xy[row, :sizes[i]] = sets[i]
        graph = _optics_graph(torch.from_numpy(xy).to(dev), bsizes,
                              min_samples, min_samples >= bsizes[0] // 2)
        for row, i in enumerate(bucket):
            ordering, core, reach, pred = (a[row, :sizes[i]] for a in graph)
            labels = _xi_labels(reach, pred, ordering, min_samples,
                                min_cluster_size, xi)
            results[i] = OpticsResult(ordering.copy(), core.copy(),
                                      reach.copy(), pred.copy(), labels)
    return results
