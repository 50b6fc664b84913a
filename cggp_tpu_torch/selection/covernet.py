"""Device-resident greedy delta-net selection, "covernet" (port of
``cggp_tpu/selection/covernet.py``).

The net keeps the two properties the CGGP models consume from the cover
tree's leaf level: every pair of centres is more than ``resolution`` apart
(which bounds the conditioning of ``Kuu + Lambda``), and every data point
lies within ``resolution`` of a centre.  Scan order defines it: ``x[0]`` is
a centre, and ``x[i]`` becomes one iff it is further than ``resolution``
from every earlier centre.

The scan runs on the device in blocks of ``block_size`` points.  Within a
block, parallel-MIS rounds reproduce the sequential result: each round
accepts every candidate with no earlier surviving candidate in range, then
drops everything the new centres cover, as ``[B, B]`` mask algebra.  JAX
stops the rounds inside ``lax.while_loop``; here the host reads the stop
rule (any candidate left) once every :data:`MIS_ROUNDS_PER_READ` rounds.
A round on an empty candidate set changes nothing, so the grouped rounds
give bitwise the same net.  :data:`scan_counts` counts the host reads and
the rounds.

The accept test compares ``|a|^2 + |b|^2 - 2 a.b`` with ``resolution^2``;
the cross term is an IEEE fp32 (or fp64) matmul, TF32 off on CUDA
(:func:`~cggp_tpu_torch.config.require_ieee_fp32_matmul`), as JAX computes
it at ``Precision.HIGHEST``.  The cluster statistics are segment sums in a
fixed order (:func:`~cggp_tpu_torch.selection.kmeans._segment_sums`), so a
selection repeats bitwise on the card.

The ``_padded`` functions keep JAX's static ``[capacity, ...]`` shapes:
real centres first, then pads at ``1e6 * (1 + slot)`` in every coordinate
with count 1, pseudo-u 0 and mask 0.  The scan masks slots by the count,
never by coordinates, and a pad's squared distance (~1e12 and up) never
wins a nearest-centre argmin, so re-selection (:func:`make_device_recluster_fn`)
and streaming ingest never change a tensor's shape.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import torch

from cggp_tpu_torch.config import default_float, require_ieee_fp32_matmul, resolve_device
from cggp_tpu_torch.selection.kmeans import _segment_sums, kmeans_indices_and_distances
from cggp_tpu_torch.selection.update import _means_and_counts_from_labels

# MIS rounds between two host reads of the "any candidate left" rule.
MIS_ROUNDS_PER_READ = 4

# Host reads of the scans (MIS stop rules, overflow and count reads) and the
# MIS rounds run, since the caller last set them to 0.
scan_counts = {"host_reads": 0, "mis_rounds": 0}


def _as_points(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A tensor on ``like``'s device and dtype; numpy input without ``like``
    becomes the default float on the default device, as ``jnp.asarray``
    makes the default float."""
    if like is not None:
        return torch.as_tensor(x).to(device=like.device, dtype=like.dtype)
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x).to(device=resolve_device(None), dtype=default_float())


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances [n, m], the cross term a
    full-precision matmul (the accept test sits at the boundary)."""
    if a.is_cuda:
        require_ieee_fp32_matmul()
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    return torch.clamp(a2[:, None] + b2[None, :] - 2.0 * (a @ b.T), min=0.0)


def _kernel_metric(kernel, kp, a: torch.Tensor, b: torch.Tensor,
                   distance_type: str) -> torch.Tensor:
    """Kernel-induced distance [n, m]: ``"covariance"`` gives the squared
    distance ``k(a,a) + k(b,b) - 2 k(a,b)`` (compared with resolution^2),
    ``"correlation"`` gives ``1 - k(a,b) / sqrt(k(a,a) k(b,b))``."""
    if a.is_cuda:
        require_ieee_fp32_matmul()
    k_ab = kernel.K(kp, a, b)
    da = kernel.K_diag(kp, a)
    db = kernel.K_diag(kp, b)
    if distance_type == "covariance":
        return torch.clamp(da[:, None] + db[None, :] - 2.0 * k_ab, min=0.0)
    return 1.0 - k_ab / torch.sqrt(da[:, None] * db[None, :])


def _scan_loop(pair_metric, x_pad: torch.Tensor, n_valid: int, thresh: torch.Tensor,
               max_points: int, block_size: int, z_init: Optional[torch.Tensor] = None,
               count_init=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked exact greedy net scan over a pairwise metric: ``(z
    [max_points, D], count, overflow)``, the last two 0-d tensors on the
    device.  ``overflow`` is True iff an accepted point was dropped for
    lack of buffer space.  ``z_init``/``count_init`` continue a scan from
    an accepted prefix (streaming)."""
    npad, d = x_pad.shape
    device, dtype = x_pad.device, x_pad.dtype
    bidx = torch.arange(block_size, device=device)
    earlier = bidx[None, :] < bidx[:, None]  # [i, j]: j precedes i
    slots = torch.arange(max_points, device=device)
    # One row past the buffer takes the writes of rows that are not written.
    z = torch.zeros((max_points + 1, d), dtype=dtype, device=device)
    if z_init is None:
        count = torch.zeros((), dtype=torch.int64, device=device)
    else:
        z[:max_points] = z_init
        count = torch.as_tensor(count_init, device=device).to(torch.int64).reshape(())
    overflow = torch.zeros((), dtype=torch.bool, device=device)
    inf = torch.tensor(float("inf"), dtype=dtype, device=device)
    for b in range(npad // block_size):
        start = b * block_size
        xb = x_pad[start:start + block_size]
        valid = (start + bidx) < n_valid

        # Candidates: valid points no accepted centre covers.
        d2_acc = pair_metric(xb, z[:max_points])
        min_d2 = torch.where((slots < count)[None, :], d2_acc, inf).amin(dim=1)
        del d2_acc
        cand = valid & (min_d2 > thresh)

        conflict = pair_metric(xb, xb) <= thresh  # the diagonal included
        blocking = conflict & earlier
        accepted = torch.zeros_like(cand)
        while True:
            for _ in range(MIS_ROUNDS_PER_READ):
                blocked = (blocking & cand[None, :]).any(dim=1)
                a_round = cand & ~blocked
                covered = (conflict & a_round[None, :]).any(dim=1)
                cand = cand & ~covered
                accepted = accepted | a_round
            scan_counts["mis_rounds"] += MIS_ROUNDS_PER_READ
            scan_counts["host_reads"] += 1
            if not bool(cand.any()):
                break

        # Append in scan order; what does not fit is dropped.
        pos = count + torch.cumsum(accepted.to(torch.int64), dim=0) - 1
        write = accepted & (pos < max_points)
        z.index_copy_(0, torch.where(write, pos, torch.full_like(pos, max_points)), xb)
        overflow = overflow | (accepted & ~write).any()
        count = torch.clamp(count + accepted.sum(), max=max_points)
    return z[:max_points], count, overflow


def _pad_blocks(x: torch.Tensor, block_size: int) -> Tuple[torch.Tensor, int, int]:
    """Clamp ``block_size`` to the data (a power of two, at least 64) and pad
    the rows to a block multiple with copies of ``x[0]`` (the scan rejects
    rows past ``n_valid``): ``(x_pad, n_valid, block_size)``."""
    n, d = x.shape
    block_size = int(min(block_size, max(64, 1 << max(n - 1, 1).bit_length())))
    pad = (-n) % block_size
    x_pad = torch.cat([x, x[:1].expand(pad, d)]) if pad else x
    return x_pad, n, block_size


def _threshold(resolution: float, distance_type: str, kernel, kernel_params,
               like: torch.Tensor) -> torch.Tensor:
    if distance_type not in ("euclidean", "covariance", "correlation"):
        raise ValueError(f"unknown distance_type {distance_type!r}")
    if distance_type != "euclidean" and (kernel is None or kernel_params is None):
        raise ValueError(f"distance_type={distance_type!r} needs kernel and kernel_params")
    thresh = torch.tensor(resolution, dtype=like.dtype, device=like.device)
    return thresh if distance_type == "correlation" else thresh ** 2


def _metric(distance_type: str, kernel, kernel_params):
    if distance_type == "euclidean":
        return _sqdist
    return lambda a, b: _kernel_metric(kernel, kernel_params, a, b, distance_type)


def covernet_select(x, resolution: float, max_points: Optional[int] = None,
                    block_size: int = 4096, distance_type: str = "euclidean", kernel=None,
                    kernel_params=None) -> Tuple[torch.Tensor, int]:
    """Greedy delta-net over ``x`` in scan order: ``(z [m, D], m)``.

    Unsaturated, every pair of centres is further than ``resolution`` apart
    and every point within ``resolution`` of a centre, in the chosen metric.
    ``max_points`` is a hard cap (the net is truncated with a warning);
    without it the buffer starts at 1024 and doubles until the net fits.
    ``distance_type="covariance"`` keeps centre pairs with ``k(a,a) +
    k(b,b) - 2 k(a,b) > resolution^2``, ``"correlation"`` pairs with ``1 -
    k(a,b) / sqrt(k(a,a) k(b,b)) > resolution`` (OIPS's rule with ``rho =
    1 - resolution``)."""
    x = _as_points(x)
    n = x.shape[0]
    x_pad, n_valid, block_size = _pad_blocks(x, block_size)
    thresh = _threshold(resolution, distance_type, kernel, kernel_params, x_pad)
    if distance_type == "covariance":
        # A stationary kernel's covariance distance cannot exceed
        # sqrt(2 * variance): past it the net is one centre.
        var = float(torch.mean(kernel.K_diag(kernel_params, x[:1])))
        if resolution ** 2 >= 2.0 * var:
            warnings.warn(
                f"covernet: covariance resolution {resolution} >= "
                f"sqrt(2*variance)={(2 * var) ** 0.5:.4g} — the metric cannot exceed it, so "
                "only one center will be kept; lower the resolution (it lives on the "
                "kernel's scale, not the input's).")
    elif distance_type == "correlation" and resolution >= 1.0:
        warnings.warn(
            f"covernet: correlation resolution {resolution} >= 1 — positive-kernel "
            "correlation distance cannot exceed 1, so only one center will be kept; use a "
            "resolution in (0, 1) (the OIPS rho is 1 - resolution).")
    metric = _metric(distance_type, kernel, kernel_params)

    cap = min(1024, max(n, 64)) if max_points is None else min(max(int(max_points), 1), n)
    while True:
        z, count, overflow = _scan_loop(metric, x_pad, n_valid, thresh, cap, block_size)
        scan_counts["host_reads"] += 2
        m = int(count)
        if not bool(overflow):
            break
        if max_points is not None:
            warnings.warn(
                f"covernet: net truncated at max_points={cap} (resolution {resolution} wants "
                "more centers); separation holds, coverage is incomplete — raise max_points "
                "or the resolution.")
            break
        cap = min(cap * 2, n)
    return z[:m], m


def covernet_extend(z, x_new, resolution: float, max_points: Optional[int] = None,
                    block_size: int = 4096) -> Tuple[torch.Tensor, int]:
    """Grow the net ``z`` over new data: ``(z', m')``, the old centres
    unchanged as a prefix, then every new point that clears ``resolution``
    against all centres before it.  Equal to ``covernet_select`` over the
    old and new data together when ``z`` was the old data's net.
    ``max_points`` caps the total; existing centres are never dropped."""
    z = _as_points(z)
    x_new = _as_points(x_new, like=z)
    m0, d = z.shape
    x_pad, n_valid, block_size = _pad_blocks(x_new, block_size)
    delta2 = torch.tensor(resolution, dtype=z.dtype, device=z.device) ** 2

    warned_below = False
    if max_points is None:
        cap = max(64, 1 << (max(m0 + 64, 1) - 1).bit_length())
    else:
        if int(max_points) < m0:
            warnings.warn(
                f"covernet_extend: max_points={int(max_points)} is below the existing net "
                f"size {m0}; existing centers are never dropped, so no new centers will be "
                "accepted.")
            warned_below = True
        cap = max(int(max_points), m0)

    while True:
        z_init = torch.zeros((cap, d), dtype=z.dtype, device=z.device)
        z_init[:m0] = z
        zb, count, overflow = _scan_loop(_sqdist, x_pad, n_valid, delta2, cap, block_size,
                                         z_init=z_init, count_init=m0)
        scan_counts["host_reads"] += 2
        m = int(count)
        if not bool(overflow):
            break
        if max_points is not None:
            if not warned_below:
                warnings.warn(
                    f"covernet_extend: net truncated at max_points={int(max_points)} "
                    f"(buffer {cap}); separation holds, coverage of the new data is "
                    "incomplete.")
            break
        cap *= 2
    return zb[:m], m


def _column(t, like: torch.Tensor) -> torch.Tensor:
    t = _as_points(t, like=like)
    return t[:, None] if t.ndim == 1 else t


def _voronoi_sums_counts(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """Per-cluster y sums [M, P] and raw counts [M, 1] (no empty-cell
    clipping: the streaming merge adds them)."""
    labels, _ = kmeans_indices_and_distances(z, x)
    ones = torch.ones((x.shape[0], 1), dtype=y.dtype, device=y.device)
    sums = _segment_sums(torch.cat([y, ones], dim=-1), labels, z.shape[0])
    return sums[:, :-1], sums[:, -1:]


def covernet_extend_update(z, pseudo_u, cluster_counts, data_new, resolution: float,
                           max_points: Optional[int] = None,
                           block_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor,
                                                             torch.Tensor]:
    """Streaming update of ``(Z, pseudo_u, cluster_counts)`` with a new data
    block: the net grows (:func:`covernet_extend`), each new point joins its
    nearest centre of the grown net, and the clusters' running means and
    counts merge (``counts' = counts + n_new``, ``u' = (u counts + sum_new)
    / counts'``).  Old points keep their assignments; recorded counts count
    as true counts (an empty-cell sentinel, count 1 and mean 0, absorbs one
    phantom zero)."""
    z = _as_points(z)
    x_new = _as_points(data_new[0], like=z)
    y_new = _column(data_new[1], z)
    u = _as_points(pseudo_u, like=z)
    counts = _column(cluster_counts, z)
    m0 = z.shape[0]

    z_ext, _m1 = covernet_extend(z, x_new, resolution, max_points, block_size)
    new_sums, new_counts = _voronoi_sums_counts(x_new, y_new, z_ext)
    old_sums = torch.zeros_like(new_sums)
    old_sums[:m0] = u * counts
    old_counts = torch.zeros_like(new_counts)
    old_counts[:m0] = counts
    safe_counts = torch.clamp(old_counts + new_counts, min=1.0)
    return z_ext, (old_sums + new_sums) / safe_counts, safe_counts


def covernet_extend_update_padded(z, pseudo_u, cluster_counts, mask, data_new,
                                  resolution: float, block_size: int = 4096):
    """Fixed-capacity streaming ingest: :func:`covernet_extend_update` with
    every input and output ``[capacity, ...]`` (real clusters first, pads
    after, ``mask`` marking the real rows, prefix-contiguous), so the
    ingest never changes a shape.  A net that outgrows the capacity is
    truncated without a warning (JAX's jitted twin cannot warn): separation
    holds, coverage of the new data stops there; watch ``mask.sum()``.
    Returns ``(Z, u, counts, mask)``."""
    z = _as_points(z)
    x_new = _as_points(data_new[0], like=z)
    y_new = _column(data_new[1], z)
    u = _as_points(pseudo_u, like=z)
    counts = _column(cluster_counts, z)
    mask = _column(mask, z)
    capacity = z.shape[0]

    m0 = torch.sum(mask).to(torch.int64)
    x_pad, n_valid, block_size = _pad_blocks(x_new, block_size)
    delta2 = torch.tensor(resolution, dtype=z.dtype, device=z.device) ** 2
    # The scan masks slots by the count, so the far pads pass through and
    # new centres overwrite pad slots in place.
    z_ext, count, _overflow = _scan_loop(_sqdist, x_pad, n_valid, delta2, capacity,
                                         block_size, z_init=z, count_init=m0)
    mask_ext = (torch.arange(capacity, device=z.device) < count)[:, None].to(z.dtype)

    new_sums, new_counts = _voronoi_sums_counts(x_new, y_new, z_ext)
    # Pad rows carry the count-1 sentinel: masked out of the merge.
    total = counts * mask + new_counts
    safe = torch.clamp(total, min=1.0)
    means = (u * counts * mask + new_sums) / safe * mask_ext
    counts_out = torch.where(mask_ext > 0, safe, torch.ones_like(safe))
    return z_ext, means, counts_out, mask_ext


def _lloyds_round(x: torch.Tensor, z: torch.Tensor, delta2: torch.Tensor) -> torch.Tensor:
    """One separation-preserving mean-shift round."""
    labels, _ = kmeans_indices_and_distances(z, x)
    m = z.shape[0]
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    sums = _segment_sums(torch.cat([x, ones], dim=-1), labels, m)
    counts = sums[:, -1]
    proposed = torch.where((counts > 0)[:, None],
                           sums[:, :-1] / torch.clamp(counts, min=1.0)[:, None], z)
    off = ~torch.eye(m, dtype=torch.bool, device=z.device)
    inf = torch.tensor(float("inf"), dtype=z.dtype, device=z.device)
    d_pp = torch.where(off, _sqdist(proposed, proposed), inf).amin(dim=1)
    d_po = torch.where(off, _sqdist(proposed, z), inf).amin(dim=1)
    ok = torch.minimum(d_pp, d_po) > delta2
    return torch.where(ok[:, None], proposed, z)


def covernet_lloyds(x, z, resolution: float, rounds: int = 1) -> torch.Tensor:
    """Lloyd's refinement that keeps the separation: a centre moves to its
    Voronoi cell's mean only if that position clears ``resolution``
    against both the proposed and the current position of every other
    centre.  Coverage relaxes to at most 2x ``resolution``."""
    x = _as_points(x)
    z = _as_points(z, like=x)
    delta2 = torch.tensor(resolution, dtype=x.dtype, device=x.device) ** 2
    for _ in range(int(rounds)):
        z = _lloyds_round(x, z, delta2)
    return z


def _voronoi_means_counts(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    labels, _ = kmeans_indices_and_distances(z, x)
    return _means_and_counts_from_labels(y, labels, z.shape[0])


def covernet_update_inducing_parameters(data, spatial_resolution: float,
                                        max_points: Optional[int] = None, lloyds: int = 1,
                                        block_size: int = 4096,
                                        distance_type: str = "euclidean", kernel=None,
                                        kernel_params=None):
    """The device net to ``(Z, pseudo_u, cluster_counts)``: the scan,
    ``lloyds`` separation-preserving Lloyd's rounds (euclidean only), then
    Voronoi labels (euclidean, whatever the selection metric) and the
    clusters' means and counts (an emptied cell: count 1, mean 0)."""
    x = _as_points(data[0])
    y = _column(data[1], x)
    if distance_type != "euclidean" and lloyds:
        raise ValueError("covernet Lloyd's refinement is euclidean-only; pass lloyds=0 with "
                         f"distance_type={distance_type!r}")
    z, m = covernet_select(x, spatial_resolution, max_points, block_size,
                           distance_type=distance_type, kernel=kernel,
                           kernel_params=kernel_params)
    if m == x.shape[0] and m > 1:
        warnings.warn(f"covernet: resolution {spatial_resolution} kept all {m} points as "
                      "centers; increase the resolution for an actual reduction.")
    if lloyds:
        z = covernet_lloyds(x, z, spatial_resolution, rounds=lloyds)
    means, counts = _voronoi_means_counts(x, y, z)
    return z, means, counts


def covernet_update_padded(x: torch.Tensor, y: torch.Tensor, spatial_resolution: float,
                           capacity: int, block_size: int = 4096, lloyds: int = 0,
                           distance_type: str = "euclidean", kernel=None, kernel_params=None):
    """Fixed-capacity covernet update: ``(Z, u, counts, mask)``, each
    ``[capacity, ...]``, real centres first and pads after (coordinates
    ``1e6 * (1 + slot)``, count 1, pseudo-u 0, mask 0).  The scan reads
    nothing on the host but its MIS stop rules; a net larger than
    ``capacity`` is truncated without a warning (watch ``mask.sum()``)."""
    thresh = _threshold(spatial_resolution, distance_type, kernel, kernel_params, x)
    if lloyds and distance_type != "euclidean":
        raise ValueError("covernet Lloyd's refinement is euclidean-only; pass lloyds=0 with "
                         f"distance_type={distance_type!r}")
    y = y[:, None] if y.ndim == 1 else y

    d = x.shape[1]
    x_pad, n_valid, block_size = _pad_blocks(x, block_size)
    capacity = int(capacity)
    z_buf, count, _overflow = _scan_loop(_metric(distance_type, kernel, kernel_params), x_pad,
                                         n_valid, thresh, capacity, block_size)
    slot = torch.arange(capacity, device=x.device) < count
    far = 1.0e6 * (1.0 + torch.arange(1, capacity + 1, dtype=x.dtype, device=x.device))
    z = torch.where(slot[:, None], z_buf, far[:, None].expand(capacity, d))
    if lloyds:
        delta2 = torch.tensor(spatial_resolution, dtype=x.dtype, device=x.device) ** 2
        for _ in range(int(lloyds)):
            # Pads have empty cells (they never win the argmin): they stay.
            z = _lloyds_round(x, z, delta2)
    means, counts = _voronoi_means_counts(x, y, z)
    mask = slot.to(x.dtype)[:, None]
    return z, means * mask, counts, mask


def make_device_recluster_fn(model, data, spatial_resolution: float, capacity: int,
                             block_size: int = 4096, lloyds: int = 0,
                             distance_type: str = "euclidean"):
    """``recluster(params) -> params``: the fixed-capacity covernet update
    swapped in by ``model.assign_clusters_device``, for params built with
    ``init_params(..., capacity=capacity)``.  Under a kernel metric the
    selection reads the current kernel parameters on every call, so
    re-selection inside training follows the hyperparameters."""
    x = _as_points(data[0])
    y = _as_points(data[1], like=x)
    multiple = model._pad_multiple_for(int(capacity))
    if int(capacity) % multiple != 0:
        raise ValueError(
            f"capacity {capacity} must be a multiple of {multiple} (the model's pad "
            "multiple: mesh size for ShardedCGGP, panel block for ImplicitCGGP)")

    def recluster(params: Dict) -> Dict:
        kernel_kwargs = ({} if distance_type == "euclidean"
                         else {"kernel": model.kernel,
                               "kernel_params": {k: v.detach()
                                                 for k, v in params["kernel"].items()}})
        with torch.no_grad():
            z, u, counts, mask = covernet_update_padded(
                x, y, spatial_resolution, capacity, block_size=block_size, lloyds=lloyds,
                distance_type=distance_type, **kernel_kwargs)
        return model.assign_clusters_device(params, z, u, counts, mask)

    return recluster
