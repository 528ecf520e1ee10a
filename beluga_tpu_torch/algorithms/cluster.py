"""Cluster-based SE2 estimate (port of ``beluga_tpu/algorithms/cluster.py``).

Particles are bucketed by spatial hash (x, y, θ at the clustering
resolution); per-cell weights are mean-normalized and capped at a
percentile; every cell climbs to its heaviest dominating 6-neighbour and
pointer jumping finds the roots; the heaviest cluster with more than one
particle gives the weighted mean and covariance
(cluster_based_estimation.hpp).  When no multi-particle cluster exists the
plain estimate is returned.  Nothing is read back to the host.

Two forms with the same tie-breaking, as in the JAX package: the dense
one (``[N, N]`` equality matrices, the node-size form, N <= 4096; index
applications are gathers, which give exactly the values of the JAX
package's one-hot reductions) and the sparse one (sorted unique cells and
segment sums, for larger filters).  The sparse form keeps every shape
static and every sum deterministic on the card: the unique cells come
from a stable sort of the hashes, boundary flags and a ``cumsum`` (where
``jnp.unique(size=n)`` has no sync-free PyTorch counterpart), padded with
the ``0xFFFFFFFF`` sentinel; the moment sums run over the particles in
cell order and then over the cells in cluster order through
``torch.segment_reduce`` (one pass a segment, in order, on the card),
never through float atomics, so that two calls give the same bits and the
``argmax`` over near-equal clusters cannot flip.
"""

from __future__ import annotations

import dataclasses

import torch

from beluga_tpu_torch.algorithms.estimation import estimate_se2
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.ops.spatial_hash import spatial_hash_se2

Tensor = torch.Tensor

_SENTINEL = 0xFFFFFFFF
DENSE_MAX = 4096


@dataclasses.dataclass(frozen=True)
class ClusterizerParams:
    """Defaults from cluster_based_estimation.hpp:251-266."""

    linear_hash_resolution: float = 0.20
    angular_hash_resolution: float = 0.524
    weight_cap_percentile: float = 0.90


def cluster_based_estimate(
    states: SE2,
    weights: Tensor,
    mask: Tensor | None = None,
    params: ClusterizerParams = ClusterizerParams(),
    method: str = "auto",
):
    """``(SE2 mean, f32[3, 3] cov)`` of the heaviest particle cluster.

    ``method``: ``"dense"``, ``"sparse"``, or ``"auto"`` (dense up to 4096
    particles, sparse above)."""
    n = weights.shape[0]
    if method == "auto":
        method = "dense" if n <= DENSE_MAX else "sparse"
    if method == "sparse":
        return _cluster_sparse(states, weights, mask, params)
    if method != "dense":
        raise ValueError(f"unknown method: {method!r}")
    return _cluster_dense(states, weights, mask, params)


def _neighbour_hashes(rx, ry, rc, rs, params: ClusterizerParams) -> Tensor:
    """The hashes ``[..., 6]`` of the 6-neighbourhood cells of representative
    states (x, y, cos, sin), ``pose * SE2(offset)`` for each offset, in one
    hash of the six at once (cluster.py:130-150)."""
    lin, ang = params.linear_hash_resolution, params.angular_hash_resolution
    # the offsets are float32 constants, as in the JAX package; to the card
    # from pinned memory, a copy that does not wait on the stream
    offsets = torch.tensor([[lin, -lin, 0.0, 0.0, 0.0, 0.0], [0.0, 0.0, lin, -lin, 0.0, 0.0],
                            [0.0, 0.0, 0.0, 0.0, ang, -ang]], dtype=torch.float32)
    if rx.is_cuda:
        offsets = offsets.pin_memory().to(rx.device, non_blocking=True)
    ox, oy, oth = offsets
    rx, ry, rc, rs = (v[..., None] for v in (rx, ry, rc, rs))
    nx = rx + rc * ox - rs * oy
    ny = ry + rs * ox + rc * oy
    nth = SO2.exp(torch.atan2(rs, rc) + oth).log()
    return spatial_hash_se2(torch.stack([nx, ny], -1), nth, lin, ang)


def _moment_columns(states: SE2, w: Tensor, mask: Tensor) -> Tensor:
    """The per-particle raw moments ``[N, 10]``: w, w·x, w·y, w·cos, w·sin,
    w·x², w·y², w·x·y, w², and the live flag."""
    x, y = states.x, states.y
    cz, sz = states.rot.cos, states.rot.sin
    return torch.stack(
        [w, w * x, w * y, w * cz, w * sz, w * x * x, w * y * y, w * x * y,
         w * w, mask.float()],
        dim=-1,
    )


def _hash_lookup(sorted_hashes: Tensor, valid_count: Tensor, queries: Tensor) -> Tensor:
    """Indices of the query hashes in the sorted-unique-hash table, -1 where
    absent (cluster.py:55)."""
    idx = torch.searchsorted(sorted_hashes, queries.contiguous())
    idx = torch.clamp(idx, 0, sorted_hashes.shape[0] - 1)
    found = (sorted_hashes[idx] == queries) & (idx < valid_count)
    return torch.where(found, idx, -1)


def _segment_sums(sorted_rows: Tensor, segment_of_row: Tensor, n: int) -> Tensor:
    """Sums ``[n, k]`` of rows ``[R, k]`` that come in segment order, segment
    ``s`` holding the rows with ``segment_of_row == s`` (empty segments sum
    to 0): one ordered pass a segment, the same bits on every call."""
    lengths = torch.zeros(n, dtype=torch.int64, device=sorted_rows.device)
    lengths.scatter_add_(0, segment_of_row, torch.ones_like(segment_of_row))
    return torch.segment_reduce(sorted_rows, "sum", lengths=lengths, axis=0, unsafe=True)


def _cluster_sparse(states: SE2, weights: Tensor, mask: Tensor | None,
                    params: ClusterizerParams):
    """The sparse form (cluster.py:63-185) with static shapes: ``n`` cells
    and ``n`` clusters, the unused ones empty."""
    n = weights.shape[0]
    dev = weights.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    w = torch.where(mask, weights.float(), 0.0)
    iota = torch.arange(n, device=dev)
    lin, ang = params.linear_hash_resolution, params.angular_hash_resolution

    h = spatial_hash_se2(states.xy, states.theta, lin, ang)
    h = torch.where(mask, h, _SENTINEL)

    # -- unique cells (make_cluster_map, hpp:139-158), static size n ---------
    h_sorted, order = torch.sort(h, stable=True)
    boundary = torch.ones(n, dtype=torch.int64, device=dev)
    boundary[1:] = (h_sorted[1:] != h_sorted[:-1]).to(torch.int64)
    cell_sorted = torch.cumsum(boundary, dim=0) - 1  # cell of each sorted particle
    sorted_hashes = torch.full((n,), _SENTINEL, dtype=torch.int64, device=dev)
    sorted_hashes.scatter_(0, cell_sorted, h_sorted)  # equal values a cell
    num_cells = torch.sum(sorted_hashes != _SENTINEL)
    cell_valid = iota < num_cells

    cols = _moment_columns(states, w, mask)
    cell_sums = _segment_sums(cols[order], cell_sorted, n)  # [cell, 10]
    cell_count = cell_sums[:, 9]
    # representative state: the first live particle (input order) of a cell
    first = torch.full((n,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, cell_sorted, torch.where(mask[order], order, n), "amin")
    rep = torch.clamp(first, 0, n - 1)

    # -- normalize by count and cap at the percentile (hpp:175-189) ----------
    cell_w = torch.where(cell_valid, cell_sums[:, 0] / torch.clamp_min(cell_count, 1.0), 0.0)
    order_w = torch.sort(torch.where(cell_valid, cell_w, float("inf"))).values
    k = (num_cells.float() * params.weight_cap_percentile).to(torch.int64)
    cap = order_w.index_select(0, torch.clamp(k, 0, n - 1).reshape(1))[0]
    cap = torch.where(torch.isfinite(cap), cap, float("inf"))
    cell_w = torch.minimum(cell_w, cap)

    # -- rank: descending weight, ascending hash (the stable argsort) --------
    perm = torch.argsort(-torch.where(cell_valid, cell_w, float("-inf")), stable=True)
    rank = torch.empty_like(perm).scatter_(0, perm, iota)

    # -- parents over the 6-neighbourhood (hpp:279-283, 315-323) -------------
    neigh = _neighbour_hashes(states.x[rep], states.y[rep], states.rot.cos[rep],
                              states.rot.sin[rep], params)  # [n, 6]
    neigh_idx = _hash_lookup(sorted_hashes, num_cells, neigh)
    safe = torch.clamp(neigh_idx, 0, n - 1)
    nr = torch.where(neigh_idx >= 0, rank[safe], n)
    dominates = nr < rank[:, None]
    best = torch.argmin(torch.where(dominates, nr, n), dim=1)
    parent = torch.where(dominates.any(dim=1), torch.gather(safe, 1, best[:, None])[:, 0], iota)
    parent = torch.where(cell_valid, parent, iota)

    # -- pointer jumping to the roots, a static round count ------------------
    for _ in range(max(1, (max(n, 2) - 1).bit_length())):
        parent = parent[parent]

    # -- per-cluster raw moments: the cells' sums, in cluster order ----------
    by_root = torch.argsort(parent, stable=True)
    sums = _segment_sums(cell_sums[by_root], parent[by_root], n)
    W, Wx, Wy, Wc, Ws, Wxx, Wyy, Wxy, W2, cnt = sums.unbind(dim=1)
    eligible = (cnt > 1.5) & (parent == iota)  # roots only
    return _pick_cluster(W, Wx, Wy, Wc, Ws, Wxx, Wyy, Wxy, W2, eligible,
                         states, weights, mask)


def _cluster_dense(states: SE2, weights: Tensor, mask: Tensor | None,
                   params: ClusterizerParams):
    n = weights.shape[0]
    dev = weights.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    w = torch.where(mask, weights.float(), 0.0)
    iota = torch.arange(n, device=dev)
    lin, ang = params.linear_hash_resolution, params.angular_hash_resolution

    h = spatial_hash_se2(states.xy, states.theta, lin, ang)
    h = torch.where(mask, h, _SENTINEL)

    # -- cells: same-hash equality over alive particles ----------------------
    eq = (h[:, None] == h[None, :]) & mask[:, None] & mask[None, :]  # [N, N]
    rep = torch.amin(torch.where(eq, iota[None, :], n), dim=1)
    rep = torch.where(mask, rep, iota)
    is_rep = mask & (rep == iota)
    cell_cnt = torch.sum(eq, dim=1, dtype=torch.float32)
    cell_w = torch.sum(torch.where(eq, w[None, :], 0.0), dim=1) / torch.clamp_min(
        cell_cnt, 1.0
    )  # mean weight, carried at every member (hpp:175-189)

    # -- percentile cap ------------------------------------------------------
    num_cells = torch.sum(is_rep, dtype=torch.int32)
    order = torch.sort(torch.where(is_rep, cell_w, float("inf"))).values
    k = (num_cells.float() * params.weight_cap_percentile).to(torch.int64)
    cap = order.index_select(0, torch.clamp(k, 0, n - 1).reshape(1))[0]
    cap = torch.where(torch.isfinite(cap), cap, float("inf"))
    cell_w = torch.minimum(cell_w, cap)

    # -- rank: number of cells dominating (desc weight, asc hash) ------------
    dom = is_rep[None, :] & (
        (cell_w[None, :] > cell_w[:, None])
        | ((cell_w[None, :] == cell_w[:, None]) & (h[None, :] < h[:, None]))
    )
    rank = torch.sum(dom, dim=1)

    # -- parents over the 6-neighbourhood ------------------------------------
    best_nr = torch.full((n,), n, dtype=rank.dtype, device=dev)
    best_idx = iota
    neigh = _neighbour_hashes(states.x[rep], states.y[rep], states.rot.cos[rep],
                              states.rot.sin[rep], params)  # [N, 6]
    for nh in neigh.unbind(dim=1):
        match = is_rep[None, :] & (h[None, :] == nh[:, None])  # <= 1 true per row
        valid = match.any(dim=1)
        nr = torch.sum(torch.where(match, rank[None, :], 0), dim=1)
        nidx = torch.sum(torch.where(match, iota[None, :], 0), dim=1)
        nr = torch.where(valid, nr, n)
        better = (nr < rank) & (nr < best_nr)
        best_nr = torch.where(better, nr, best_nr)
        best_idx = torch.where(better, nidx, best_idx)
    parent = torch.where(is_rep & (best_nr < rank), best_idx, iota)

    # -- pointer jumping to the roots ----------------------------------------
    for _ in range(max(1, (max(n, 2) - 1).bit_length())):
        parent = parent[parent]
    root_p = parent[rep]

    # -- per-cluster raw moments (full float32 matmul) -----------------------
    memb = ((root_p[None, :] == iota[:, None]) & mask[None, :]).float()  # [root, particle]
    sums = memb @ _moment_columns(states, w, mask)
    W, Wx, Wy, Wc, Ws, Wxx, Wyy, Wxy, W2, cnt = sums.unbind(dim=1)
    eligible = (cnt > 1.5) & mask & (root_p == iota)  # roots only
    return _pick_cluster(W, Wx, Wy, Wc, Ws, Wxx, Wyy, Wxy, W2, eligible,
                         states, weights, mask)


def _pick_cluster(W, Wx, Wy, Wc, Ws, Wxx, Wyy, Wxy, W2, eligible,
                  states, weights, mask):
    """Raw moments → the heaviest eligible cluster's SE2 estimate, with the
    plain-estimate fallback (cluster_based_estimation.hpp:423-426)."""
    Wsafe = torch.clamp_min(W, 1e-38)
    mx, my = Wx / Wsafe, Wy / Wsafe
    mc, ms = Wc / Wsafe, Ws / Wsafe
    corr = torch.clamp_min(1.0 - W2 / (Wsafe * Wsafe), 1e-9)
    cxx = (Wxx / Wsafe - mx * mx) / corr
    cyy = (Wyy / Wsafe - my * my) / corr
    cxy = (Wxy / Wsafe - mx * my) / corr
    norm = torch.sqrt(mc * mc + ms * ms)
    yaw_var = torch.where(
        norm < 1e-7, float("inf"), -2.0 * torch.log(torch.clamp_min(norm, 1e-38))
    )

    any_eligible = eligible.any()
    best = torch.argmax(torch.where(eligible, W, float("-inf")))
    stats = torch.stack([mx, my, mc, ms, norm, cxx, cyy, cxy, yaw_var], dim=1)
    # index_select, not stats[best]: a 0-d index tensor is read back
    bx, by, bc, bs, bn, bxx, byy, bxy, byaw = stats.index_select(0, best.reshape(1))[0]
    xy = torch.stack([bx, by])
    z = torch.stack([bc, bs]) / torch.clamp_min(bn, 1e-38)
    zero = torch.zeros_like(bx)
    cov = torch.stack([
        torch.stack([bxx, bxy, zero]),
        torch.stack([bxy, byy, zero]),
        torch.stack([zero, zero, byaw]),
    ])

    fb_mean, fb_cov = estimate_se2(states, weights, mask)
    mean = SE2(
        torch.where(any_eligible, xy, fb_mean.xy),
        SO2(torch.where(any_eligible, z, fb_mean.rot.z)),
    )
    return mean, torch.where(any_eligible, cov, fb_cov)
