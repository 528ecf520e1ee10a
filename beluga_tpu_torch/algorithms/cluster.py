"""Cluster-based SE2 estimate, dense node-size form (port of
``beluga_tpu/algorithms/cluster.py:_cluster_based_estimate_dense``).

Particles are bucketed by spatial hash (x, y, θ at the clustering
resolution); per-cell weights are mean-normalized and capped at a
percentile; every cell climbs to its heaviest dominating 6-neighbour and
pointer jumping finds the roots; the heaviest cluster with more than one
particle gives the weighted mean and covariance
(cluster_based_estimation.hpp).  Cells are found with ``[N, N]``
equality matrices, the node-size form (N <= 4096).  Index applications
(``rep``, ``p[p]``) are gathers, which give exactly the values of the JAX
package's one-hot reductions.  When no multi-particle cluster exists the
plain estimate is returned.  Nothing is read back to the host.
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

    ``method``: ``"dense"``, or ``"auto"`` (dense up to 4096 particles).
    The sparse form for larger filters waits for ROADMAP item A8."""
    n = weights.shape[0]
    if method == "auto":
        method = "dense" if n <= DENSE_MAX else "sparse"
    if method == "sparse":
        raise NotImplementedError(
            "the sparse cluster estimate (N > 4096) is not ported yet (ROADMAP A8)"
        )
    if method != "dense":
        raise ValueError(f"unknown method: {method!r}")
    return _cluster_dense(states, weights, mask, params)


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
    rx, ry = states.x[rep], states.y[rep]
    rc, rs = states.rot.cos[rep], states.rot.sin[rep]
    rep_theta = torch.atan2(rs, rc)
    offsets = (
        (lin, 0.0, 0.0), (-lin, 0.0, 0.0), (0.0, lin, 0.0),
        (0.0, -lin, 0.0), (0.0, 0.0, ang), (0.0, 0.0, -ang),
    )
    best_nr = torch.full((n,), n, dtype=rank.dtype, device=dev)
    best_idx = iota
    f32 = torch.float32
    for ox, oy, oth in offsets:
        # offsets are float32 constants, as in the JAX package
        ox, oy, oth = (float(torch.tensor(v, dtype=f32)) for v in (ox, oy, oth))
        nx = rx + rc * ox - rs * oy
        ny = ry + rs * ox + rc * oy
        nth = SO2.exp(rep_theta + oth).log()
        nh = spatial_hash_se2(torch.stack([nx, ny], -1), nth, lin, ang)
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
    x, y = states.x, states.y
    cz, sz = states.rot.cos, states.rot.sin
    cols = torch.stack(
        [w, w * x, w * y, w * cz, w * sz, w * x * x, w * y * y, w * x * y,
         w * w, mask.float()],
        dim=-1,
    )
    sums = memb @ cols
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
