"""The port's SE2 estimate on the CPU: its plain version
(``algorithms/estimation.py:estimate_se2_reference``) against a float64
reference on the cases that kernel E1's card tests
(``tests/test_torch_estimate_cuda.py``) hold the kernel to, so both rest on
the same reference; the CPU entries never load the kernel's library; the
kernel wrapper's launch plan and input checks, which need no card.

The module imports neither JAX nor the JAX package: the card tests import
its cases and reference.
"""

import math

import numpy as np
import pytest
import torch

from beluga_tpu_torch.algorithms import estimation
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.ops import _build, cuda_estimate

FAR_M, FAR_SPREAD_M = 300.0, 1e-3  # a cluster far from the origin, 1 mm across
UNDERFLOW_LOG_WEIGHT = -200.0  # expf gives 0 in float32


def estimate_case(lead, n, seed, far=False, device="cpu"):
    """SE2 states ``[*lead, n]``, log-weights and active counts from the
    seed.  ``far``: the translations ``FAR_M`` from the origin within
    ``FAR_SPREAD_M``.  With more than 2 filters, filter 0 has no live slot,
    filter 1's log-weights all underflow, the rest a ragged live prefix
    (at least one filter full)."""
    rng = np.random.default_rng(seed)
    b = math.prod(lead)
    if far:
        xy = FAR_M + rng.normal(0.0, FAR_SPREAD_M, (b, n, 2))
    else:
        xy = rng.normal(rng.uniform(-20.0, 20.0, (b, 1, 2)), rng.uniform(0.05, 3.0, (b, 1, 1)),
                        (b, n, 2))
    theta = rng.normal(rng.uniform(-math.pi, math.pi, (b, 1)), 0.3, (b, n))
    log_w = rng.normal(0.0, 1.0, (b, n))
    active = np.full(b, n)
    if b > 2:
        active[0] = 0
        log_w[1] = UNDERFLOW_LOG_WEIGHT
        active[3:] = rng.integers(1, n + 1, b - 3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    states = SE2.from_xytheta(f32(xy[..., 0]).reshape(*lead, n), f32(xy[..., 1]).reshape(*lead, n),
                              f32(theta).reshape(*lead, n))
    return (states, f32(log_w).reshape(*lead, n),
            torch.as_tensor(active, dtype=torch.int32, device=device).reshape(lead))


def live_weights(log_weight, active):
    """``ParticleSet.weight`` and ``ParticleSet.mask`` of the case."""
    mask = torch.arange(log_weight.shape[-1], device=log_weight.device) < active[..., None]
    return torch.where(mask, torch.exp(log_weight), 0.0), mask


def estimate_float64(states: SE2, weights):
    """The plain version's arithmetic in float64 on the float32 inputs:
    ``(mean xy [..., 2], rotation [..., 2], covariance [..., 3, 3])``."""
    w = weights.double()
    xy, z = states.xy.double(), states.rot.z.double()
    wn = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-38)
    corr = torch.clamp_min(1.0 - (wn * wn).sum(-1), 1e-9)
    mean = (wn[..., None] * xy).sum(-2)
    d = xy - mean[..., None, :]
    cov_t = torch.einsum("...n,...ni,...nj->...ij", wn, d, d) / corr[..., None, None]
    mz = (wn[..., None] * z).sum(-2)
    norm = torch.linalg.vector_norm(mz, dim=-1)
    degenerate = norm < 1e-7
    identity = torch.stack([torch.ones_like(norm), torch.zeros_like(norm)], -1)
    rot = torch.where(degenerate[..., None], identity, mz / torch.clamp_min(norm, 1e-38)[..., None])
    cov = torch.zeros((*norm.shape, 3, 3), dtype=torch.float64, device=norm.device)
    cov[..., :2, :2] = cov_t
    yaw_var = -2.0 * torch.log(torch.clamp_min(norm, 1e-38))
    cov[..., 2, 2] = torch.where(degenerate, math.inf, yaw_var)
    return mean, rot, cov


def estimate_errors(mean: SE2, cov, want) -> dict:
    """The largest gap, over filters, of each part of an estimate from the
    float64 one: ``xy``, ``rot``, ``cov_t`` (the translation block) and
    ``yaw_var`` (finite entries; an infinite one must be infinite in both)."""
    w_xy, w_rot, w_cov = want
    got_yaw, want_yaw = cov[..., 2, 2].double(), w_cov[..., 2, 2]
    assert torch.equal(torch.isinf(got_yaw), torch.isinf(want_yaw))
    finite = ~torch.isinf(want_yaw)
    yaw_gap = (got_yaw - want_yaw).abs()[finite]
    off = cov.double().clone()
    off[..., :2, :2] = 0.0
    off[..., 2, 2] = 0.0
    assert not off.any(), "the yaw row and column must be zero off the diagonal"
    return dict(xy=float((mean.xy.double() - w_xy).abs().max()),
                rot=float((mean.rot.z.double() - w_rot).abs().max()),
                cov_t=float((cov[..., :2, :2].double() - w_cov[..., :2, :2]).abs().max()),
                yaw_var=float(yaw_gap.max()) if yaw_gap.numel() else 0.0)


# the plain float32 version against float64, each part's largest gap over
# its scale (the case's largest float64 magnitude): about 10x what these
# cases read on the CPU (xy 1.4e-7, rot 6.6e-8, cov_t 3.5e-7, yaw_var 2.3e-6);
# the covariance of a cluster far from the origin reads 2.4e-4 to 1.4e-3 (its
# mean is rounded to 300 m's 3e-5 spacing, which moves the centred sums by
# that squared against a 1e-6 variance)
PLAIN_REL = {"xy": 2e-6, "rot": 1e-6, "cov_t": 1e-5, "yaw_var": 5e-5}
PLAIN_REL_FAR = {"xy": 2e-6, "rot": 1e-6, "cov_t": 5e-3, "yaw_var": 5e-5}


def scales(want) -> dict:
    w_xy, w_rot, w_cov = want
    yaw = w_cov[..., 2, 2][~torch.isinf(w_cov[..., 2, 2])]
    return dict(xy=float(w_xy.abs().max()), rot=1.0, cov_t=float(w_cov[..., :2, :2].abs().max()),
                yaw_var=float(yaw.abs().max()) if yaw.numel() else 1.0)


@pytest.mark.parametrize("lead,n,far", [((16,), 600, False), ((16,), 600, True), ((), 2000, True),
                                        ((2, 3), 257, False)])
def test_plain_version_matches_float64(lead, n, far):
    states, log_w, active = estimate_case(lead, n, seed=n, far=far)
    w, mask = live_weights(log_w, active)
    mean, cov = estimation.estimate_se2(states, w, mask)
    want = estimate_float64(states, w)
    gaps, scale = estimate_errors(mean, cov, want), scales(want)
    rel = PLAIN_REL_FAR if far else PLAIN_REL
    for part, gap in gaps.items():
        assert gap <= rel[part] * scale[part], (part, gap, scale[part])
    if math.prod(lead) > 2:
        # no live slot, and every weight underflowed: the zero estimate
        for f in (0, 1):
            assert not mean.xy.reshape(-1, 2)[f].any()
            assert mean.rot.z.reshape(-1, 2)[f].tolist() == [1.0, 0.0]
            assert cov.reshape(-1, 3, 3)[f, 2, 2] == math.inf


def test_cancelled_headings_against_float64():
    """Headings in exactly opposite pairs of equal weight: yaw 0 with an
    infinite variance, in both versions."""
    n = 4096
    theta = np.repeat(np.random.default_rng(3).uniform(-1.0, 1.0, n // 2), 2)
    theta[1::2] += np.pi
    xy = torch.as_tensor(np.random.default_rng(4).normal(2.0, 0.5, (n, 2)), dtype=torch.float32)
    z = torch.as_tensor(np.stack([np.cos(theta), np.sin(theta)], -1), dtype=torch.float32)
    z[1::2] = -z[0::2]
    states = SE2(xy, SO2(z))
    mean, cov = estimation.estimate_se2(states, torch.ones(n))
    _, rot64, cov64 = estimate_float64(states, torch.ones(n))
    assert mean.rot.z.tolist() == [1.0, 0.0] and float(cov[2, 2]) == math.inf
    assert rot64.tolist() == [1.0, 0.0] and float(cov64[2, 2]) == math.inf


def test_cpu_entries_never_load_the_kernel(monkeypatch):
    """``estimate_se2``, ``default_estimate`` and ``recovery_se2_from_draws``
    on CPU tensors run the plain version, as they did before the kernel,
    bit for bit, and never load the kernel's library."""
    from beluga_tpu_torch.core.particles import ParticleSet
    from beluga_tpu_torch.core.random import normal_se2_from_draws
    from beluga_tpu_torch.filters.amcl import AmclParams, default_estimate
    from beluga_tpu_torch.filters.ndt_builders import recovery_se2_from_draws

    def refuse(name):
        raise AssertionError(f"the CPU path loaded csrc/{name}.cu")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(cuda_estimate._estimate, "_fn", None)
    states, log_w, active = estimate_case((8,), 512, seed=5)
    particles = ParticleSet(states, log_w, active)
    want = estimation.estimate_se2_reference(states, particles.weight, particles.mask)
    for mean, cov in (default_estimate(AmclParams(), particles),
                      estimation.estimate_se2(states, particles.weight, particles.mask),
                      estimation.estimate_se2_log(states, log_w, active)):
        assert torch.equal(mean.xy, want[0].xy) and torch.equal(mean.rot.z, want[0].rot.z)
        assert torch.equal(cov, want[1])
    z = torch.as_tensor(np.random.default_rng(6).normal(size=(8, 64, 3)), dtype=torch.float32)
    got = recovery_se2_from_draws(z, particles)
    expect = normal_se2_from_draws(z, want[0], want[1] + 1e-6 * torch.eye(3))
    # filter 0 has no live slot: an infinite yaw variance, NaN draws in both
    for a, b in ((got.xy, expect.xy), (got.rot.z, expect.rot.z)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("n,filters,pairs,chunks", [
    (4096, 4096, 4, 1), (2000, 1, 2, 1), (4096, 64, 2, 2), (2**21, 1, 4, 512),
    (2096152, 1, 4, 512), (262144, 1, 2, 128), (0, 5, 2, 1), (4097, 200, 4, 2)])
def test_launch_plan(n, filters, pairs, chunks):
    """Tiles of 4096 slots, or 2048 where 4096 would leave SMs of an H100
    idle; a filter spans the tiles it needs, at least one."""
    assert cuda_estimate.estimate_plan(n, filters, 132) == (pairs, chunks)
    tile = 2 * cuda_estimate.THREADS * pairs
    assert chunks * tile >= n and (chunks - 1) * tile < max(n, 1)


def spec(shape, strides=None, dtype=torch.float32, device=torch.device("cuda", 0)):
    if strides is None:
        strides = torch.empty(shape).stride() if shape else ()
    return (tuple(shape), tuple(strides), dtype, device)


def test_kernel_input_checks():
    """The wrapper's checks, on the inputs' shapes, strides, dtypes and
    devices alone (no card needed): float32 states, dense particle rows,
    filter axes of one stride (0 where broadcast), one device."""
    layout = cuda_estimate._layout.__wrapped__
    b, n = 4, 10
    xy, z, w, act = spec((b, n, 2)), spec((b, n, 2)), spec((b, n)), spec((b,), dtype=torch.int32)
    assert layout(xy, z, w, None, act)[1:] == (n, b, n, 0, 2 * n, 2 * n, 1)
    # tree_scatter's result: rows of n + 1 slots cut to n
    cut = spec((b, n, 2), (2 * (n + 1), 2, 1))
    assert layout(cut, cut, w, None, act)[5:7] == (2 * (n + 1), 2 * (n + 1))
    # weights broadcast over the filters, one filter, and two filter axes
    shared_w, shared_mask = spec((b, n), (0, 1)), spec((b, n), (0, 1), torch.bool)
    assert layout(xy, z, shared_w, shared_mask, None)[3:5] == (0, 0)
    assert layout(spec((n, 2)), spec((n, 2)), spec((n,)), None, spec((), dtype=torch.int32))[2] == 1
    assert layout(spec((2, 2, n, 2)), spec((2, 2, n, 2)), spec((2, 2, n)), None,
                  spec((2, 2), dtype=torch.int32))[2] == 4
    for bad in (
            dict(xy=spec((b, n, 2), dtype=torch.float64)),  # float64 states
            dict(w=spec((b, n), dtype=torch.float64)),  # float64 weights
            dict(xy=spec((b, n, 2), (2 * n, 4, 1))),  # every other particle
            dict(z=spec((b, n, 2), (2 * n, 1, n))),  # (cos, sin) not adjacent
            dict(w=spec((b, n), (n, 2))),  # strided weights
            dict(xy=spec((b, n, 2), device=torch.device("cpu"))),  # a CPU tensor
            dict(z=spec((b, n, 2), device=torch.device("cuda", 1))),  # another card
            dict(w=spec((b, n - 1))),  # the wrong particle count
            dict(active=spec((b,), dtype=torch.int64))):  # int64 counts
        args = dict(xy=xy, z=z, w=w, mask=None, active=act) | bad
        with pytest.raises(ValueError):
            layout(args["xy"], args["z"], args["w"], args["mask"], args["active"])
    # two filter axes that do not flatten to one stride
    with pytest.raises(ValueError, match="one stride"):
        layout(spec((2, 2, n, 2), (8 * n, 2 * n, 2, 1)), spec((2, 2, n, 2)), spec((2, 2, n)),
               None, spec((2, 2), dtype=torch.int32))


def test_kernel_entries_refuse_cpu_tensors():
    states, log_w, active = estimate_case((2,), 16, seed=7)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_estimate.estimate_se2_log(states, log_w, active)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_estimate.estimate_se2_weights(states, torch.exp(log_w))
