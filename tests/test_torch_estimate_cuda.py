"""Kernel E1 (``csrc/estimate.cu``, the SE2 estimate) on the card, against
the plain version run in float64 on the same inputs
(``tests/test_torch_estimate.py``'s cases and reference, which the CPU
tests hold the plain version to).

Tolerance, each part of the estimate (mean translation, rotation,
translation covariance, yaw variance) over every filter of a case: at most 4
times the plain float32 version's own largest gap from float64 on the card
for the same inputs, plus 2 float32 units in the last place of the part's
largest magnitude (the kernel sums in another order, so where the plain
version happens to land exactly it need not).

Every test here needs an NVIDIA GPU and skips without one.  The module
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_estimate_cuda.py
"""

import math

import numpy as np
import pytest
import torch
from test_torch_estimate import (
    UNDERFLOW_LOG_WEIGHT,
    estimate_case,
    estimate_errors,
    estimate_float64,
    live_weights,
)

pytestmark = pytest.mark.cuda

ULP = 2.0**-23


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def hold_to_float64(kernel_out, plain_out, want) -> dict:
    """Asserts the tolerance of the module's docstring; returns the gaps."""
    got, plain = estimate_errors(*kernel_out, want), estimate_errors(*plain_out, want)
    w_xy, _, w_cov = want
    yaw = w_cov[..., 2, 2][~torch.isinf(w_cov[..., 2, 2])]
    scale = dict(xy=float(w_xy.abs().max()), rot=1.0,
                 cov_t=float(w_cov[..., :2, :2].abs().max()),
                 yaw_var=float(yaw.abs().max()) if yaw.numel() else 0.0)
    for part, gap in got.items():
        limit = 4.0 * plain[part] + 2.0 * ULP * scale[part]
        assert gap <= limit, (part, gap, plain[part], limit)
    return dict(kernel=got, plain=plain)


CASES = {
    # the fleets' 4096 x 4096: a ragged live prefix, no live slot in filter 0,
    # every weight of filter 1 underflowed
    "fleet": ((4096,), 4096, False),
    "fleet_far": ((4096,), 4096, True),
    "small_fleet": ((64,), 4096, False),
    "small_fleet_far": ((64,), 4096, True),
    "node": ((), 2000, False),
    "mega": ((), 2097152, False),
    "mega_far": ((), 2097152, True),
    "ragged_mega": ((), 2096152, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_e1_matches_float64(dev, case):
    from beluga_tpu_torch.algorithms import estimation
    from beluga_tpu_torch.ops import cuda_estimate

    lead, n, far = CASES[case]
    states, log_w, active = estimate_case(lead, n, seed=len(case) + n, far=far, device=dev)
    w, mask = live_weights(log_w, active)
    before = cuda_estimate.launches
    got = estimation.estimate_se2_log(states, log_w, active)
    assert cuda_estimate.launches == before + 1
    plain = estimation.estimate_se2_reference(states, w, mask)
    gaps = hold_to_float64(got, plain, estimate_float64(states, w))
    print(case, gaps)
    if lead:
        # filter 0 has no live slot, filter 1's weights all underflow
        for f in (0, 1):
            assert not got[0].xy[f].any() and got[0].rot.z[f].tolist() == [1.0, 0.0]
            assert not got[1][f, :2].any() and float(got[1][f, 2, 2]) == math.inf
        assert float(log_w[1, 0]) == UNDERFLOW_LOG_WEIGHT


def test_e1_weight_entry(dev):
    """``estimate_se2`` on CUDA tensors: linear weights with a mask, and
    weights and a mask broadcast over the filters, as the plain version
    takes them."""
    from beluga_tpu_torch.algorithms import estimation

    states, log_w, active = estimate_case((64,), 4096, seed=11, device=dev)
    w, mask = live_weights(log_w, active)
    holes = torch.rand(w.shape, generator=torch.Generator(dev).manual_seed(1), device=dev) < 0.2
    mask = mask & ~holes
    got = estimation.estimate_se2(states, w, mask)
    plain = estimation.estimate_se2_reference(states, w, mask)
    hold_to_float64(got, plain, estimate_float64(states, torch.where(mask, w, 0.0)))
    shared_w, shared_mask = w[5], mask[5]
    got = estimation.estimate_se2(states, shared_w, shared_mask)
    plain = estimation.estimate_se2_reference(states, shared_w, shared_mask)
    want_w = torch.where(shared_mask, shared_w, 0.0).expand(64, -1)
    hold_to_float64(got, plain, estimate_float64(states, want_w))


def test_e1_cancelled_headings(dev):
    """Headings in exactly opposite pairs of equal weight: yaw 0 and an
    infinite variance, as the plain version gives, at one tile and past it."""
    from beluga_tpu_torch.algorithms import estimation
    from beluga_tpu_torch.lie import SE2, SO2

    for n in (4096, 262144):
        theta = np.repeat(np.random.default_rng(n).uniform(-1.0, 1.0, n // 2), 2)
        z = torch.as_tensor(np.stack([np.cos(theta), np.sin(theta)], -1), dtype=torch.float32)
        z[1::2] = -z[0::2]
        xy = torch.as_tensor(np.random.default_rng(1).normal(2.0, 0.5, (n, 2)), dtype=torch.float32)
        states = SE2(xy.to(dev), SO2(z.to(dev)))
        mean, cov = estimation.estimate_se2(states, torch.ones(n, device=dev))
        assert mean.rot.z.tolist() == [1.0, 0.0] and float(cov[2, 2]) == math.inf
        plain_mean, plain_cov = estimation.estimate_se2_reference(states, torch.ones(n, device=dev))
        assert plain_mean.rot.z.tolist() == [1.0, 0.0] and float(plain_cov[2, 2]) == math.inf


def test_e1_strided_rows_in_the_fleet_update(dev):
    """The default estimate of states whose filter rows are strided (the
    pooled injection's ``tree_scatter`` cuts rows of N + 1 to N), which
    take the kernel's scalar loads, against its plain version."""
    from beluga_tpu_torch.algorithms import estimation
    from beluga_tpu_torch.core.particles import ParticleSet, tree_scatter
    from beluga_tpu_torch.filters.amcl import AmclParams, default_estimate

    states, log_w, active = estimate_case((64,), 4096, seed=12, device=dev)
    target = torch.full((64, 8), 4096, dtype=torch.int64, device=dev)  # every entry dropped
    cut = tree_scatter(states, target, estimate_case((64,), 8, seed=13, device=dev)[0])
    assert not cut.xy.is_contiguous() and torch.equal(cut.xy, states.xy)
    particles = ParticleSet(cut, log_w, active)
    got = default_estimate(AmclParams(), particles)
    plain = estimation.estimate_se2_reference(cut, particles.weight, particles.mask)
    hold_to_float64(got, plain, estimate_float64(cut, particles.weight))


def test_e1_bits_repeat_and_one_launch(dev):
    """Two calls give the same bits, at one tile a filter and across 512
    tiles; each call is one kernel launch (counted on the host: late in a
    long run the profiler may record none of the card's kernels) and no
    PyTorch reduction."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from beluga_tpu_torch.algorithms import estimation
    from beluga_tpu_torch.ops import cuda_estimate

    for lead, n in (((4096,), 4096), ((), 2097152), ((64,), 4096)):
        states, log_w, active = estimate_case(lead, n, seed=n, device=dev)
        a = estimation.estimate_se2_log(states, log_w, active)
        b = estimation.estimate_se2_log(states, log_w, active)
        for x, y in ((a[0].xy, b[0].xy), (a[0].rot.z, b[0].rot.z), (a[1], b[1])):
            assert torch.equal(x, y)
        torch.cuda.synchronize()
        before = cuda_estimate.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            estimation.estimate_se2_log(states, log_w, active)
            torch.cuda.synchronize()
        assert cuda_estimate.launches == before + 1
        events = prof.events()
        names = [e.name for e in events]
        launched = [n for n in names if n in ("cudaLaunchKernel", "cuLaunchKernel",
                                              "cudaLaunchKernelExC")]
        assert len(launched) == 1, names
        device = [e.name for e in events if e.device_type == DeviceType.CUDA]
        assert all("estimate_kernel" in n for n in device), device
        assert not [n for n in names if n in ("aten::sum", "aten::bmm", "aten::matmul")], names


def test_e1_raises_on_what_it_does_not_take(dev):
    from beluga_tpu_torch.algorithms import estimation
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.ops import cuda_estimate

    states, log_w, active = estimate_case((8,), 1024, seed=14, device=dev)
    before = cuda_estimate.launches
    with pytest.raises(ValueError):  # float64 states
        estimation.estimate_se2_log(SE2(states.xy.double(), states.rot), log_w, active)
    with pytest.raises(ValueError):  # float64 weights
        estimation.estimate_se2(states, torch.exp(log_w).double())
    with pytest.raises(ValueError):  # every other particle: not contiguous
        estimation.estimate_se2(SE2(states.xy[:, ::2], SO2(states.rot.z[:, ::2])),
                                torch.exp(log_w)[:, ::2].contiguous())
    with pytest.raises(ValueError):  # strided weights
        estimation.estimate_se2(SE2(states.xy[:, :512], SO2(states.rot.z[:, :512])),
                                torch.exp(log_w)[:, ::2])
    with pytest.raises(ValueError):  # int64 counts
        estimation.estimate_se2_log(states, log_w, active.long())
    with pytest.raises(ValueError):  # weights on the CPU
        estimation.estimate_se2(states, torch.exp(log_w).cpu())
    assert cuda_estimate.launches == before
