"""Kernel S1 (``csrc/sort_slots.cu``, the θ sort of ``sorted_slots``
filters) on the card, against the plain version (``se2_sort_key`` and
``tree_sort_by``) on the same card tensors, at the fleet's 4096 × 4096, a
small fleet, the node's 2000 slots with and without a filter axis, and a
length that is no multiple of a thread's slots; each case with strays in
x, y and heading, runs of equal keys, a ``-0.0`` heading and dead slots
(``tests/test_torch_sort.py:sort_case``).

What is held: the key's heading within 1e-6 of the plain key's; its stray
flags equal to the float64 z-scores' wherever those lie more than 1e-4
from 3.5 (both sum in another order than float64; the kernel sums in
float64); the output bit-equal to ``tree_sort_by`` of the kernel's own
keys (the sort is stable and exact); dead slots last, in their order; two
calls the same bits; one launch a call.

Every test here needs an NVIDIA GPU and skips without one.  The module
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sort_cuda.py
"""

import pytest
import torch
from test_torch_sort import STRAY_Z, sort_case, z_scores_float64

pytestmark = pytest.mark.cuda

THETA_ATOL = 1e-6
Z_EDGE = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


CASES = {
    "fleet": ((4096,), 4096),
    "small_fleet": ((3,), 400),
    "one_filter": ((1,), 2000),
    "node": ((), 2000),
    "ragged": ((5,), 4093),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_s1_matches_the_plain_sort(dev, case):
    from beluga_tpu_torch.core.particles import tree_sort_by
    from beluga_tpu_torch.filters.amcl import se2_sort_key
    from beluga_tpu_torch.ops import cuda_sort

    lead, n = CASES[case]
    states, log_w, active = sort_case(lead, n, seed=n + len(case), device=dev)
    before = cuda_sort.launches
    got_states, got_w, keys = cuda_sort.sort_slots_se2(states, log_w, active, keys=True)
    assert cuda_sort.launches == before + 1
    live = torch.arange(n, device=dev) < active[..., None]
    plain = torch.where(live, se2_sort_key(states), torch.inf)

    # dead slots: inf keys in both; live: the heading within THETA_ATOL
    assert torch.equal(torch.isinf(keys), ~live) and torch.equal(torch.isinf(plain), ~live)
    stray = (keys > 50.0) & live
    theta = torch.where(stray, keys - 100.0, keys)[live]
    plain_theta = torch.where(plain > 50.0, plain - 100.0, plain)[live]
    assert float((theta - plain_theta).abs().max()) <= THETA_ATOL
    # the stray flags: float64's, away from the threshold
    z = z_scores_float64(states)
    want = (z > STRAY_Z).any(-1)
    clear = ((z - STRAY_Z).abs() > Z_EDGE).all(-1) & live
    assert torch.equal(stray[clear], want[clear])
    assert 0 < int(stray.sum()) < int(live.sum()) // 8

    # the kernel's permutation is the stable sort of its own keys, bit for bit
    want_states, want_w = tree_sort_by(keys, (states, log_w))
    assert torch.equal(got_states.xy, want_states.xy)
    assert torch.equal(got_states.rot.z, want_states.rot.z)
    assert torch.equal(got_w, want_w)
    # dead slots last, in their order
    dead = ~live
    assert torch.equal(got_states.xy[dead], states.xy[dead])
    assert torch.equal(got_w[dead], log_w[dead])
    # two calls, the same bits
    again = cuda_sort.sort_slots_se2(states, log_w, active, keys=True)
    for a, b in ((again[0].xy, got_states.xy), (again[0].rot.z, got_states.rot.z),
                 (again[1], got_w), (again[2], keys)):
        assert torch.equal(a, b)
    print(case, "strays", int(stray.sum()), "near the threshold", int((live & ~clear).sum()))


def test_sort_slots_takes_s1_where_it_applies(dev):
    """``filters/amcl.py:sort_slots`` on the card: the default key goes to
    S1, one launch (strided rows too, as the pooled injection's
    ``tree_scatter`` leaves them); a custom key, more than 4096 slots and
    float64 states keep the plain path, as ``plain_sort_slots`` (the
    sharded update's sort by its own mask) does."""
    from beluga_tpu_torch.core.particles import ParticleSet, tree_scatter
    from beluga_tpu_torch.filters import amcl
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.ops import cuda_sort
    from test_torch_sort import MODELS, plain_sort

    states, log_w, active = sort_case((64,), 4096, seed=21, device=dev)
    particles = ParticleSet(states, log_w, active)
    before = cuda_sort.launches
    got = amcl.sort_slots(MODELS, particles)
    direct = cuda_sort.sort_slots_se2(states, log_w, active)
    assert cuda_sort.launches == before + 2
    assert torch.equal(got.state.xy, direct[0].xy) and torch.equal(got.log_weight, direct[1])
    assert got.active is active

    target = torch.full((64, 8), 4096, dtype=torch.int64, device=dev)  # every entry dropped
    cut = tree_scatter(states, target, SE2(states.xy[:, :8] + 1.0, SO2(states.rot.z[:, :8])))
    assert not cut.xy.is_contiguous() and torch.equal(cut.xy, states.xy)
    strided = amcl.DENSE.sort_slots(MODELS, ParticleSet(cut, log_w, active))
    assert cuda_sort.launches == before + 3
    assert torch.equal(strided.state.xy, got.state.xy)
    assert torch.equal(strided.state.rot.z, got.state.rot.z)

    big = sort_case((2,), 4100, seed=23, device=dev)
    f64 = SE2(states.xy.double(), SO2(states.rot.z.double()))
    for models, p, mask in (
            (MODELS, particles, particles.mask),
            (MODELS._replace(sort_key=lambda st: st.theta), particles, None),
            (MODELS, ParticleSet(*big), None),
            (MODELS, ParticleSet(f64, log_w, active), None)):
        if mask is None:
            out = amcl.sort_slots(models, p)
        else:
            out = amcl.plain_sort_slots(models, p, mask)
        want_states, want_w = plain_sort(models, p, mask)
        assert torch.equal(out.state.xy, want_states.xy) and torch.equal(out.log_weight, want_w)
    assert cuda_sort.launches == before + 3


def test_s1_raises_on_what_it_does_not_take(dev):
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.ops import cuda_sort

    states, log_w, active = sort_case((8,), 1024, seed=24, device=dev)
    before = cuda_sort.launches
    with pytest.raises(ValueError, match="float32"):
        cuda_sort.sort_slots_se2(SE2(states.xy.double(), states.rot), log_w, active)
    with pytest.raises(ValueError, match="log-weights must be"):
        cuda_sort.sort_slots_se2(states, log_w.double(), active)
    with pytest.raises(ValueError, match="contiguous"):  # every other slot
        cuda_sort.sort_slots_se2(SE2(states.xy[:, ::2], SO2(states.rot.z[:, ::2])),
                                 log_w[:, ::2].contiguous(), active)
    with pytest.raises(ValueError, match="active must be"):
        cuda_sort.sort_slots_se2(states, log_w, active.long())
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sort.sort_slots_se2(SE2(states.xy.cpu(), SO2(states.rot.z.cpu())), log_w.cpu(),
                                 active.cpu())
    assert cuda_sort.launches == before


def test_sort_slots_raises_on_a_layout_s1_does_not_read(dev):
    """Where ``sort_slots`` takes S1 (the card, float32 SE2, the default
    key, at most 4096 slots), a layout or dtype the kernel does not read
    raises through it rather than running the plain path: an int64
    ``active``, a particle axis that is not contiguous."""
    from beluga_tpu_torch.core.particles import ParticleSet
    from beluga_tpu_torch.filters import amcl
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.ops import cuda_sort
    from test_torch_sort import MODELS

    states, log_w, active = sort_case((8,), 1024, seed=25, device=dev)
    before = cuda_sort.launches
    with pytest.raises(ValueError, match="active must be"):
        amcl.sort_slots(MODELS, ParticleSet(states, log_w, active.long()))
    with pytest.raises(ValueError, match="contiguous"):  # every other slot
        amcl.sort_slots(MODELS, ParticleSet(SE2(states.xy[:, ::2], SO2(states.rot.z[:, ::2])),
                                            log_w[:, ::2].contiguous(), active // 2))
    assert cuda_sort.launches == before
