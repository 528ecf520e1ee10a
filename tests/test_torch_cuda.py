"""Kernels B1 and B2 of the PyTorch port on the card, against their plain
versions on the same card tensors.  Every test here needs an NVIDIA GPU
and skips without one.  The module imports neither JAX nor the JAX
package, so on a machine with the card it runs without the repository's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def arena_inputs(n, dev, seed=0):
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid

    data = synthetic.tracking_arena(384, 0.05)
    xs, ys, yaws = synthetic.circle_trajectory(1)
    pts, mask = synthetic.simulate_scans(data, 0.05, xs, ys, yaws, 60)
    _, ctx = make_likelihood_field_filter(make_grid(data, 0.05, device=dev),
                                          AmclNodeConfig().likelihood_field_params(),
                                          device=dev)
    rng = np.random.default_rng(seed)
    xyt = rng.normal([xs[0], ys[0], yaws[0]], [1.0, 1.0, 0.5], (n, 3)).astype(np.float32)
    xyt[: n // 10, :2] = rng.uniform(-2, 21, (n // 10, 2))  # some off the map
    states = SE2.from_xytheta(xyt[:, 0], xyt[:, 1], xyt[:, 2], device=dev)
    tf = ctx["field"].world_to_field @ states
    codes, book = ctx["field_codes"]
    return (codes, book, tf.x.contiguous(), tf.y.contiguous(), tf.rot.cos.contiguous(),
            tf.rot.sin.contiguous(), torch.as_tensor(pts[0]).to(dev),
            torch.as_tensor(mask[0]).to(dev), ctx["field"].resolution,
            ctx["field"].unknown_prob), states


@pytest.mark.parametrize("n", [2000, 65537])
def test_b1_kernel_matches_plain_version(dev, n):
    from beluga_tpu_torch.ops import cuda_reweight as b1

    args, _ = arena_inputs(n, dev)
    before = b1.launches
    one = torch.zeros_like(args[7])
    one[int(torch.nonzero(args[7])[0])] = True  # one beam: cells must be exact
    single = (*args[:7], one, *args[8:])
    assert torch.equal(b1.fused_reweight(*single), b1.fused_reweight_reference(*single))
    got, want = b1.fused_reweight(*args), b1.fused_reweight_reference(*args)
    torch.cuda.synchronize()
    assert b1.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)  # the beam-sum order


@pytest.mark.parametrize("n,m", [(2000, 2000), (5000, 3001), (262144, 262144)])
def test_b2_kernel_matches_plain_version(dev, n, m):
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops.resample import sorted_multinomial_positions, systematic_positions

    gen = torch.Generator(device=dev).manual_seed(n)
    w = torch.rand(n, generator=gen, device=dev)
    w[n // 4 : n // 3] = 0.0
    values = torch.randn((4, n), generator=gen, device=dev)
    cdf = b2.monotone_cdf(w)
    for pos in (sorted_multinomial_positions(gen, m), systematic_positions(gen, m)):
        pos[-7:] = 1.5
        got = b2.search_take(cdf, pos, values)
        want = b2.resample_take_reference(cdf, pos, values)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not got[-7:].any()


def test_node_on_card(dev):
    """The node's entry points with their default device: a scan, the
    motion gate, global localization, the particle cloud and a map swap."""
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.ops import cuda_resample, cuda_reweight

    data = np.zeros((80, 80), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 100
    data[30:40, 30:40] = 100
    node = AmclNode(AmclNodeConfig(max_particles=300, min_particles=50, set_initial_pose=True,
                                   initial_pose_x=2.0, initial_pose_y=2.0))
    node.set_map(make_grid(data, 0.1))
    assert node._state.particles.log_weight.is_cuda
    b1, b2 = cuda_reweight.launches, cuda_resample.launches
    pts = np.random.default_rng(0).uniform(0.5, 2.0, (30, 2)).astype(np.float32)
    res = node.handle_scan((0.0, 0.0, 0.0), pts)
    assert res.valid and np.isfinite(res.pose).all()
    assert (cuda_reweight.launches, cuda_resample.launches) == (b1 + 1, b2 + 1)
    assert not node.handle_scan((0.01, 0.0, 0.0), pts).valid
    node.global_localization()
    xyt, w = node.particle_cloud()
    assert len(xyt) == 300 and xyt[:, 0].std() > 1.0 and np.isfinite(w).all()
    node.request_nomotion_update()
    assert node.handle_scan((0.01, 0.0, 0.0), pts).valid
    node.set_map(make_grid(data, 0.1))
    xyt, _ = node.particle_cloud()
    assert abs(np.mean(xyt[:, 0]) - node.last_known_estimate[0][0]) < 0.5
