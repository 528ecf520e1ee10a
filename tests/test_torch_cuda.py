"""Kernels B1-B8 and R1 of the PyTorch port on the card, against their
plain versions on the same card tensors, and fleet, mega and beam updates
on the card.
Every test here needs an NVIDIA GPU and skips without one.  The module
imports neither JAX nor the JAX package, so on a machine with the card it
runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

BEAMS = 60


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def arena_inputs(n, dev, seed=0, batch=None):
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid

    data = synthetic.tracking_arena(384, 0.05)
    xs, ys, yaws = synthetic.circle_trajectory(1)
    pts, mask = synthetic.simulate_scans(data, 0.05, xs, ys, yaws, BEAMS)
    _, ctx = make_likelihood_field_filter(make_grid(data, 0.05, device=dev),
                                          AmclNodeConfig().likelihood_field_params(),
                                          device=dev)
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    xyt = rng.normal([xs[0], ys[0], yaws[0]], [1.0, 1.0, 0.5], (*lead, n, 3)).astype(np.float32)
    xyt[..., : n // 10, :2] = rng.uniform(-2, 21, (*lead, n // 10, 2))  # some off the map
    states = SE2.from_xytheta(xyt[..., 0], xyt[..., 1], xyt[..., 2], device=dev)
    tf = ctx["field"].world_to_field @ states
    codes, book = ctx["field_codes"]
    points = torch.as_tensor(pts[0]).to(dev).expand(*lead, BEAMS, 2).contiguous()
    beams = torch.as_tensor(mask[0]).to(dev).expand(*lead, BEAMS).contiguous()
    return (codes, book, tf.x.contiguous(), tf.y.contiguous(), tf.rot.cos.contiguous(),
            tf.rot.sin.contiguous(), points, beams, ctx["field"].resolution,
            ctx["field"].unknown_prob), states


def one_beam(mask):
    """The mask with only its first unmasked beam on: cells must be exact."""
    one = torch.zeros_like(mask)
    one[..., int(torch.nonzero(mask.reshape(-1, mask.shape[-1])[0])[0])] = True
    return one


@pytest.mark.parametrize("n,batch", [(2000, None), (65537, None), (4096, 64), (1000, 3)])
def test_b1_kernel_matches_plain_version(dev, n, batch):
    from beluga_tpu_torch.ops import cuda_reweight as b1

    args, _ = arena_inputs(n, dev, batch=batch)
    before = b1.launches
    single = (*args[:7], one_beam(args[7]), *args[8:])
    assert torch.equal(b1.fused_reweight(*single), b1.fused_reweight_reference(*single))
    got, want = b1.fused_reweight(*args), b1.fused_reweight_reference(*args)
    torch.cuda.synchronize()
    assert b1.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)  # the beam-sum order


@pytest.mark.parametrize("n,batch", [(4096, 64), (262144, None), (777, 5)])
def test_b4_kernel_matches_plain_version(dev, n, batch):
    from beluga_tpu_torch.ops import cuda_reweight as b1

    args, _ = arena_inputs(n, dev, seed=1, batch=batch)
    v3 = b1.build_values3(args[0], args[1])
    before = b1.values3_launches, b1.launches

    def both(mask):
        kernel = b1.fused_reweight(*args[:7], mask, *args[8:], values3=v3)
        plain = b1.fused_reweight_values3_reference(v3, *args[2:7], mask, *args[8:])
        return kernel, plain

    got1, want1 = both(one_beam(args[7]))
    assert torch.equal(got1, want1)  # same cells, same bf16 entries
    got, want = both(args[7])
    torch.cuda.synchronize()
    assert (b1.values3_launches, b1.launches) == (before[0] + 2, before[1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    exact = b1.fused_reweight(*args)
    assert float(((got - exact).abs() / exact).max()) < 5e-3


@pytest.mark.parametrize("n,m,lead,d", [(2000, 2000, (), 4), (5000, 3001, (), 4),
                                        (262144, 262144, (), 4), (4096, 4096, (64,), 4),
                                        (300, 500, (2, 3), 3)])
def test_b2_kernel_matches_plain_version(dev, n, m, lead, d):
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops.resample import sorted_multinomial_positions, systematic_positions

    gen = torch.Generator(device=dev).manual_seed(n)
    w = torch.rand((*lead, n), generator=gen, device=dev)
    w[..., n // 4 : n // 3] = 0.0
    if lead:
        w[(0,) * len(lead)] *= 1e-6  # filters of very different total weight
    values = torch.randn((*lead, d, n), generator=gen, device=dev)
    cdf = b2.monotone_cdf(w)
    for pos in (sorted_multinomial_positions(gen, m, lead), systematic_positions(gen, m, lead)):
        pos[..., -7:] = 1.5
        got = b2.search_take(cdf, pos, values)
        want = b2.resample_take_reference(cdf, pos, values)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not got[..., -7:, :].any()


@pytest.mark.parametrize("lead,p,c,n", [((64,), 512, 2, 4096), ((), 4096, 2, 262144),
                                        ((3,), 100, 3, 999), ((2,), 64, 8, 1000)])
def test_b3_kernel_matches_plain_version(dev, lead, p, c, n):
    from beluga_tpu_torch.ops import cuda_pool_take as b3

    gen = torch.Generator(device=dev).manual_seed(p)
    pool = torch.randn((*lead, p, c), generator=gen, device=dev)
    idx = torch.randint(-5, p + 5, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
    before = b3.launches
    got, want = b3.pool_take(pool, idx), b3.pool_take_reference(pool, idx)
    torch.cuda.synchronize()
    assert b3.launches == before + 1
    assert torch.equal(got, want)
    assert not got[(idx < 0) | (idx >= p)].any()


def test_fleet_on_card(dev):
    """The fleet entry points with their default device: four filters in
    codebook16 mode with theta-sorted slots and pooled recovery, one
    update, launching B4, B2 and B3 once each and B1 never."""
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_fleet_state
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.ops import cuda_pool_take, cuda_resample, cuda_reweight
    from beluga_tpu_torch.parallel.fleet import make_fleet_update

    data = synthetic.tracking_arena(384, 0.05)
    xs, ys, yaws = synthetic.circle_trajectory(1)
    pts, mask = synthetic.simulate_scans(data, 0.05, xs, ys, yaws, BEAMS)
    models, ctx = make_likelihood_field_filter(make_grid(data, 0.05), lookup_mode="codebook16",
                                               recovery_candidates=256)
    params = AmclParams(max_particles=4096, min_particles=4096, sorted_slots=True)
    state = init_fleet_state(0, 4, host_pose(xs[0], ys[0], yaws[0]),
                             np.diag([0.25, 0.25, 0.068]), params)
    assert state.particles.log_weight.is_cuda and state.particles.log_weight.shape == (4, 4096)
    counts = (cuda_reweight.launches, cuda_reweight.values3_launches, cuda_resample.launches,
              cuda_pool_take.launches)
    state, est = make_fleet_update(params, models)(
        ctx, state, SE2.from_xytheta(np.full(4, xs[0]), np.full(4, ys[0]), np.full(4, yaws[0]),
                                     device="cpu"),
        torch.as_tensor(pts[0]).to(dev).expand(4, BEAMS, 2).contiguous(),
        torch.as_tensor(mask[0]).to(dev).expand(4, BEAMS).contiguous())
    assert est.valid.all() and torch.isfinite(est.pose.xy).all()
    assert (cuda_reweight.launches, cuda_reweight.values3_launches, cuda_resample.launches,
            cuda_pool_take.launches) == (counts[0], counts[1] + 1, counts[2] + 1, counts[3] + 1)


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


def window_case(dev, n, cfg, workload, stray_every=20):
    """A workload's θ-sorted cloud with strays and its window LUT, built
    on the card."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import build_windowed_scan_lut

    w = workload(1, dev, n)
    st = w.state.particles.state
    xy = st.xy.clone()
    xy[::stray_every] += 5.0
    ct = torch.atan2(torch.mean(st.rot.sin), torch.mean(st.rot.cos))
    geo = {k: cfg[k] for k in ("k_bins", "win", "dth", "max_point_radius")}
    lut = build_windowed_scan_lut(w.ctx["field"], w.points[0], w.mask[0], torch.mean(st.x),
                                  torch.mean(st.y), ct, padded_cubed=w.ctx["field_pad3"],
                                  dft=w.ctx["winlut_dft"], **geo)
    return w, SE2(xy, st.rot), lut


@pytest.mark.parametrize("n,tile,tblk", [(262144, 512, 16), (5000, 128, 8), (3000, 2048, 16)])
def test_b6_kernel_matches_plain_version(dev, n, tile, tblk):
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import windowed_coords
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    _, states, lut = window_case(dev, n, workloads.WINDOWED_FILTER, workloads.windowed)
    xi, yi, t = (v.contiguous() for v in windowed_coords(lut, states))
    before = b6.launches
    got = b6.winlut_lookup(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk)
    want = b6.winlut_lookup_reference(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk)
    torch.cuda.synchronize()
    assert b6.launches == before + 1
    assert torch.equal(got == lut.miss, want == lut.miss)
    assert 0 < int((got == lut.miss).sum()) < n
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,tile", [(2097152, 4096), (2097152 - 1000, 4096), (777, 128)])
def test_b5_kernel_matches_plain_version(dev, n, tile):
    from beluga_tpu_torch.filters.amcl import host_pose
    from beluga_tpu_torch.filters.builders import fused_step_scalars
    from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams
    from beluga_tpu_torch.ops import cuda_fused_step as b5
    from beluga_tpu_torch.tools import workloads

    w, states, lut = window_case(dev, max(n, 4096), workloads.MEGA_FILTER, workloads.mega)
    s = w.scans
    scalars = fused_step_scalars(lut, DifferentialDriveParams(), host_pose(0.3, 0.1, 0.2),
                                 host_pose(s.xs[0], s.ys[0], s.yaws[0]), dev)
    z = torch.randn((3, n), generator=torch.Generator(device=dev).manual_seed(n), device=dev)
    args = (*(v[:n].contiguous() for v in (states.x, states.y, states.theta)), z,
            lut.values_t, scalars)
    before = b5.launches
    got = b5.fused_propagate_winlut(*args, tile=tile, tblk=20)
    want = b5.fused_propagate_winlut_reference(*args, tile=tile, tblk=20)
    torch.cuda.synchronize()
    assert b5.launches == before + 1
    for g, x in zip(got[:4], want[:4]):
        torch.testing.assert_close(g, x, rtol=0, atol=1e-5)
    miss = torch.log(lut.miss)
    both = (got[4] != miss) & (want[4] != miss)
    assert int(((got[4] == miss) != (want[4] == miss)).sum()) <= n // 10000
    torch.testing.assert_close(got[4][both], want[4][both], rtol=0, atol=1e-5)


def test_mega_update_on_card(dev):
    """The fused mega filter on the card: one forced update of 65536
    particles launches B5 once and B6 never."""
    from beluga_tpu_torch.filters.amcl import host_pose, update
    from beluga_tpu_torch.ops import cuda_fused_step, cuda_winlut
    from beluga_tpu_torch.tools import workloads

    w = workloads.mega(2, dev, 65536)
    assert w.state.particles.log_weight.is_cuda
    counts = (cuda_fused_step.launches, cuda_winlut.launches)
    state, est = update(w.params, w.models, w.ctx, w.state, host_pose(w.scans.xs[0],
                        w.scans.ys[0], w.scans.yaws[0]), w.points[0], w.mask[0], sort_now=True)
    assert est.valid and torch.isfinite(est.pose.xy).all()
    assert (cuda_fused_step.launches, cuda_winlut.launches) == (counts[0] + 1, counts[1])


# -- slice 4: the beam model (R1, B8, B7) ------------------------------------------


def beam_arena(dev, n, seed, batch=None):
    """The arena's grid and first scan, and ``n`` particles about its first
    pose (``[batch, n]`` for a fleet)."""
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid

    data = synthetic.tracking_arena(384, 0.05)
    xs, ys, yaws = synthetic.circle_trajectory(1)
    pts, mask = synthetic.simulate_scans(data, 0.05, xs, ys, yaws, BEAMS)
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    xyt = rng.normal([xs[0], ys[0], yaws[0]], [0.5, 0.5, 0.3], (*lead, n, 3)).astype(np.float32)
    xyt[..., ::25, :2] += 4.0  # some far off
    states = SE2.from_xytheta(xyt[..., 0], xyt[..., 1], xyt[..., 2], device=dev)
    points = torch.as_tensor(pts[0]).to(dev)
    px, py = points[:, 0], points[:, 1]
    z = torch.sqrt(px * px + py * py)
    return (make_grid(data, 0.05, device=dev), states, points, z,
            torch.as_tensor(mask[0]).to(dev))


@pytest.mark.parametrize("variant", ["standard", "supercover"])
@pytest.mark.parametrize("max_range", [100.0, 4.0])
def test_r1_kernel_matches_plain_version(dev, variant, max_range):
    from beluga_tpu_torch.ops import raycast as r1

    grid, states, points, z, _ = beam_arena(dev, 3000, 0)
    bearing = points / torch.clamp_min(z, 1e-12)[:, None]
    c, s = states.rot.cos[:, None], states.rot.sin[:, None]
    dirs = torch.stack([c * bearing[None, :, 0] - s * bearing[None, :, 1],
                        s * bearing[None, :, 0] + c * bearing[None, :, 1]], -1)
    src = states.xy[:, None, :].expand(dirs.shape).contiguous()
    src[:7] = -1.0  # sources off the grid
    before = r1.launches
    got = r1.cast_rays(grid, src, dirs, max_range, variant=variant)
    want = r1.cast_rays_reference(grid.free_mask, src, dirs, max_range, grid.resolution,
                                  r1.num_steps(max_range, grid.resolution), variant)
    torch.cuda.synchronize()
    assert r1.launches == before + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert 0 < int(got[1].sum()) < got[1].numel()


def test_r1_range_lut_build_matches_plain_version(dev):
    from beluga_tpu_torch.models.sensor.beam_lut import build_range_lut
    from beluga_tpu_torch.ops import raycast as r1

    grid, *_ = beam_arena(dev, 1, 0)
    before = r1.launches
    lut = build_range_lut(grid, 4.0, 32)
    torch.cuda.synchronize()
    assert r1.launches == before + 1
    cpu = build_range_lut(grid.to("cpu"), 4.0, 32)
    assert torch.equal(lut.ranges.cpu(), cpu.ranges)


@pytest.mark.parametrize("n,batch,max_range", [(2000, None, 100.0), (2048, None, 60.0),
                                               (777, 3, 8.0)])
def test_b8_kernel_matches_plain_version(dev, n, batch, max_range):
    from beluga_tpu_torch.filters.builders import sphere_trace_steps
    from beluga_tpu_torch.ops import cuda_beam as b8

    grid, states, points, z, mask = beam_arena(dev, n, 1, batch)
    lead = states.x.shape[:-1]
    bearing = (points / torch.clamp_min(z, 1e-12)[:, None]).expand(*lead, BEAMS, 2).contiguous()
    ranges = z.expand(*lead, BEAMS).contiguous()
    beams = mask.expand(*lead, BEAMS).contiguous()
    pv = (max_range, 0.5, 0.05, 0.05, 0.5, 0.2, 0.1)
    args = (b8.make_distance_cells(grid.free_mask),
            *(v.contiguous() for v in (states.x, states.y, states.rot.cos, states.rot.sin)),
            bearing, ranges, beams, grid.resolution, pv)
    steps = sphere_trace_steps(max_range, grid.resolution)
    before = b8.launches
    got = b8.sphere_trace_beam_weights(*args, march_steps=steps)
    want = b8.sphere_trace_reference(*args, march_steps=steps)
    torch.cuda.synchronize()
    assert b8.launches == before + 1
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_b8_masked_nan_beam_on_card(dev):
    from beluga_tpu_torch.ops import cuda_beam as b8

    grid, states, points, z, mask = beam_arena(dev, 500, 2)
    bearing = (points / torch.clamp_min(z, 1e-12)[:, None]).contiguous()
    first = int(torch.nonzero(mask)[0])
    mask, bearing, z = mask.clone(), bearing.clone(), z.clone()
    mask[first] = False
    poses = [v.contiguous() for v in (states.x, states.y, states.rot.cos, states.rot.sin)]
    dist = b8.make_distance_cells(grid.free_mask)
    pv = (100.0, 0.5, 0.05, 0.05, 0.5, 0.2, 0.1)
    clean = b8.sphere_trace_beam_weights(dist, *poses, bearing, z, mask, 0.05, pv, 89)
    bearing[first], z[first] = float("nan"), float("nan")
    got = b8.sphere_trace_beam_weights(dist, *poses, bearing, z, mask, 0.05, pv, 89)
    assert torch.isfinite(got).all() and torch.equal(got, clean)


@pytest.mark.parametrize("batch,n,k", [(64, 4096, 128), (3, 5000, 32), (1, 777, 16)])
def test_b7_kernel_matches_plain_version(dev, batch, n, k):
    from beluga_tpu_torch.models.sensor.beam_lut import build_range_lut, lut_cells
    from beluga_tpu_torch.ops import cuda_beam_lut as b7

    grid, states, points, z, mask = beam_arena(dev, n, 3, batch)
    lut = build_range_lut(grid, 4.0, k)
    table = b7.build_lut_bf16(lut.ranges)
    local, xi, yi = lut_cells(lut, states)
    beta = torch.atan2(points[:, 1], points[:, 0])
    lead = (batch, BEAMS)
    mix = (0.5, 0.05, 0.05, 0.05, 0.2, 0.1, 4.0)
    args = (table, local.theta.contiguous(), xi, yi, z.expand(lead).contiguous(),
            beta.expand(lead).contiguous(), mask.expand(lead).contiguous(), lut.max_range, mix)
    before = b7.launches
    got, want = b7.beam_lut_windowed(*args), b7.beam_lut_windowed_reference(*args)
    torch.cuda.synchronize()
    assert b7.launches == before + 1
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["exact", "lut", "sphere_trace", "windowed"])
def test_beam_node_on_card(dev, mode):
    """The beam node with its default device in each beam_fast_path: a scan
    runs each mode's kernel."""
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.ops import cuda_beam, cuda_beam_lut, raycast

    data = np.zeros((80, 80), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 100
    data[30:40, 30:40] = 100
    node = AmclNode(AmclNodeConfig(max_particles=300, min_particles=50, set_initial_pose=True,
                                   initial_pose_x=2.0, initial_pose_y=2.0,
                                   laser_model_type="beam", laser_max_range=8.0,
                                   beam_fast_path=mode))
    node.set_map(make_grid(data, 0.1))
    assert node._state.particles.log_weight.is_cuda
    before = (raycast.launches, cuda_beam.launches, cuda_beam_lut.launches)
    pts = np.random.default_rng(0).uniform(0.5, 2.0, (30, 2)).astype(np.float32)
    res = node.handle_scan((0.0, 0.0, 0.0), pts)
    assert res.valid and np.isfinite(res.pose).all()
    after = (raycast.launches, cuda_beam.launches, cuda_beam_lut.launches)
    want = {"exact": (1, 0, 0), "lut": (0, 0, 0), "sphere_trace": (0, 1, 0),
            "windowed": (0, 0, 1)}[mode]
    assert tuple(a - b for a, b in zip(after, before)) == want
