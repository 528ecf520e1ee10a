"""Kernel B5's plain version and the port's fused windowed forward, held
against the JAX package on the CPU (``ops/pallas_fused_step.py`` in
interpret mode, ``filters/builders.py`` ``make_windowed_scan_filter``).

Tolerances, with the same normals ``z`` fed to both:
* states (x', y', cos', sin') within atol 1e-5: sin/cos of the sample
  differ in the last bits between XLA and PyTorch;
* log-likelihoods within atol 1e-5 where both score the particle;
* the miss sets are equal except for particles whose window coordinate
  lies within 1e-4 of a window or slab edge (the coordinate chain differs
  in the last bits, so validity may flip exactly there); the test counts
  them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.filters.builders import make_windowed_scan_filter as j_make_windowed
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import OCCUPIED_VALUE
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.motion.differential_drive import DifferentialDriveParams as JDDParams
from beluga_tpu.models.motion.differential_drive import diff_drive_decompose as j_decompose
from beluga_tpu.models.sensor import likelihood_field_winlut as J
from beluga_tpu.models.sensor.likelihood_field import LikelihoodFieldParams as JLFParams
from beluga_tpu.models.sensor.likelihood_field import make_likelihood_field as j_make_field
from beluga_tpu.ops import pallas_fused_step as jfs
from beluga_tpu_torch import convert
from beluga_tpu_torch.filters.builders import make_windowed_scan_filter
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import make_grid
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams
from beluga_tpu_torch.ops import cuda_fused_step as b5

torch.set_num_threads(1)

CENTER = (3.2, 3.2, 0.7)
EDGE = 1e-4


def block_map(pillars=True):
    data = np.zeros((64, 64), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[25:30, 40:45] = OCCUPIED_VALUE
    if pillars:
        data[45:48, 12:18] = OCCUPIED_VALUE
    return data


def scan():
    rng = np.random.default_rng(0)
    angles = np.linspace(-np.pi, np.pi, 24, endpoint=False)
    r = rng.uniform(0.5, 2.0, 24)
    return (np.stack([r * np.cos(angles), r * np.sin(angles)], -1).astype(np.float32),
            np.ones(24, bool))


def cloud(n, theta=CENTER[2], spread_th=0.25, seed=1, strays=0.0):
    """θ-sorted particles about CENTER; a ``strays`` share of them, spread
    over slots, take x anywhere on the map (some leave the window)."""
    rng = np.random.default_rng(seed)
    x = CENTER[0] + rng.uniform(-0.4, 0.4, n)
    far = rng.random(n) < strays
    x[far] = rng.uniform(0.0, 6.4, int(far.sum()))
    return [x.astype(np.float32), (CENTER[1] + rng.uniform(-0.4, 0.4, n)).astype(np.float32),
            np.sort(theta + rng.uniform(-spread_th, spread_th, n)).astype(np.float32)]


def reference_inputs(center_theta, k_bins, n, theta, spread_th, move, strays=0.0):
    """The reference's LUT and packed scalars for a window about
    ``(CENTER xy, center_theta)``, as fused_fn packs them, and a cloud."""
    jfield = j_make_field(JLFParams(max_laser_distance=5.0), j_make_grid(block_map(), 0.1))
    points, mask = scan()
    dth = 2.0 * np.pi / 64.0
    lut = J.build_windowed_scan_lut(jfield, jnp.asarray(points), jnp.asarray(mask),
                                    jnp.float32(CENTER[0]), jnp.float32(CENTER[1]),
                                    jnp.float32(center_theta), k_bins=k_bins, win=(32, 128),
                                    dth=dth, max_point_radius=3.6, resolution_hint=0.1)
    prev = JSE2.from_xytheta(1.0, 1.0, 0.3)
    pose = JSE2.from_xytheta(1.0 + move, 1.0 + 0.5 * move, 0.3 + move)
    (r1m, r1s), (tm, ts), (r2m, r2s) = j_decompose(JDDParams(), pose, prev)
    wf = lut.world_to_field
    center = lut.theta0 + (k_bins // 2) * dth
    scal = jfs.pack_scalars(
        r1m, r1s, tm, ts, r2m, r2s, wf, 1.0 / lut.resolution,
        -0.5 + (lut.pad_cells - lut.x0.astype(jnp.float32)),
        -0.5 + (lut.pad_cells - lut.y0.astype(jnp.float32)),
        jnp.arctan2(wf.rot.sin, wf.rot.cos) - center, 1.0 / dth, float(k_bins // 2),
        lut.miss, 1.0)
    x, y, th = cloud(n, theta, spread_th, strays=strays)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(n), (3, n), jnp.float32))
    return lut, scal, (x, y, th, z)


def near_edge(x, y, c, s, scal, k_bins, wx, wy, tile):
    """Particles whose float64 window coordinates lie within EDGE of a
    window edge, of a bin edge, or in a tile whose minimum bin lies within
    EDGE of a bin edge (its slab base may move)."""
    sc = np.asarray(scal, np.float64)
    xf = (sc[6] * x - sc[7] * y + sc[8]) * sc[10] + sc[11]
    yf = (sc[7] * x + sc[6] * y + sc[9]) * sc[10] + sc[12]
    th = np.arctan2(s, c)
    rel = np.mod(th + sc[13] + np.pi, 2 * np.pi) - np.pi
    t = rel * sc[14] + sc[15]
    frac = np.abs(t - np.round(t))
    near = ((np.abs(xf) < EDGE) | (np.abs(xf - (wx - 1)) < EDGE) | (np.abs(yf) < EDGE)
            | (np.abs(yf - (wy - 1)) < EDGE) | (frac < EDGE))
    for lo in range(0, len(t), tile):
        ok = (t[lo:lo + tile] >= 0) & (t[lo:lo + tile] < k_bins)
        if ok.any() and frac[lo:lo + tile][ok][np.argmin(t[lo:lo + tile][ok])] < EDGE:
            near[lo:lo + tile] = True
    return near


@pytest.mark.parametrize("n", [512, 500, 300])
@pytest.mark.parametrize("case", ["tracking", "padded_slab"])
def test_b5_plain_matches_interpret(n, case):
    """Same table, scalars and normals: states within 1e-5, log-likelihoods
    within 1e-5, equal miss sets away from edges.  ``padded_slab`` puts the
    padded lanes' bin (θ = 1.0 plus the motion) below the cloud's, with a
    4-bin slab: when ``N % tile != 0`` the last tile's slab starts at the
    padding and its particles score miss, as in the reference."""
    tile = 128
    if case == "tracking":
        lut, scal, inputs = reference_inputs(CENTER[2], 32, n, CENTER[2], 0.25, 0.05, 0.1)
        tblk = 12
    else:
        lut, scal, inputs = reference_inputs(1.15, 20, n, 1.35, 0.1, 0.0)
        tblk = 4
    x, y, th, z = inputs
    want = [np.asarray(v) for v in jfs.fused_propagate_winlut(
        *map(jnp.asarray, inputs), lut.values_t, scal, tile=tile, tblk=tblk, interpret=True)]
    got = [v.numpy() for v in b5.fused_propagate_winlut(
        *(torch.as_tensor(np.array(v)) for v in (x, y, th, z)),
        torch.as_tensor(np.asarray(lut.values_t, np.float32)).to(torch.bfloat16),
        torch.as_tensor(np.asarray(scal)[:b5.NUM_SCALARS]), tile=tile, tblk=tblk)]
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    miss = float(lut.miss)
    miss_got = got[4] == float(torch.log(torch.tensor(miss)))
    miss_want = want[4] == float(jnp.log(jnp.float32(miss)))
    k_bins = 32 if case == "tracking" else 20
    near = near_edge(*(w.astype(np.float64) for w in want[:4]), scal, k_bins, 32, 128, tile)
    flipped = miss_got != miss_want
    print(f"{case} n={n}: {int(flipped.sum())} miss flips, {int(near.sum())} particles "
          f"within {EDGE} of an edge, {int(miss_want.sum())} misses")
    assert not (flipped & ~near).any()
    both = ~miss_got & ~miss_want
    np.testing.assert_allclose(got[4][both], want[4][both], rtol=0, atol=1e-5)
    if case == "padded_slab":
        last = np.arange(n) >= n - n % tile if n % tile else np.zeros(n, bool)
        assert miss_want[last].all() and miss_got[last].all()
        assert not miss_want[~last].any()


def test_pack_scalars_matches_reference():
    """Host floats, host tensors and device values pack to the reference's
    first 18 floats."""
    lut, scal, _ = reference_inputs(CENTER[2], 32, 64, CENTER[2], 0.25, 0.05)
    ref = np.asarray(scal)
    wf = convert.se2(jax.device_get(lut.world_to_field))
    got = b5.pack_scalars(*(torch.tensor(v) for v in ref[:6]), wf, float(ref[10]),
                          torch.tensor(ref[11]), torch.tensor(ref[12]), torch.tensor(ref[13]),
                          float(ref[14]), float(ref[15]), torch.tensor(ref[16]), 1.0, "cpu")
    np.testing.assert_array_equal(got.numpy(), ref[:b5.NUM_SCALARS])


def test_fused_forward_matches_reference_fused_forward():
    """The port's ``fused_propagate_reweight`` against the reference's, fed
    the reference's normals, with an odometry move: the predicted center,
    the LUT, the scalars and kernel B5 together."""
    kw = dict(k_bins=20, win=(32, 128), dth=2.0 * np.pi / 64.0, max_point_radius=3.6,
              tile=128, tblk=20, coverage_threshold=0.0, exact_tail_frac=0.0, fused=True)
    jmodels, jctx = j_make_windowed(j_make_grid(block_map(), 0.1),
                                    JLFParams(max_laser_distance=5.0), **kw)
    models, ctx = make_windowed_scan_filter(make_grid(block_map(), 0.1, device="cpu"),
                                            LikelihoodFieldParams(max_laser_distance=5.0),
                                            device="cpu", **kw)
    points, mask = scan()
    x, y, th = cloud(512)
    prev, pose = (1.0, 1.0, 0.3), (1.2, 1.05, 0.42)
    key = jax.random.PRNGKey(5)
    jns, jll = jmodels.fused_propagate_reweight(
        jctx, key, JSE2.from_xytheta(*map(jnp.asarray, (x, y, th))), JSE2.from_xytheta(*pose),
        JSE2.from_xytheta(*prev), jnp.asarray(points), jnp.asarray(mask))
    z = torch.as_tensor(np.asarray(jax.random.normal(key, (3, 512), jnp.float32)))
    ns, ll = models.fused_propagate_reweight(
        ctx, z, SE2.from_xytheta(x, y, th), SE2.from_xytheta(*pose), SE2.from_xytheta(*prev),
        torch.as_tensor(points), torch.as_tensor(mask))
    np.testing.assert_allclose(ns.xy.numpy(), np.asarray(jns.xy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ns.rot.z.numpy(), np.asarray(jns.rot.z), rtol=0, atol=1e-5)
    jll = np.asarray(jll)
    assert (jll > jll.min()).mean() > 0.9  # most particles scored
    np.testing.assert_allclose(ll.numpy(), jll, rtol=0, atol=1e-5)


def test_fused_matches_unfused():
    """The port's counterpart of tests/test_winlut.py:253-286: the fused
    kernel reproduces propagate + windowed reweight from the same normals,
    log-likelihoods up to the predicted-vs-propagated window center."""
    kw = dict(k_bins=32, win=(32, 128), max_point_radius=6.5, tile=128, tblk=12,
              coverage_threshold=0.0, exact_tail_frac=0.0, device="cpu")
    grid = make_grid(block_map(pillars=False), 0.1, device="cpu")
    models_u, ctx = make_windowed_scan_filter(grid, **kw)
    models_f, _ = make_windowed_scan_filter(grid, fused=True, **kw)
    points, mask = map(torch.as_tensor, scan())
    states = SE2.from_xytheta(*cloud(512))
    pose = SE2.from_xytheta(*CENTER)
    z = torch.randn((3, 512), generator=torch.Generator().manual_seed(3))
    ns_u = models_u.propagate(ctx, z, states, pose, pose)
    ll_u = models_u.log_weight(ctx, ns_u, points, mask)
    ns_f, ll_f = models_f.fused_propagate_reweight(ctx, z, states, pose, pose, points, mask)
    np.testing.assert_allclose(ns_u.x.numpy(), ns_f.x.numpy(), atol=1e-5)
    np.testing.assert_allclose(ns_u.rot.z.numpy(), ns_f.rot.z.numpy(), atol=1e-5)
    assert float((ll_u - ll_f).abs().max()) < 1e-3


def test_fused_filter_rejects_what_the_reference_rejects():
    """Both of the reference's ValueErrors, and fused int8 tables (which
    the reference's fused kernel truncates); the unfused int8 filter builds
    (B6-int8) and an unknown table type raises."""
    grid = make_grid(block_map(), 0.1, device="cpu")
    with pytest.raises(ValueError, match="exact_tail_frac"):
        make_windowed_scan_filter(grid, fused=True, device="cpu")
    with pytest.raises(ValueError, match="DifferentialDriveParams"):
        make_windowed_scan_filter(grid, fused=True, exact_tail_frac=0.0, device="cpu",
                                  motion_params=object())
    with pytest.raises(ValueError, match="int8"):
        make_windowed_scan_filter(grid, fused=True, exact_tail_frac=0.0, table_dtype="int8",
                                  device="cpu")
    models, ctx = make_windowed_scan_filter(grid, table_dtype="int8", device="cpu")
    assert models.fused_propagate_reweight is None and "field_pad3" in ctx
    with pytest.raises(ValueError, match="table_dtype"):
        make_windowed_scan_filter(grid, table_dtype="fp8", device="cpu")
