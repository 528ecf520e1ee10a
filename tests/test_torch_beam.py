"""The port's beam model (``beluga_tpu_torch/models/sensor/beam.py``) and
kernel B8's plain version (``ops/cuda_beam.py``) held against the JAX
package on the CPU.

Tolerances:
* golden values of test_beam_model.cpp:40-81: abs 1e-5, as the
  reference's own test (tests/test_beam_and_cluster.py:258-282);
* exact weights (``beam_weights``, both Bresenham variants): rtol 2e-5;
  the ray casts agree cell for cell, and ``torch.erf``/``torch.exp`` differ
  from XLA's by an ulp or two, which ``eta_hit``'s difference of two erfs
  can raise to ~1.6e-5 relative (2 particles of 300 above 1e-5 here);
* ``make_distance_cells``: bit-equal (the port's uint8 is the reference's
  int8 + 128);
* the A&S ``_erf``: within 4 float32 ulp of 1.0 (both compute ``1 - poly ·
  exp``; the value's own ulp near 0 says nothing);
* B8's plain version against ``sphere_trace_beam_weights(interpret=True)``
  on the 96² world of tests/test_beam_lut.py:136-141: rtol 1e-5 on every
  particle, and at most 10% of them beyond 1e-6 (measured 5-6%, at most
  4.5e-6: XLA's ``exp`` and PyTorch's in the mixture and the A&S erf; the
  traces agree).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor.beam import BeamModelParams as JBeamModelParams
from beluga_tpu.models.sensor.beam import beam_sphere_trace_log_weights as j_sphere_log_weights
from beluga_tpu.models.sensor.beam import beam_weights as j_beam_weights
from beluga_tpu.ops.pallas_beam import _erf as j_erf
from beluga_tpu.ops.pallas_beam import make_distance_cells as j_make_distance_cells
from beluga_tpu.ops.pallas_beam import sphere_trace_beam_weights as j_sphere_trace
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, make_grid
from beluga_tpu_torch.models.sensor.beam import (
    BeamModelParams,
    beam_log_weights,
    beam_sphere_trace_log_weights,
    beam_weights,
)
from beluga_tpu_torch.ops import cuda_beam

torch.set_num_threads(1)

GOLDEN = BeamModelParams(z_hit=0.5, z_short=0.05, z_max=0.05, z_rand=0.5, sigma_hit=0.2,
                         lambda_short=0.1, beam_max_range=60.0)


def world96():
    """The 96² world of tests/test_beam_lut.py:136-141 at 10 cm."""
    data = np.zeros((96, 96), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[40:46, 60:66] = OCCUPIED_VALUE
    data[20:24, 20:30] = OCCUPIED_VALUE
    return data


def cloud(seed, n, lo=1.5, hi=8.0):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(a, b, n).astype(np.float32)
                 for a, b in ((lo, hi), (lo, hi), (-3.14, 3.14)))


def scan(seed, nb, masked=(3,)):
    rng = np.random.default_rng(seed)
    ang = np.linspace(-np.pi, np.pi, nb, endpoint=False)
    r = rng.uniform(0.3, 7.0, nb)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    mask = np.ones(nb, bool)
    mask[list(masked)] = False
    return pts, mask


@pytest.mark.parametrize("point,want", [
    ([1.0, 1.0], 1.0171643824743635), ([0.75, 0.75], 0.015905891701088148),
    ([2.25, 2.25], 0.0), ([60.0, 60.0], 0.00012500000000000003),
])
def test_golden_values(point, want):
    """test_beam_model.cpp:40-81 on the 5x5 grid at 0.5 m, pillar at (2, 2)."""
    data = np.zeros((5, 5), np.int8)
    data[2, 2] = OCCUPIED_VALUE
    grid = make_grid(data, 0.5, device="cpu")
    w = beam_weights(GOLDEN, grid, SE2.identity((1,)), torch.tensor([point]),
                     torch.ones(1, dtype=torch.bool))
    assert float(w[0]) == pytest.approx(want, abs=1e-5)


def test_empty_grid_weight_near_zero():
    grid = make_grid(np.zeros((5, 5), np.int8), 0.5, device="cpu")
    w = beam_weights(GOLDEN, grid, SE2.identity((1,)), torch.tensor([[1.0, 1.0]]),
                     torch.ones(1, dtype=torch.bool))
    assert float(w[0]) == pytest.approx(0.0, abs=1e-3)


@pytest.mark.parametrize("variant", ["standard", "supercover"])
@pytest.mark.parametrize("bmr", [8.0, 100.0])
def test_beam_weights_match_reference(variant, bmr):
    data = world96()
    xs, ys, ths = cloud(0, 300)
    pts, mask = scan(1, 16)
    want = np.asarray(j_beam_weights(JBeamModelParams(beam_max_range=bmr), j_make_grid(data, 0.1),
                                     JSE2.from_xytheta(xs, ys, ths), jnp.asarray(pts),
                                     jnp.asarray(mask), variant=variant))
    params = BeamModelParams(beam_max_range=bmr)
    grid = make_grid(data, 0.1, device="cpu")
    states = SE2.from_xytheta(xs, ys, ths)
    got = beam_weights(params, grid, states, torch.as_tensor(pts), torch.as_tensor(mask),
                       variant=variant)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=0)
    log_w = beam_log_weights(params, grid, states, torch.as_tensor(pts), torch.as_tensor(mask),
                             variant=variant)
    torch.testing.assert_close(log_w, torch.log(torch.clamp_min(got, 1e-30)))


def test_beam_weights_fleet_axes():
    """A fleet ``[B, N]`` with per-filter scans equals per-filter calls."""
    grid = make_grid(world96(), 0.1, device="cpu")
    params = BeamModelParams(beam_max_range=8.0)
    clouds = [cloud(s, 50) for s in (2, 3)]
    scans = [scan(s, 12) for s in (4, 5)]
    states = SE2.from_xytheta(*(np.stack([c[i] for c in clouds]) for i in range(3)))
    pts = torch.as_tensor(np.stack([s[0] for s in scans]))
    mask = torch.as_tensor(np.stack([s[1] for s in scans]))
    got = beam_weights(params, grid, states, pts, mask)
    for f in range(2):
        one = beam_weights(params, grid, SE2.from_xytheta(*clouds[f]), pts[f], mask[f])
        torch.testing.assert_close(got[f], one, rtol=0, atol=0)


def test_distance_cells_bit_equal():
    data = world96()
    data[60:70, 5:15] = -1  # unknown cells hold 0 too
    want = np.asarray(j_make_distance_cells(j_make_grid(data, 0.1).free_mask), np.int16) + 128
    got = cuda_beam.make_distance_cells(make_grid(data, 0.1, device="cpu").free_mask)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_poly_erf_within_4_ulp_of_one():
    x = np.linspace(-6.0, 6.0, 200001).astype(np.float32)
    want = np.asarray(j_erf(jnp.asarray(x)))
    got = cuda_beam.poly_erf(torch.as_tensor(x)).numpy()
    assert np.abs(got - want).max() <= 4 * np.spacing(np.float32(1.0))
    assert got[100000] == 0.0 and np.all(np.diff(got[::1000]) >= 0)


def reference_sphere_trace(data, xs, ys, ths, pts, mask, bmr, steps):
    jgrid = j_make_grid(data, 0.1)
    log_w = j_sphere_log_weights(JBeamModelParams(beam_max_range=bmr),
                                 j_make_distance_cells(jgrid.free_mask), jgrid,
                                 JSE2.from_xytheta(xs, ys, ths), jnp.asarray(pts),
                                 jnp.asarray(mask), interpret=True, march_steps=steps)
    return np.asarray(jnp.exp(log_w))


@pytest.mark.parametrize("bmr,steps", [(8.0, 20), (8.0, 89), (100.0, 89), (100.0, 6)])
def test_sphere_trace_plain_matches_pallas_interpret(bmr, steps):
    """Every particle within rtol 1e-5 of the reference's kernel, at most 10%
    beyond 1e-6, including a march budget of 6 that leaves beams
    unfinished (scored max range)."""
    data = world96()
    xs, ys, ths = cloud(6, 300)
    pts, mask = scan(7, 16)
    want = reference_sphere_trace(data, xs, ys, ths, pts, mask, bmr, steps)
    grid = make_grid(data, 0.1, device="cpu")
    got = torch.exp(beam_sphere_trace_log_weights(
        BeamModelParams(beam_max_range=bmr), cuda_beam.make_distance_cells(grid.free_mask), grid,
        SE2.from_xytheta(xs, ys, ths), torch.as_tensor(pts), torch.as_tensor(mask),
        march_steps=steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert (np.abs(got - want) > 1e-6 * np.abs(want)).mean() <= 0.1


def test_sphere_trace_on_its_own_inputs_and_fleet_axes():
    """The kernel function's own arguments (grid-local poses, unit bearings,
    the reference's parameter order) against ``sphere_trace_beam_weights
    (interpret=True)``, and a fleet of 2 equal to per-filter calls."""
    data = world96()
    grid = make_grid(data, 0.1, device="cpu")
    dist = cuda_beam.make_distance_cells(grid.free_mask)
    jdist = j_make_distance_cells(j_make_grid(data, 0.1).free_mask)
    pv = (8.0, 0.6, 0.1, 0.05, 0.25, 0.3, 0.2)
    rng = np.random.default_rng(8)
    tx, ty = rng.uniform(0.5, 9.0, (2, 2, 120)).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, (2, 120))
    cos, sin = np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (2, 10))
    bearings = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    ranges = rng.uniform(0.2, 9.0, (2, 10)).astype(np.float32)
    mask = rng.uniform(size=(2, 10)) > 0.2
    t = torch.as_tensor
    got = cuda_beam.sphere_trace_beam_weights(dist, t(tx), t(ty), t(cos), t(sin), t(bearings),
                                              t(ranges), t(mask), 0.1, pv, march_steps=30)
    for f in range(2):
        want = np.asarray(j_sphere_trace(jdist, tx[f], ty[f], cos[f], sin[f], bearings[f],
                                         ranges[f], mask[f], jnp.float32(0.1),
                                         jnp.asarray(pv, jnp.float32), interpret=True,
                                         march_steps=30))
        np.testing.assert_allclose(got[f].numpy(), want, rtol=1e-5, atol=0)
        one = cuda_beam.sphere_trace_beam_weights(dist, t(tx[f]), t(ty[f]), t(cos[f]),
                                                  t(sin[f]), t(bearings[f]), t(ranges[f]),
                                                  t(mask[f]), 0.1, pv, march_steps=30)
        torch.testing.assert_close(got[f], one, rtol=0, atol=0)


def test_masked_nan_beam_leaves_the_weight_finite():
    """A masked beam that carries a NaN point (the usual invalid-return
    encoding) adds nothing in the port's B8; the reference adds ``mask ·
    pz³`` (pallas_beam.py:177) and its weight turns NaN (ROADMAP C)."""
    data = world96()
    xs, ys, ths = cloud(9, 64)
    pts, mask = scan(10, 12, masked=(2,))
    nan_pts = pts.copy()
    nan_pts[2] = np.nan
    grid = make_grid(data, 0.1, device="cpu")
    dist = cuda_beam.make_distance_cells(grid.free_mask)
    params = BeamModelParams(beam_max_range=8.0)

    def port(p):
        return beam_sphere_trace_log_weights(params, dist, grid, SE2.from_xytheta(xs, ys, ths),
                                             torch.as_tensor(p), torch.as_tensor(mask),
                                             march_steps=30)

    got = port(nan_pts)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, port(pts), rtol=0, atol=0)
    ref = reference_sphere_trace(data, xs, ys, ths, nan_pts, mask, 8.0, 30)
    assert np.isnan(ref).all()  # the reference's fault, left out of the parity tests


def test_sphere_trace_wrapper_checks_its_inputs():
    grid = make_grid(world96(), 0.1, device="cpu")
    dist = cuda_beam.make_distance_cells(grid.free_mask)
    v = torch.zeros(8)
    args = (v, v, v + 1, v, torch.zeros(3, 2), torch.zeros(3), torch.ones(3, dtype=torch.bool))
    pv = (8.0, 0.5, 0.5, 0.05, 0.05, 0.2, 0.1)
    before = cuda_beam.launches
    assert cuda_beam.sphere_trace_beam_weights(dist, *args, 0.1, pv).shape == (8,)
    assert cuda_beam.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match="uint8"):
        cuda_beam.sphere_trace_beam_weights(dist.to(torch.int8), *args, 0.1, pv)
    with pytest.raises(ValueError, match="bearings"):
        cuda_beam.sphere_trace_beam_weights(dist, *args[:4], torch.zeros(4, 2), *args[5:], 0.1, pv)
