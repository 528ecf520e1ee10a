"""The port's range LUT (``beluga_tpu_torch/models/sensor/beam_lut.py``)
and kernel B7's plain version (``ops/cuda_beam_lut.py``) held against the
JAX package on the CPU.

The reference's kernel runs as its own tests run it,
``_windowed_impl(..., interpret=True)`` (under ``jax.jit``, so that a
shape traces once: most cases share one), on the cases of
tests/test_beam_lut.py:204-515, fed the same bf16 table (the reference's
twin table carried into the port's layout by ``convert.range_lut_bf16``).
Tolerances:
* ``build_range_lut``: entry by entry, hits at the same cells; a distance
  within two ulp (``hypot``), and no entry differs otherwise;
* the gather path: rtol 2e-5 (``torch.erf``/``exp`` against XLA's, as the
  exact model, tests/test_torch_beam.py);
* B7's plain version: rtol 1e-5 (XLA's ``exp`` and the A&S erf in the
  mixture), and the window origins equal, except for particles with a beam
  whose bin coordinate ``mod(θ + β, 2π) / 2π · K`` the reference computes
  otherwise: XLA's CPU backend divides by the constant 2π through its
  float32 reciprocal (a one-ulp change in ~16% of the pairs).  Where the
  two bins of such a beam hold different ranges, the blend then moves
  ``z_mean``, and at an occlusion edge the weight by up to ~1.2e-4
  relative; those particles are held to rtol 2e-4 (ROADMAP C).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor.beam import BeamModelParams as JBeamModelParams
from beluga_tpu.models.sensor.beam_lut import beam_lut_weights as j_beam_lut_weights
from beluga_tpu.models.sensor.beam_lut import build_range_lut as j_build_range_lut
from beluga_tpu.ops.pallas_beam_lut import _windowed_impl, build_lut_bf16 as j_build_lut_bf16
from beluga_tpu_torch import convert
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, make_grid
from beluga_tpu_torch.models.sensor.beam import BeamModelParams
from beluga_tpu_torch.models.sensor.beam_lut import beam_lut_weights, build_range_lut, lut_cells
from beluga_tpu_torch.ops import cuda_beam_lut

torch.set_num_threads(1)

PARAMS = BeamModelParams(beam_max_range=4.0)
JPARAMS = JBeamModelParams(beam_max_range=4.0)
NB = 8  # beams of the cases that share one traced shape, with N = 200, K = 16
MIX = (PARAMS.z_hit, PARAMS.z_short, PARAMS.z_rand, PARAMS.z_max, PARAMS.sigma_hit,
       PARAMS.lambda_short, PARAMS.beam_max_range)


def world96():
    """tests/test_beam_lut.py:209-214."""
    data = np.zeros((96, 96), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[40:46, 60:66] = OCCUPIED_VALUE
    data[20:24, 20:30] = OCCUPIED_VALUE
    return data


# the reference's kernel in interpret mode, traced once per shape
reference_windowed = jax.jit(functools.partial(_windowed_impl, interpret=True))


@pytest.fixture(scope="module")
def luts():
    """Both packages' LUTs of the 96² world at 4 m for K = 16 and 128, and
    the reference's bf16 twin tables."""
    jgrid = j_make_grid(world96(), 0.1)
    out = {}
    for k in (16, 128):
        jlut = j_build_range_lut(jgrid, max_range=4.0, n_bearings=k)
        out[k] = (jlut, j_build_lut_bf16(jlut.ranges))
    return out


def port_tables(jlut, jtwin):
    lut = convert.range_lut(jax.device_get(jlut))
    return lut, convert.range_lut_bf16(jax.device_get(jtwin), lut.ranges.shape[1:])


def scan(nb, r, seed=None):
    ang = np.linspace(-np.pi, np.pi, nb, endpoint=False)
    if seed is not None:
        r = np.random.default_rng(seed).uniform(*r, nb)
    return np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)


def reciprocal_bins(theta, bearing, mask, table, xi, yi):
    """``bool[F, N]``: particles with an unmasked beam whose bin coordinate
    differs when the division by 2π goes through its float32 reciprocal,
    as XLA's CPU backend computes it, and whose two bins at the particle's
    cell hold different ranges (so that the blend moves)."""
    k = table.shape[-1]
    two_pi = np.float32(cuda_beam_lut.TWO_PI)
    x = np.fmod(theta[..., :, None] + bearing[..., None, :], two_pi)
    x = np.where(x < 0, x + two_pi, x).astype(np.float32)
    exact = x / two_pi * np.float32(k)
    recip = x * (np.float32(1.0) / two_pi) * np.float32(k)
    k0 = np.nan_to_num(np.floor(exact)).astype(np.int64) % k
    column = table.float().numpy()[yi, xi]  # [F, N, K]
    r0 = np.take_along_axis(column, k0, -1)
    r1 = np.take_along_axis(column, (k0 + 1) % k, -1)
    return ((exact != recip) & (r0 != r1) & mask[..., None, :]).any(-1)


def assert_b7_close(got, want, flips):
    np.testing.assert_allclose(got[~flips], want[~flips], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=0)


def port_windowed(jlut, jtwin, xs, ys, ths, pts, mask):
    """The port's B7 weights ``[F, N]`` for per-filter clouds ``[F, N]`` and
    per-filter scans ``[F, nb, 2]``."""
    return both_windowed(jlut, jtwin, xs, ys, ths, pts, mask, reference=False)[0]


def both_windowed(jlut, jtwin, xs, ys, ths, pts, mask, reference=True):
    """(port, reference, bin-flip particles) B7 weights ``[F, N]`` for
    per-filter clouds ``[F, N]`` and per-filter scans ``[F, nb, 2]``."""
    lut, twin = port_tables(jlut, jtwin)
    states = SE2.from_xytheta(xs, ys, ths)
    local, xi, yi = lut_cells(lut, states)
    px, py = torch.as_tensor(pts[..., 0]), torch.as_tensor(pts[..., 1])
    z, bearing = torch.sqrt(px * px + py * py), torch.atan2(py, px)
    got = cuda_beam_lut.beam_lut_windowed(twin, local.theta, xi, yi, z, bearing,
                                          torch.as_tensor(mask), lut.max_range, MIX)
    if not reference:
        return got.numpy(), None, None
    jmix = jnp.asarray(MIX, jnp.float32)
    want = reference_windowed(jtwin, jnp.asarray(local.theta.numpy()), jnp.asarray(xi.numpy()),
                              jnp.asarray(yi.numpy()), jnp.asarray(z.numpy()),
                              jnp.asarray(bearing.numpy()), jnp.asarray(mask), jlut.max_range,
                              jmix)
    flips = reciprocal_bins(local.theta.numpy(), bearing.numpy(), np.asarray(mask), twin,
                            xi.numpy(), yi.numpy())
    return got.numpy(), np.asarray(want), flips


def uniform_cloud(rng, n, lo, hi, f=1):
    return tuple(rng.uniform(a, b, (f, n)).astype(np.float32)
                 for a, b in ((lo, hi), (lo, hi), (-np.pi, np.pi)))


def test_build_range_lut_matches_reference(luts):
    jlut, _ = luts[16]
    lut = build_range_lut(make_grid(world96(), 0.1, device="cpu"), 4.0, n_bearings=16)
    want = np.asarray(jlut.ranges)
    got = lut.ranges.numpy()
    assert got.shape == want.shape == (16, 96, 96)
    hit, jhit = got < 4.0, want < 4.0
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    assert (lut.n_bearings, lut.max_range, lut.resolution) == (16, 4.0, float(np.float32(0.1)))
    np.testing.assert_array_equal(
        cuda_beam_lut.build_lut_bf16(lut.ranges).float().numpy(),
        convert.range_lut_bf16(jax.device_get(luts[16][1]), (96, 96)).float().numpy())


def test_gather_path_matches_reference(luts):
    jlut, jtwin = luts[128]
    lut, _ = port_tables(jlut, jtwin)
    rng = np.random.default_rng(2)
    xs, ys, ths = (v[0] for v in uniform_cloud(rng, 200, 0.8, 9.0))
    xs[:3] = [-5.0, 100.0, 4.0]  # off the map: clipped cells
    pts = scan(20, (0.4, 2.0), seed=3)
    mask = rng.uniform(size=20) > 0.2
    want = np.asarray(j_beam_lut_weights(JPARAMS, jlut, JSE2.from_xytheta(xs, ys, ths),
                                         jnp.asarray(pts), jnp.asarray(mask)))
    got = beam_lut_weights(PARAMS, lut, SE2.from_xytheta(xs, ys, ths), torch.as_tensor(pts),
                           torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=0)


def test_windowed_in_window_parity(luts):
    """tests/test_beam_lut.py:230-264: a cloud inside one window."""
    rng = np.random.default_rng(7)
    xs, ys, ths = uniform_cloud(rng, 200, 3.5, 6.0)
    pts = scan(NB, (0.4, 2.5), seed=8)[None]
    mask = (rng.uniform(size=NB) > 0.2)[None]
    got, want, flips = both_windowed(*luts[16], xs, ys, ths, pts, mask)
    assert_b7_close(got, want, flips)


def test_windowed_strays_score_all_casts_miss(luts):
    """tests/test_beam_lut.py:266-303: three strays ~74 cells from the
    cluster read max_range in every bin; the port's gather on a constant
    max-range LUT agrees with them."""
    jlut, jtwin = luts[16]
    rng = np.random.default_rng(8)
    xs, ys = np.full((1, 200), 8.0, np.float32), np.full((1, 200), 8.0, np.float32)
    xs[0, :3] = ys[0, :3] = 0.6
    ths = rng.uniform(-np.pi, np.pi, (1, 200)).astype(np.float32)
    pts = scan(NB, np.full(NB, 1.5))[None]
    mask = np.ones((1, NB), bool)
    got, want, flips = both_windowed(jlut, jtwin, xs, ys, ths, pts, mask)
    assert_b7_close(got, want, flips)
    lut, _ = port_tables(jlut, jtwin)
    miss = dataclasses.replace(lut, ranges=torch.full_like(lut.ranges, lut.max_range))
    strays = SE2.from_xytheta(xs[0, :3], ys[0, :3], ths[0, :3])
    all_miss = beam_lut_weights(PARAMS, miss, strays, torch.as_tensor(pts[0]),
                                torch.as_tensor(mask[0])).numpy()
    np.testing.assert_allclose(got[0, :3], all_miss, rtol=2e-5)
    assert np.abs(got[0, 3:] / all_miss.mean() - 1.0).min() > 1e-3


def test_windowed_fleet_folding(luts):
    """tests/test_beam_lut.py:305-336: F = 2 filters about two centres, held
    against the reference's folded call, and each filter equal to the port's
    single-filter call."""
    rng = np.random.default_rng(9)
    clouds = [tuple(rng.uniform(c - 0.5, c + 0.5, 200).astype(np.float32) for c in (cc, cc))
              for cc in (2.5, 6.5)]
    xs = np.stack([c[0] for c in clouds])
    ys = np.stack([c[1] for c in clouds])
    ths = rng.uniform(-np.pi, np.pi, (2, 200)).astype(np.float32)
    pts = np.broadcast_to(scan(NB, np.full(NB, 1.2)), (2, NB, 2)).copy()
    mask = np.ones((2, NB), bool)
    got, want, flips = both_windowed(*luts[16], xs, ys, ths, pts, mask)
    assert_b7_close(got, want, flips)
    for f in range(2):
        one = port_windowed(*luts[16], xs[f:f + 1], ys[f:f + 1], ths[f:f + 1], pts[f:f + 1],
                            mask[f:f + 1])
        np.testing.assert_array_equal(one[0], got[f])


def test_windowed_small_map_padding():
    """tests/test_beam_lut.py:338-365: a 40² map pads up to one window."""
    data = np.zeros((40, 40), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    jlut = j_build_range_lut(j_make_grid(data, 0.1), max_range=4.0, n_bearings=8)
    jtwin = j_build_lut_bf16(jlut.ranges)
    lut, twin = port_tables(jlut, jtwin)
    assert twin.shape == (128, 40, 8)
    rng = np.random.default_rng(10)
    xs, ys = rng.uniform(1.0, 3.0, (2, 1, 32)).astype(np.float32)
    got, want, flips = both_windowed(jlut, jtwin, xs, ys, np.zeros((1, 32), np.float32),
                              scan(4, np.ones(4))[None], np.ones((1, 4), bool))
    assert np.isfinite(got).all() and (got > 0).all()
    assert_b7_close(got, want, flips)


@pytest.mark.parametrize("tc", [0.3, np.pi])
def test_windowed_banded_case_and_the_seam(luts, tc):
    """tests/test_beam_lut.py:404-443: tight-θ clouds at K = 128 take the
    reference's banded stage 2; the port's full-K select gives the same
    rows, across the ±π seam too."""
    rng = np.random.default_rng(11)
    th = (np.mod(rng.normal(tc, 0.08, (1, 150)) + np.pi, 2 * np.pi) - np.pi).astype(np.float32)
    xs, ys = rng.uniform(4.0, 5.5, (2, 1, 150)).astype(np.float32)
    pts = scan(10, (0.4, 2.5), seed=12)[None]
    got, want, flips = both_windowed(*luts[128], xs, ys, th, pts, np.ones((1, 10), bool))
    assert_b7_close(got, want, flips)


def test_windowed_masked_nan_beam(luts):
    """tests/test_beam_lut.py:445-479: a masked beam with a NaN point adds
    nothing, in both packages."""
    rng = np.random.default_rng(12)
    xs, ys = rng.uniform(4.0, 5.0, (2, 1, 200)).astype(np.float32)
    ths = np.zeros((1, 200), np.float32)
    pts = scan(NB, np.full(NB, 1.5))
    pts[2] = np.nan
    mask = np.ones(NB, bool)
    mask[2] = False
    got, want, flips = both_windowed(*luts[16], xs, ys, ths, pts[None], mask[None])
    assert np.isfinite(got).all()
    assert_b7_close(got, want, flips)
    benign = pts.copy()
    benign[2] = (1.0, 0.0)
    got2 = port_windowed(*luts[16], xs, ys, ths, benign[None], mask[None])
    np.testing.assert_array_equal(got, got2)


def test_windowed_pad_lanes_after_a_stray_in_the_last_slot(luts):
    """tests/test_beam_lut.py:481-515: N = 200 and a stray in the final
    slot; the pad lanes do not recenter the window on it."""
    rng = np.random.default_rng(13)
    xs, ys = rng.uniform(4.2, 5.2, (2, 1, 200)).astype(np.float32)
    xs[0, -1] = ys[0, -1] = 0.8
    ths = rng.uniform(-np.pi, np.pi, (1, 200)).astype(np.float32)
    got, want, flips = both_windowed(*luts[16], xs, ys, ths, scan(NB, np.full(NB, 1.4))[None],
                                     np.ones((1, NB), bool))
    assert_b7_close(got, want, flips)


@pytest.mark.parametrize("n", [4000, 4096 + 3900, 9000])
def test_windowed_n_not_a_multiple_of_the_tile(luts, n):
    """Several tiles, the last one partial (its second block empty or
    partial), two clusters per filter so that the blocks' windows differ;
    origins equal the reference's statistics recomputed in numpy."""
    rng = np.random.default_rng(n)
    xs, ys, ths = uniform_cloud(rng, n, 2.0, 3.5, f=2)
    xs[:, 3840:4096] += 4.0  # the second block of the first tile sits elsewhere
    ys[1] += 3.0
    pts = scan(7, (0.3, 3.0), seed=n)
    pts = np.stack([pts, pts[::-1]])
    mask = np.ones((2, 7), bool)
    mask[1, 4] = False
    got, want, flips = both_windowed(*luts[16], xs, ys, ths, pts, mask)
    assert_b7_close(got, want, flips)
    lut, twin = port_tables(*luts[16])
    _, xi, yi = lut_cells(lut, SE2.from_xytheta(xs, ys, ths))
    hq, wq, _ = twin.shape
    origins = cuda_beam_lut.window_origins(xi, yi, hq, wq).numpy()
    for f in range(2):
        for t in range(origins.shape[1]):
            for b, (s, size) in enumerate(cuda_beam_lut.BLOCKS):
                sl = slice(t * 4096 + s, min(t * 4096 + s + size, n))
                cnt = max(sl.stop - sl.start, 0)
                cx = int(np.float32(xi[f, sl].sum()) / np.float32(max(cnt, 1))) if cnt else 0
                cy = int(np.float32(yi[f, sl].sum()) / np.float32(max(cnt, 1))) if cnt else 0
                x0 = min(max(cx - 20, 0), wq - 40)
                y0 = 64 * min(max((cy - 64 + 32) // 64, 0), (hq - 128) // 64)
                assert tuple(origins[f, t, b]) == (x0, y0)


def test_windowed_wrapper_checks_and_counts():
    lut = torch.zeros((128, 40, 8), dtype=torch.bfloat16)
    theta = torch.zeros(2, 5)
    cells = torch.zeros(2, 5, dtype=torch.int32)
    beams = torch.ones(2, 3)
    mask = torch.ones(2, 3, dtype=torch.bool)
    before = cuda_beam_lut.launches
    out = cuda_beam_lut.beam_lut_windowed(lut, theta, cells, cells, beams, beams, mask, 4.0, MIX)
    assert out.shape == (2, 5) and cuda_beam_lut.launches == before
    with pytest.raises(ValueError, match="padded"):
        cuda_beam_lut.beam_lut_windowed(lut[:100], theta, cells, cells, beams, beams, mask, 4.0,
                                        MIX)
    with pytest.raises(ValueError, match="xi"):
        cuda_beam_lut.beam_lut_windowed(lut, theta, cells.long(), cells, beams, beams, mask, 4.0,
                                        MIX)


def test_device_window_origins_checks_and_plain_version_on_cpu(luts):
    """``device_window_origins`` (B7's origins kernel) takes the plain
    ``window_origins`` on CPU tensors, counts no launch there, and refuses
    what its kernel does not take."""
    rng = np.random.default_rng(21)
    xs, ys, ths = uniform_cloud(rng, 5000, 2.0, 3.5, f=2)
    lut, twin = port_tables(*luts[16])
    _, xi, yi = lut_cells(lut, SE2.from_xytheta(xs, ys, ths))
    hq, wq, _ = twin.shape
    before = cuda_beam_lut.origins_launches
    got = cuda_beam_lut.device_window_origins(xi, yi, hq, wq)
    assert cuda_beam_lut.origins_launches == before
    assert torch.equal(got, cuda_beam_lut.window_origins(xi, yi, hq, wq))
    assert got.shape == (2, 2, 2, 2) and got.dtype == torch.int32
    with pytest.raises(ValueError, match="xi"):
        cuda_beam_lut.device_window_origins(xi.long(), yi, hq, wq)
    with pytest.raises(ValueError, match="padded"):
        cuda_beam_lut.device_window_origins(xi, yi, hq + 1, wq)
