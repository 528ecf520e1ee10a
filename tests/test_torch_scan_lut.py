"""The port's shared-scan correlation LUT (``models/sensor/likelihood_field_lut.py``)
and kernel B9's plain version (``ops/cuda_scan_lut.py``), held against the
JAX package on the CPU: the map and scan of ``tests/test_scan_lut.py``
(64x64 at 0.1 m, 24 beams, a 2.5 m radius).

Tolerances:
* ``pltpu.roll`` reads ``a[(i - s) mod n]``: an interpret-mode run with
  one beam at whole-cell offsets shows it, and B9's tables rely on it;
* nearest sampling: B9's plain version on the reference's own shift and
  weight tables is bit-equal to ``scan_lut_correlate(interpret=True)``;
* bilinear sampling: XLA's CPU backend contracts ``r + ax·(r' - r)`` and
  ``acc + c·u`` into fused multiply-adds, the port rounds every product and
  sum (as its kernel does).  The test shows that this is the whole
  difference: with both contractions emulated (one rounding of the exact
  ``a·b + c``) the plain version is bit-equal to the reference; without,
  it is within rtol 1e-6 (measured at most 3.9e-7, a few ulp);
* the port's own tables: the bin headings are bit-equal, ``cos`` and
  ``sin`` may differ by an ulp between XLA and PyTorch, so an offset at a
  cell edge could take the neighbouring cell; the test counts such shift
  flips (0 on these inputs) and holds the weights within 2e-6;
* the roll build and the downsampled, masked and FFT builds at the
  reference's own tolerances (``tests/test_scan_lut.py:144-270``);
* ``scan_lut_weights`` on the reference's LUT: equal bins except where a
  heading lies within 1e-5 of a bin edge (counted), values within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import OCCUPIED_VALUE
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor import likelihood_field_lut as J
from beluga_tpu.models.sensor.likelihood_field import LikelihoodFieldParams as JLFParams
from beluga_tpu.models.sensor.likelihood_field import make_likelihood_field as j_make_field
from beluga_tpu.ops.pallas_scan_lut import scan_lut_correlate as j_correlate
from beluga_tpu_torch import convert
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.models.sensor import likelihood_field_lut as P
from beluga_tpu_torch.ops import cuda_scan_lut as b9

torch.set_num_threads(1)

RADIUS, RES = 2.5, 0.1


@pytest.fixture(scope="module")
def setup():
    data = np.zeros((64, 64), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[25:30, 40:45] = OCCUPIED_VALUE
    jfield = j_make_field(JLFParams(max_laser_distance=5.0), j_make_grid(data, RES))
    rng = np.random.default_rng(0)
    angles = np.linspace(-np.pi, np.pi, 24, endpoint=False)
    r = rng.uniform(0.5, 2.0, 24)
    points = np.stack([r * np.cos(angles), r * np.sin(angles)], -1).astype(np.float32)
    mask = np.ones(24, bool)
    mask[3] = False  # a masked beam
    return dict(jfield=jfield, field=convert.field(jax.device_get(jfield)), points=points,
                mask=mask)


def t(a):
    return torch.as_tensor(np.array(a))


def reference_tables(jpadded, points, mask, resolution, n_theta, sampling):
    """The reference's per-(bin, beam) tables, its operations
    (pallas_scan_lut.py:98-126)."""
    hp, wp = jpadded.shape
    thetas = jnp.arange(n_theta, dtype=jnp.float32) * (2.0 * jnp.pi / n_theta)
    c, s = jnp.cos(thetas)[:, None], jnp.sin(thetas)[:, None]
    ox = (c * points[None, :, 0] - s * points[None, :, 1]) / resolution
    oy = (s * points[None, :, 0] + c * points[None, :, 1]) / resolution
    m = jnp.broadcast_to(mask[None, :].astype(jnp.float32), ox.shape)
    if sampling == "bilinear":
        ix, iy = jnp.floor(ox).astype(jnp.int32), jnp.floor(oy).astype(jnp.int32)
        weights = jnp.stack([m, ox - ix, oy - iy], axis=-1)
    else:
        ix, iy = jnp.round(ox).astype(jnp.int32), jnp.round(oy).astype(jnp.int32)
        weights = jnp.stack([m, jnp.zeros_like(ox), jnp.zeros_like(ox)], axis=-1)
    return jnp.stack([jnp.mod(-iy, hp), jnp.mod(-ix, wp)], axis=-1), weights


def fma(a, b, c):
    """float32 ``a·b + c`` with one rounding (exact product in float64)."""
    return (a.double() * b.double() + c.double()).float()


def bilinear_with_fma(padded, shifts, weights):
    """B9's bilinear sums with XLA's two contractions, for the test only."""
    hp, wp = padded.shape
    k, nb, _ = shifts.shape
    ys, xs = torch.arange(hp), torch.arange(wp)
    m, ax, ay = (v[..., None, None] for v in weights.unbind(-1))
    acc_u = torch.zeros((k, hp, wp))
    acc_v = torch.zeros_like(acc_u)
    for b in range(nb):
        rows = torch.remainder(ys[None, :] - shifts[:, b, 0, None], hp)[:, :, None]
        cols = torch.remainder(xs[None, :] - shifts[:, b, 1, None], wp)
        r00 = padded[rows, cols[:, None, :]]
        r01 = padded[rows, torch.remainder(cols + 1, wp)[:, None, :]]
        u = fma(ax[:, b].expand_as(r00), r01 - r00, r00)
        acc_u = fma((m[:, b] * (1.0 - ay[:, b])).expand_as(u), u, acc_u)
        acc_v = fma((m[:, b] * ay[:, b]).expand_as(u), u, acc_v)
    return acc_u + torch.roll(acc_v, -1, dims=1)


def test_pltpu_roll_reads_i_minus_shift(setup):
    """One beam at (+3, -2) cells, nearest, one bin at θ = 0: the
    reference's kernel returns F[(y - 2) mod Hp, (x + 3) mod Wp], so
    ``roll(a, s)`` reads ``a[(i - s) mod n]`` and the shift mod(-iy, Hp)
    reads row y + iy."""
    jpad, _ = J._pad_field_cubed(setup["jfield"], RADIUS, RES, align=(8, 128))
    pts = jnp.asarray([[0.3, -0.2]], jnp.float32)
    got = np.asarray(j_correlate(jpad, pts, jnp.asarray([True]), setup["jfield"].resolution, 1,
                                 sampling="nearest", interpret=True))[0]
    f = np.asarray(jpad)
    np.testing.assert_array_equal(got, np.roll(f, (2, -3), axis=(0, 1)))
    np.testing.assert_array_equal(got[10, 20], f[8, 23])
    shifts, weights = b9.scan_lut_tables(t(pts), t([True]), setup["field"].resolution, 1,
                                         *f.shape, "nearest")
    assert shifts[0, 0].tolist() == [2, f.shape[1] - 3]
    np.testing.assert_array_equal(b9.correlate(t(f), shifts, weights, "nearest")[0].numpy(), got)


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("n_theta", [8, 32])
def test_b9_plain_matches_interpret_on_reference_tables(setup, sampling, n_theta):
    jf = setup["jfield"]
    jpad, _ = J._pad_field_cubed(jf, RADIUS, RES, align=(8, 128))
    pts, mask = jnp.asarray(setup["points"]), jnp.asarray(setup["mask"])
    want = np.asarray(j_correlate(jpad, pts, mask, jf.resolution, n_theta, sampling=sampling,
                                  interpret=True))
    shifts, weights = (t(a) for a in reference_tables(jpad, pts, mask, jf.resolution, n_theta,
                                                      sampling))
    padded = t(jpad)
    got = b9.correlate(padded, shifts, weights, sampling).numpy()  # CPU: the plain version
    assert got.shape == want.shape == (n_theta, 120, 128)
    if sampling == "nearest":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(bilinear_with_fma(padded, shifts, weights).numpy(), want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    print(f"bit-equal share without FMA {np.mean(got == want):.4f}")


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("n_theta", [16, 64])
def test_port_tables_against_reference(setup, sampling, n_theta):
    """The port's own tables and build against ``build_scan_lut_pallas``:
    shift flips counted (an ulp of ``cos``/``sin`` at a cell edge), weights
    within 2e-6, the LUT within rtol 1e-5 where no shift flipped."""
    jf, field = setup["jfield"], setup["field"]
    jpad, _ = J._pad_field_cubed(jf, RADIUS, RES, align=(8, 128))
    pts, mask = setup["points"], setup["mask"]
    want_s, want_w = reference_tables(jpad, jnp.asarray(pts), jnp.asarray(mask), jf.resolution,
                                      n_theta, sampling)
    got_s, got_w = b9.scan_lut_tables(t(pts), t(mask), field.resolution, n_theta, *jpad.shape,
                                      sampling)
    assert got_s.dtype == torch.int32 and got_w.dtype == torch.float32
    flips = int((got_s.numpy() != np.asarray(want_s)).any(-1).sum())
    print(f"shift flips: {flips} of {n_theta * len(pts)}")
    assert flips == 0
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0, atol=2e-6)
    jlut = J.build_scan_lut_pallas(jf, jnp.asarray(pts), jnp.asarray(mask), n_theta=n_theta,
                                   max_point_radius=RADIUS, sampling=sampling, interpret=True)
    lut = P.build_scan_lut_pallas(field, t(pts), t(mask), n_theta=n_theta,
                                  max_point_radius=RADIUS, sampling=sampling)
    assert (lut.pad_cells, lut.n_theta, lut.resolution) == (jlut.pad_cells, jlut.n_theta,
                                                            float(jlut.resolution))
    np.testing.assert_allclose(lut.values.numpy(), np.asarray(jlut.values), rtol=1e-5, atol=1e-6)


def test_roll_build_matches_reference(setup):
    """The roll build in plain torch against the reference's XLA build
    (which contracts the four-corner sum into FMAs): rtol 1e-5, atol 1e-6,
    the reference's own tolerance between its builds."""
    jf, field = setup["jfield"], setup["field"]
    pts, mask = setup["points"], setup["mask"]
    jlut = J.build_scan_lut(jf, jnp.asarray(pts), jnp.asarray(mask), n_theta=8,
                            max_point_radius=RADIUS)
    lut = P.build_scan_lut(field, t(pts), t(mask), n_theta=8, max_point_radius=RADIUS)
    assert lut.values.shape == jlut.values.shape and lut.pad_cells == jlut.pad_cells
    np.testing.assert_allclose(lut.values.numpy(), np.asarray(jlut.values), rtol=1e-5, atol=1e-6)
    # the kernel build reproduces the roll build on the core region
    b = P.build_scan_lut_pallas(field, t(pts), t(mask), n_theta=8, max_point_radius=RADIUS)
    pad, (h, w) = lut.pad_cells, field.values.shape
    np.testing.assert_allclose(b.values[:, pad:pad + h, pad:pad + w].numpy(),
                               lut.values[:, pad:pad + h, pad:pad + w].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_masked_beams_and_default_radius(setup):
    """Every other beam masked (tests/test_scan_lut.py:217-232), and the
    footprint radius from the points when none is given."""
    field, pts = setup["field"], setup["points"]
    half = np.arange(len(pts)) % 2 == 0
    a = P.build_scan_lut(field, t(pts), t(half), n_theta=8, max_point_radius=RADIUS)
    b = P.build_scan_lut_pallas(field, t(pts), t(half), n_theta=8, max_point_radius=RADIUS)
    pad, (h, w) = a.pad_cells, field.values.shape
    np.testing.assert_allclose(b.values[:, pad:pad + h, pad:pad + w].numpy(),
                               a.values[:, pad:pad + h, pad:pad + w].numpy(),
                               rtol=1e-5, atol=1e-6)
    jlut = J.build_scan_lut(setup["jfield"], jnp.asarray(pts), jnp.asarray(half), n_theta=8)
    lut = P.build_scan_lut(field, t(pts), t(half), n_theta=8)
    assert lut.pad_cells == jlut.pad_cells
    np.testing.assert_allclose(lut.values.numpy(), np.asarray(jlut.values), rtol=1e-5, atol=1e-6)


def test_downsampled_nearest_build_matches_reference(setup):
    """The shared-scan filter's build (nearest, downsample 2) against the
    reference's: the same padded shape, pad and cell size, values within
    rtol 1e-5."""
    jf, field = setup["jfield"], setup["field"]
    pts, mask = setup["points"], setup["mask"]
    kw = dict(n_theta=8, max_point_radius=RADIUS, sampling="nearest", downsample=2)
    jlut = J.build_scan_lut_pallas(jf, jnp.asarray(pts), jnp.asarray(mask), interpret=True, **kw)
    lut = P.build_scan_lut_pallas(field, t(pts), t(mask), **kw)
    assert lut.values.shape == jlut.values.shape == (8, 64, 128)
    assert (lut.pad_cells, lut.resolution) == (jlut.pad_cells, float(jlut.resolution))
    np.testing.assert_allclose(lut.values.numpy(), np.asarray(jlut.values), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lut_build", ["roll", "pallas", "fft"])
def test_padded_field_matches_reference_and_build(setup, lut_build):
    """``scan_lut_padded`` is bit-equal to the reference's padded image for
    each build (the kernel build's downsampled and (8, 128)-aligned one with
    the reference's ``resolution_hint`` of the strided field), and a build
    handed it equals the build that pads for itself."""
    jf, field = setup["jfield"], setup["field"]
    pts, mask = t(setup["points"]), t(setup["mask"])
    down = 2 if lut_build == "pallas" else 1
    padded, pad = P.scan_lut_padded(field, RADIUS, lut_build, downsample=down)
    if lut_build == "pallas":
        import dataclasses

        jd = dataclasses.replace(jf, values=jf.values[::2, ::2], resolution=jf.resolution * 2)
        jpad, jpc = J._pad_field_cubed(jd, RADIUS, 2 * RES, align=(8, 128))
    else:
        jpad, jpc = J._pad_field_cubed(jf, RADIUS, RES)
    assert pad == jpc
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpad))
    build = {"roll": P.build_scan_lut, "pallas": P.build_scan_lut_pallas,
             "fft": P.build_scan_lut_fft}[lut_build]
    kw = dict(n_theta=8, max_point_radius=RADIUS)
    if lut_build == "pallas":
        kw.update(sampling="nearest", downsample=2)
    a = build(field, pts, mask, **kw)
    b = build(field, pts, mask, padded_cubed=(padded, pad), **kw)
    assert (a.pad_cells, a.resolution) == (b.pad_cells, b.resolution)
    assert torch.equal(a.values, b.values)


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_b9_plain_leaves_out_masked_beams(setup, sampling):
    """A beam masked in every bin adds +0 to the sums, so leaving it out (as
    the plain version and the kernel do) is bit-equal to the tables without
    it; a bin where every beam is masked is 0."""
    pts, mask = setup["points"], setup["mask"]
    shifts, weights = b9.scan_lut_tables(t(pts), t(mask), RES, 8, 120, 128, sampling)
    padded = t(np.asarray(J._pad_field_cubed(setup["jfield"], RADIUS, RES, align=(8, 128))[0]))
    got = b9.correlate(padded, shifts, weights, sampling)
    keep = np.nonzero(mask)[0]
    want = b9.correlate(padded, shifts[:, keep].contiguous(), weights[:, keep].contiguous(),
                        sampling)
    assert torch.equal(got, want)
    none = weights.clone()
    none[..., 0] = 0.0
    assert torch.equal(b9.correlate(padded, shifts, none, sampling), torch.zeros_like(got))


def test_fft_build(setup):
    """The FFT build against the roll build at the reference's tolerance
    (tests/test_scan_lut.py:257-270), and against the reference's FFT
    build within 1e-4 of the LUT's scale (another FFT library)."""
    field, pts, mask = setup["field"], setup["points"], setup["mask"]
    a = P.build_scan_lut(field, t(pts), t(mask), n_theta=32, max_point_radius=RADIUS)
    b = P.build_scan_lut_fft(field, t(pts), t(mask), n_theta=32, max_point_radius=RADIUS)
    assert a.values.shape == b.values.shape
    va, vb = a.values.numpy(), b.values.numpy()
    scale = np.abs(va).max()
    assert np.median(np.abs(va - vb)) < 0.05 * scale
    assert np.corrcoef(va.ravel(), vb.ravel())[0, 1] > 0.99
    jb = J.build_scan_lut_fft(setup["jfield"], jnp.asarray(pts), jnp.asarray(mask), n_theta=32,
                              max_point_radius=RADIUS)
    np.testing.assert_allclose(vb, np.asarray(jb.values), rtol=0, atol=1e-4 * scale)


def states_pair(x, y, th):
    x, y, th = (np.asarray(v, np.float32) for v in (x, y, th))
    return JSE2.from_xytheta(*map(jnp.asarray, (x, y, th))), SE2.from_xytheta(
        *map(torch.as_tensor, (x, y, th)))


def test_scan_lut_weights_match_reference(setup):
    """On the reference's LUT: scattered poses, θ across the ±π wrap and
    poses off the map (clipped into the pad band), against the reference's
    ``scan_lut_weights``.  XLA may divide by the constant 2π through its
    reciprocal; a heading within 1e-5 of a bin edge may then take the
    neighbouring bin (counted)."""
    jlut = J.build_scan_lut(setup["jfield"], jnp.asarray(setup["points"]),
                            jnp.asarray(setup["mask"]), n_theta=16, max_point_radius=RADIUS)
    lut = convert.scan_lut(jax.device_get(jlut))
    rng = np.random.default_rng(3)
    n = 600
    x = np.concatenate([rng.uniform(0.5, 5.9, n), [-3.0, 50.0, 3.0, 3.0]])
    y = np.concatenate([rng.uniform(0.5, 5.9, n), [-3.0, 50.0, 3.0, 3.0]])
    th = np.concatenate([rng.uniform(-4.0, 4.0, n), [0.0, 0.0, np.pi - 1e-4, -np.pi + 1e-4]])
    jst, st = states_pair(x, y, th)
    want = np.asarray(J.scan_lut_weights(jlut, jst))
    got = P.scan_lut_weights(lut, st).numpy()
    assert np.isfinite(got).all() and (got >= 1.0).all()
    tf = np.asarray((jlut.world_to_field @ jst).theta, np.float64)
    ft = np.mod(tf, 2 * np.pi) / (2 * np.pi) * 16
    edge = np.abs(ft - np.round(ft)) < 1e-5
    print(f"headings at a bin edge: {int(edge.sum())} of {len(ft)}")
    np.testing.assert_allclose(got[~edge], want[~edge], rtol=1e-5, atol=0)
    assert got[-2] == pytest.approx(got[-1], rel=0.05)  # θ wraps
    for lead in ((2, 302),):  # leading filter axes, as a fleet passes them
        _, st2 = states_pair(*(v[:604].reshape(lead) for v in (x, y, th)))
        np.testing.assert_array_equal(P.scan_lut_weights(lut, st2).numpy().reshape(-1), got)


def test_port_lut_tracks_exact_model(setup):
    """The port's own bilinear and nearest LUTs against its exact model at
    the reference's bounds (tests/test_scan_lut.py:35-64, 163-188)."""
    from beluga_tpu_torch.models.sensor.likelihood_field import likelihood_field_weights

    field, pts, mask = setup["field"], t(setup["points"]), t(np.ones(24, bool))
    rng = np.random.default_rng(1)
    n = 400
    st = SE2.from_xytheta(*(torch.as_tensor(v, dtype=torch.float32) for v in (
        rng.uniform(1.0, 5.4, n), rng.uniform(1.0, 5.4, n), rng.uniform(-np.pi, np.pi, n))))
    exact = likelihood_field_weights(field, st, pts, mask).numpy()
    for lut, med, top in ((P.build_scan_lut(field, pts, mask, n_theta=256,
                                            max_point_radius=RADIUS), 0.08, 0.6),
                          (P.build_scan_lut_pallas(field, pts, mask, n_theta=256,
                                                   max_point_radius=RADIUS,
                                                   sampling="nearest"), 0.1, 0.6)):
        approx = P.scan_lut_weights(lut, st).numpy()
        rel = np.abs(approx - exact) / np.abs(exact)
        assert np.median(rel) < med, np.median(rel)
        assert np.corrcoef(exact, approx)[0, 1] > 0.9
        k = n // 10
        overlap = len(set(np.argsort(exact)[-k:]) & set(np.argsort(approx)[-k:])) / k
        assert overlap > top, overlap


def test_correlate_rejects_bad_inputs(setup):
    padded = torch.zeros((16, 128))
    shifts, weights = b9.scan_lut_tables(t(setup["points"]), t(setup["mask"]), RES, 4, 16, 128)
    with pytest.raises(ValueError, match="sampling"):
        b9.correlate(padded, shifts, weights, "cubic")
    with pytest.raises(ValueError, match="weights"):
        b9.correlate(padded, shifts, weights[:, :5].contiguous())
    with pytest.raises(ValueError, match="shifts"):
        b9.correlate(padded, shifts.long(), weights)
    with pytest.raises(ValueError, match="padded"):
        b9.correlate(padded.double(), shifts, weights)


@pytest.mark.parametrize("n_theta", [7, 33, 128])
def test_bin_trig_matches_reference_tables(n_theta):
    """The bins' cos and sin that the plain tables and the kernel's prologue
    share (``bin_trig``, kept per K and device): the headings bit-equal to
    the reference's, cos and sin those of ``torch.cos``/``torch.sin`` and
    within one ulp of XLA's (``scan_lut_correlate``, pallas_scan_lut.py:98)."""
    thetas = jnp.arange(n_theta, dtype=jnp.float32) * (2.0 * jnp.pi / n_theta)
    trig = b9.bin_trig(n_theta, "cpu")
    assert b9.bin_trig(n_theta, torch.device("cpu")) is trig
    np.testing.assert_array_equal(b9.theta_bins(n_theta, "cpu").numpy(), np.asarray(thetas))
    th = b9.theta_bins(n_theta, "cpu")
    assert torch.equal(trig, torch.stack([torch.cos(th), torch.sin(th)], -1))
    np.testing.assert_array_max_ulp(trig[:, 0].numpy(), np.asarray(jnp.cos(thetas)), maxulp=1)
    np.testing.assert_array_max_ulp(trig[:, 1].numpy(), np.asarray(jnp.sin(thetas)), maxulp=1)
    print(f"K {n_theta}: bit-equal cos {np.mean(trig[:, 0].numpy() == np.asarray(jnp.cos(thetas)))}"
          f", sin {np.mean(trig[:, 1].numpy() == np.asarray(jnp.sin(thetas)))}")


@pytest.mark.parametrize("halo", [None, 0, 3, 40])
def test_scan_lut_correlate_any_halo_on_cpu(setup, halo):
    """On the CPU ``scan_lut_correlate`` is the plain tables and sums,
    whatever halo the caller names (a window size of the kernel only)."""
    jpad, _ = J._pad_field_cubed(setup["jfield"], RADIUS, RES, align=(8, 128))
    padded = t(jpad)
    pts, mask = t(setup["points"]), t(setup["mask"])
    want = b9.correlate_reference(padded, *b9.scan_lut_tables(pts, mask, RES, 8, *padded.shape,
                                                               "nearest"), "nearest")
    got = b9.scan_lut_correlate(padded, pts, mask, RES, 8, "nearest", halo=halo)
    assert torch.equal(got, want)
