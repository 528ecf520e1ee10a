"""The port's windowed scan LUT and kernel B6's plain version, held against
the JAX package on the CPU (``models/sensor/likelihood_field_winlut.py``,
``ops/pallas_winlut.py`` in interpret mode).

Tolerances:
* the padded pz³ image, the window geometry and the coverage functions
  are equal;
* the bf16 table is within one bf16 ulp of the reference's (2⁻⁷ of the
  entry's binade: bf16 keeps 8 significant bits), with an absolute floor
  of 2e-3 for entries near zero, where the sinc ringing lives: the complex
  products add in other orders in XLA and PyTorch, and an entry at a bf16
  rounding boundary may round the other way.  Most entries are bit-equal
  (the test states the share);
* B6's plain version matches ``winlut_lookup(interpret=True)`` on the same
  table and coordinates within rtol 1e-6 (the reference sums through dot
  products), with an equal miss set;
* int8 tables (B6-int8): the port's quantized table and scale are
  bit-equal to the reference's on these inputs; B6-int8's plain version on
  the reference's table is within rtol 1e-6 of ``winlut_lookup(interpret=
  True)`` with an equal miss set: the y dots are exact integers, and XLA's
  CPU backend contracts the float θ lerp into fused multiply-adds, so
  1-7% of the weights differ in the last one or two bits (measured at most
  4.8e-7 absolute on weights near 2); the unfused int8 filter's
  log-weights within 2·scale of the reference's (one quantization step per
  table read; on these inputs the tables are equal);
* against the exact per-beam model, the reference's own accuracy bounds
  (``tests/test_winlut.py:61-75``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import OCCUPIED_VALUE
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor import likelihood_field_winlut as J
from beluga_tpu.models.sensor.likelihood_field import LikelihoodFieldParams as JLFParams
from beluga_tpu.models.sensor.likelihood_field import make_likelihood_field as j_make_field
from beluga_tpu.models.sensor.likelihood_field_lut import _pad_field_cubed as j_pad_field_cubed
from beluga_tpu.ops.pallas_winlut import winlut_lookup as j_winlut_lookup
from beluga_tpu_torch import convert
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.models.sensor import likelihood_field_winlut as P
from beluga_tpu_torch.models.sensor.likelihood_field_lut import _pad_field_cubed
from beluga_tpu_torch.ops import cuda_winlut

torch.set_num_threads(1)

CENTER = (3.2, 3.2, 0.7)
GEO = dict(k_bins=32, win=64, dth=2.0 * np.pi / 128.0, max_point_radius=2.5)
# the reference's calls set its resolution_hint to the grid's resolution, as
# its builders do; the port takes the field's own
JGEO = {**GEO, "resolution_hint": 0.1}
ABS_FLOOR = 2e-3


def block_map():
    data = np.zeros((64, 64), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[25:30, 40:45] = OCCUPIED_VALUE
    data[45:48, 12:18] = OCCUPIED_VALUE
    return data


def fields(data, res, **lf):
    jfield = j_make_field(JLFParams(**lf), j_make_grid(data, res))
    return jfield, convert.field(jax.device_get(jfield))


@pytest.fixture(scope="module")
def setup():
    """The reference test's 64x64 map at 10 cm, a 24-beam scan (one beam
    masked) and both packages' LUTs around the same center."""
    jfield, field = fields(block_map(), 0.1, max_laser_distance=5.0)
    rng = np.random.default_rng(0)
    angles = np.linspace(-np.pi, np.pi, 24, endpoint=False)
    r = rng.uniform(0.5, 2.0, 24)
    points = np.stack([r * np.cos(angles), r * np.sin(angles)], -1).astype(np.float32)
    mask = np.ones(24, bool)
    mask[5] = False
    jlut = J.build_windowed_scan_lut(jfield, jnp.asarray(points), jnp.asarray(mask),
                                     *map(jnp.float32, CENTER), **JGEO)
    lut = P.build_windowed_scan_lut(field, torch.as_tensor(points), torch.as_tensor(mask),
                                    *map(torch.tensor, CENTER), **GEO)
    return dict(jfield=jfield, field=field, points=points, mask=mask, jlut=jlut, lut=lut)


def cloud(n, spread_xy=0.4, spread_th=0.25, seed=1, sort=True):
    rng = np.random.default_rng(seed)
    th = CENTER[2] + rng.uniform(-spread_th, spread_th, n)
    if sort:
        th = np.sort(th)
    xyt = [(CENTER[0] + rng.uniform(-spread_xy, spread_xy, n)).astype(np.float32),
           (CENTER[1] + rng.uniform(-spread_xy, spread_xy, n)).astype(np.float32),
           th.astype(np.float32)]
    return JSE2.from_xytheta(*map(jnp.asarray, xyt)), SE2.from_xytheta(*xyt)


@pytest.mark.parametrize("which", ["arena", "small"])
def test_padded_image_bit_equal(which):
    """``_pad_field_cubed`` and ``precompute_padded_field`` equal the
    reference's bit for bit, on the arena and on a 20x20 map smaller than
    the 64-cell window (the band grows)."""
    if which == "arena":
        data, res, lf = synthetic.tracking_arena(160, 0.05), 0.05, {}
    else:
        data = np.zeros((20, 20), np.int8)
        data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
        res, lf = 0.1, dict(max_laser_distance=5.0)
    jfield, field = fields(data, res, **lf)
    want, jpad = j_pad_field_cubed(jfield, 3.6, res)
    got, pad = _pad_field_cubed(field, 3.6, res)
    assert pad == jpad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = J.precompute_padded_field(jfield, 64, 3.6, resolution_hint=res)
    got = P.precompute_padded_field(field, 64, 3.6)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("center", [CENTER, (0.1, 6.3, -3.0), (6.3, 0.2, 3.1), (2.0, 4.5, 0.0)])
@pytest.mark.parametrize("win,k_bins", [(64, 32), ((32, 128), 20)])
def test_window_geometry_equal(setup, center, win, k_bins):
    """Origin and θ anchor equal the reference's, clamped centers included."""
    geo = {**GEO, "win": win, "k_bins": k_bins}
    want = J.window_geometry(setup["jfield"], *map(jnp.float32, center), **geo,
                             resolution_hint=JGEO["resolution_hint"])
    got = P.window_geometry(setup["field"], *map(torch.tensor, center), **geo)
    assert (int(got[0]), int(got[1]), got[3]) == (int(want[0]), int(want[1]), want[3])
    assert float(got[2]) == float(want[2])


@pytest.mark.parametrize("win,k_bins", [(64, 32), ((32, 128), 20)])
def test_build_matches_reference_table(setup, win, k_bins):
    geo = {**GEO, "win": win, "k_bins": k_bins}
    center = map(jnp.float32, CENTER)
    jlut = J.build_windowed_scan_lut(setup["jfield"], jnp.asarray(setup["points"]),
                                     jnp.asarray(setup["mask"]), *center, **geo,
                                     resolution_hint=JGEO["resolution_hint"])
    lut = P.build_windowed_scan_lut(setup["field"], torch.as_tensor(setup["points"]),
                                    torch.as_tensor(setup["mask"]),
                                    *map(torch.tensor, CENTER), **geo)
    want = np.asarray(jlut.values_t.astype(jnp.float32))
    got = lut.values_t.float().numpy()
    assert got.shape == want.shape and lut.values_t.dtype == torch.bfloat16
    diff = np.abs(got - want)
    top = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    assert (diff <= np.maximum(ulp, ABS_FLOOR)).all(), diff.max()
    share = float(np.mean(got == want))
    print(f"bit-equal share {share:.6f}, max abs diff {diff.max()}")
    assert share > 0.99
    assert (int(lut.x0), int(lut.y0), lut.pad_cells) == (int(jlut.x0), int(jlut.y0),
                                                         jlut.pad_cells)
    assert float(lut.theta0) == float(jlut.theta0)
    np.testing.assert_allclose(float(lut.miss), float(jlut.miss), rtol=1e-6)


def int8_luts(setup):
    jlut = J.build_windowed_scan_lut(setup["jfield"], jnp.asarray(setup["points"]),
                                     jnp.asarray(setup["mask"]), *map(jnp.float32, CENTER),
                                     table_dtype="int8", **JGEO)
    lut = P.build_windowed_scan_lut(setup["field"], torch.as_tensor(setup["points"]),
                                    torch.as_tensor(setup["mask"]), *map(torch.tensor, CENTER),
                                    table_dtype="int8", **GEO)
    return jlut, lut


def test_int8_tables_raise(setup):
    """An int8 table builds (``round(L / scale)``, ``scale = max(max L,
    1e-6) / 127``, likelihood_field_winlut.py:268-274); the lookup raises
    when an int8 table comes without its scale or a bf16 table with one,
    and an unknown table type raises."""
    jlut, lut = int8_luts(setup)
    assert lut.values_t.dtype == torch.int8 and lut.scale is not None
    assert float(lut.scale) == float(jlut.scale)
    np.testing.assert_array_equal(lut.values_t.numpy(), np.asarray(jlut.values_t))
    bf16 = setup["lut"]
    xi, yi, t = (v.contiguous() for v in P.windowed_coords(lut, cloud(8)[1]))
    with pytest.raises(ValueError, match="scale"):
        cuda_winlut.winlut_lookup(lut.values_t, xi, yi, t, lut.miss)
    with pytest.raises(ValueError, match="scale"):
        cuda_winlut.winlut_lookup(bf16.values_t, xi, yi, t, bf16.miss, scale=lut.scale)
    with pytest.raises(ValueError, match="table_dtype"):
        P.build_windowed_scan_lut(setup["field"], torch.as_tensor(setup["points"]),
                                  torch.as_tensor(setup["mask"]), *map(torch.tensor, CENTER),
                                  table_dtype="int4", **GEO)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("n", [512, 500])
def test_b6_int8_plain_matches_interpret(setup, sort, n):
    """B6-int8's plain version on the reference's int8 table, scale and
    coordinates, tile 128 and tblk 8, against the interpret-mode kernel."""
    jlut, _ = int8_luts(setup)
    jstates, _ = cloud(n, spread_th=0.55, sort=sort)
    xi, yi, t = J.windowed_coords(jlut, jstates)
    want = np.asarray(j_winlut_lookup(jlut.values_t, xi, yi, t, jlut.miss, base=1.0, tile=128,
                                      tblk=8, interpret=True, scale=jlut.scale))
    lut = convert.windowed_scan_lut(jax.device_get(jlut))
    assert lut.values_t.dtype == torch.int8
    got = cuda_winlut.winlut_lookup(lut.values_t, *(torch.as_tensor(np.array(v))
                                                    for v in (xi, yi, t)),
                                    lut.miss, base=1.0, tile=128, tblk=8, scale=lut.scale).numpy()
    miss = float(jlut.miss)
    np.testing.assert_array_equal(got == miss, want == miss)
    hit = want != miss
    assert 0.1 < hit.mean() < 1.0 if not sort else hit.mean() > 0.9
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    print(f"bit-equal share {np.mean(got == want):.4f}")
    # the bf16 table's weights, within a quantization step per read
    bf16 = cuda_winlut.winlut_lookup(setup["lut"].values_t, *(torch.as_tensor(np.array(v))
                                                             for v in (xi, yi, t)),
                                     setup["lut"].miss, base=1.0, tile=128, tblk=8).numpy()
    assert np.abs(got - bf16)[hit].max() < float(jlut.scale)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("n", [512, 500])
def test_b6_plain_matches_interpret(setup, sort, n):
    """On the reference's own table and coordinates, tile 128 and tblk 8:
    values within rtol 1e-6 and an equal miss set, sorted (most tiles
    covered) and unsorted (most tiles blown)."""
    jlut = setup["jlut"]
    jstates, _ = cloud(n, spread_th=0.55, sort=sort)
    xi, yi, t = J.windowed_coords(jlut, jstates)
    want = np.asarray(j_winlut_lookup(jlut.values_t, xi, yi, t, jlut.miss, base=1.0,
                                      tile=128, tblk=8, interpret=True))
    lut = convert.windowed_scan_lut(jax.device_get(jlut))
    got = cuda_winlut.winlut_lookup(lut.values_t, *(torch.as_tensor(np.array(v))
                                                    for v in (xi, yi, t)),
                                    lut.miss, base=1.0, tile=128, tblk=8).numpy()
    miss = float(jlut.miss)
    np.testing.assert_array_equal(got == miss, want == miss)
    hit = want != miss
    assert 0.1 < hit.mean() < 1.0 if not sort else hit.mean() > 0.9
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_coverage_functions_equal(setup):
    """The four coverage functions equal the reference's on a covered
    cloud, a blown unsorted one and a scattered one."""
    jfield, field, jlut, lut = setup["jfield"], setup["field"], setup["jlut"], setup["lut"]
    rng = np.random.default_rng(3)
    scattered = [rng.uniform(0.2, 6.0, 256).astype(np.float32),
                 rng.uniform(0.2, 6.0, 256).astype(np.float32),
                 rng.uniform(-np.pi, np.pi, 256).astype(np.float32)]
    clouds = [cloud(512), cloud(512, spread_th=0.55, sort=False),
              (JSE2.from_xytheta(*map(jnp.asarray, scattered)), SE2.from_xytheta(*scattered))]
    cj, ct = list(map(jnp.float32, CENTER)), list(map(torch.tensor, CENTER))
    for jst, st in clouds:
        for stride in (1, 8):
            assert float(P.windowed_coverage(lut, st, stride)) == float(
                J.windowed_coverage(jlut, jst, stride))
            assert float(P.windowed_coverage_from_center(field, st, *ct, stride=stride, **GEO)) \
                == float(J.windowed_coverage_from_center(jfield, jst, *cj, stride=stride, **JGEO))
        for tile, tblk in ((128, 8), (64, 16)):
            want = float(J.windowed_coverage_tiled_from_center(jfield, jst, *cj, tile=tile,
                                                                tblk=tblk, **JGEO))
            got = float(P.windowed_coverage_tiled_from_center(field, st, *ct, tile=tile,
                                                               tblk=tblk, **GEO))
            assert got == want
            xi, yi, t = J.windowed_coords(jlut, jst)
            want = float(J.coverage_tiled_from_coords(xi, yi, t, 32, 64, tile, tblk))
            got = float(P.coverage_tiled_from_coords(
                *(torch.as_tensor(np.asarray(v)) for v in (xi, yi, t)), 32, 64, tile, tblk))
            assert got == want


def test_accuracy_against_exact_model(setup):
    """The port's own LUT and lookup against its exact per-beam model hold
    the reference's bounds (median relative error < 8%, correlation > 0.9,
    top-decile overlap > 0.6) and score strays as miss."""
    from beluga_tpu_torch.filters.builders import make_field_codes
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.models.sensor.likelihood_field import (
        LikelihoodFieldParams,
        likelihood_field_weights_codebook,
    )

    lut, field = setup["lut"], setup["field"]
    _, states = cloud(512)
    lfp = LikelihoodFieldParams(max_laser_distance=5.0)
    codes = make_field_codes(field, lfp, make_grid(block_map(), 0.1, device="cpu"))
    exact = likelihood_field_weights_codebook(field, codes, states,
                                              torch.as_tensor(setup["points"]),
                                              torch.as_tensor(setup["mask"])).numpy()
    approx = P.windowed_scan_lut_weights(lut, states, tile=128).numpy()
    rel = np.abs(approx - exact) / np.abs(exact)
    assert np.median(rel) < 0.08, np.median(rel)
    assert np.corrcoef(exact, approx)[0, 1] > 0.9
    k = len(exact) // 10
    overlap = len(set(np.argsort(exact)[-k:]) & set(np.argsort(approx)[-k:])) / k
    assert overlap > 0.6, overlap
    strays = SE2.from_xytheta([CENTER[0], -5.0], [CENTER[1], -5.0], [CENTER[2] + np.pi, 0.7])
    np.testing.assert_allclose(P.windowed_scan_lut_weights(lut, strays).numpy(),
                               float(lut.miss), rtol=1e-6)


def test_unfused_int8_filter_scores_like_reference():
    """``make_windowed_scan_filter(table_dtype="int8")``, unfused, gate-free,
    no exact tail: its log-weights on a θ-sorted cloud against the
    reference's filter, each on its own ctx, within 2·scale of the weight
    (one quantization step per table read)."""
    from beluga_tpu.filters.builders import make_windowed_scan_filter as j_make_windowed
    from beluga_tpu.maps.occupancy import make_grid as j_grid
    from beluga_tpu_torch.filters.builders import make_windowed_scan_filter
    from beluga_tpu_torch.maps.occupancy import make_grid

    kw = dict(k_bins=32, win=64, max_point_radius=2.5, tile=128, tblk=8, coverage_threshold=0.0,
              exact_tail_frac=0.0, table_dtype="int8")
    jmodels, jctx = j_make_windowed(j_grid(block_map(), 0.1), JLFParams(max_laser_distance=5.0),
                                    **kw)
    from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams

    models, ctx = make_windowed_scan_filter(make_grid(block_map(), 0.1, device="cpu"),
                                            LikelihoodFieldParams(max_laser_distance=5.0),
                                            device="cpu", **kw)
    rng = np.random.default_rng(0)
    angles = np.linspace(-np.pi, np.pi, 24, endpoint=False)
    r = rng.uniform(0.5, 2.0, 24)
    pts = np.stack([r * np.cos(angles), r * np.sin(angles)], -1).astype(np.float32)
    mask = np.ones(24, bool)
    jst, st = cloud(512, spread_th=0.3)
    want = np.asarray(jmodels.log_weight(jctx, jst, jnp.asarray(pts), jnp.asarray(mask)))
    got = models.log_weight(ctx, st, torch.as_tensor(pts), torch.as_tensor(mask)).numpy()
    lut = P.build_windowed_scan_lut(ctx["field"], torch.as_tensor(pts), torch.as_tensor(mask),
                                    torch.mean(st.x), torch.mean(st.y),
                                    torch.atan2(torch.mean(st.rot.sin), torch.mean(st.rot.cos)),
                                    k_bins=32, win=64, max_point_radius=2.5, table_dtype="int8")
    assert lut.values_t.dtype == torch.int8
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=0, atol=2 * float(lut.scale))
    print(f"bit-equal share {np.mean(got == want):.4f}, max abs log diff "
          f"{np.abs(got - want).max():.3g}")
    assert np.isfinite(got).all() and (got > 0).all()
