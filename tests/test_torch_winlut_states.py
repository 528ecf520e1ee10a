"""Kernel B6's states entry and coverage entry (``ops/cuda_winlut.py``:
``winlut_lookup_states``, ``winlut_coverage_states``) through their
wrappers on CPU tensors, where they run their plain versions, held against
the JAX package (``models/sensor/likelihood_field_winlut.py``,
``ops/pallas_winlut.py`` in interpret mode) on the reference test's 64x64
map at 10 cm (``tests/test_torch_winlut.py``'s setup).

Tolerances:
* the states entry on the reference's own table and states, bf16 and int8,
  tile 128 and tblk 8, against ``winlut_lookup(interpret=True)`` at the
  reference's ``windowed_coords``: within rtol 1e-6 (the reference sums
  through dot products, and XLA may contract the composition's products
  into fused multiply-adds), with an equal miss set;
* the coverage entry equals the reference's
  ``windowed_coverage_tiled_from_center`` exactly (a count over n).
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
from beluga_tpu.ops.pallas_winlut import winlut_lookup as j_winlut_lookup
from beluga_tpu_torch import convert
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.models.sensor import likelihood_field_winlut as P
from beluga_tpu_torch.ops import cuda_winlut

torch.set_num_threads(1)

CENTER = (3.2, 3.2, 0.7)
GEO = dict(k_bins=32, win=64, dth=2.0 * np.pi / 128.0, max_point_radius=2.5)
# the reference's calls set its resolution_hint to the grid's resolution, as
# its builders do; the port takes the field's own
JGEO = {**GEO, "resolution_hint": 0.1}


@pytest.fixture(scope="module")
def setup():
    """Both packages' fields of the block map, and the reference's bf16 and
    int8 LUTs of a 24-beam scan (one beam masked) about ``CENTER``."""
    data = np.zeros((64, 64), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[25:30, 40:45] = OCCUPIED_VALUE
    data[45:48, 12:18] = OCCUPIED_VALUE
    jfield = j_make_field(JLFParams(max_laser_distance=5.0), j_make_grid(data, 0.1))
    field = convert.field(jax.device_get(jfield))
    rng = np.random.default_rng(0)
    angles = np.linspace(-np.pi, np.pi, 24, endpoint=False)
    r = rng.uniform(0.5, 2.0, 24)
    points = jnp.asarray(np.stack([r * np.cos(angles), r * np.sin(angles)], -1), jnp.float32)
    mask = np.ones(24, bool)
    mask[5] = False
    jluts = {dtype: J.build_windowed_scan_lut(jfield, points, jnp.asarray(mask),
                                              *map(jnp.float32, CENTER), table_dtype=dtype,
                                              **JGEO)
             for dtype in ("bf16", "int8")}
    return dict(jfield=jfield, field=field, jluts=jluts)


def cloud(n, spread_xy=0.4, spread_th=0.25, seed=1, sort=True):
    """A cloud about ``CENTER`` as the reference's SE2 and the port's SE2
    of the same float32 leaves (the reference's cos and sin)."""
    rng = np.random.default_rng(seed)
    th = CENTER[2] + rng.uniform(-spread_th, spread_th, n)
    if sort:
        th = np.sort(th)
    xyt = [(CENTER[0] + rng.uniform(-spread_xy, spread_xy, n)).astype(np.float32),
           (CENTER[1] + rng.uniform(-spread_xy, spread_xy, n)).astype(np.float32),
           th.astype(np.float32)]
    jst = JSE2.from_xytheta(*map(jnp.asarray, xyt))
    return jst, SE2(torch.tensor(np.array(jst.xy)), SO2(torch.tensor(np.array(jst.rot.z))))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("n", [512, 500])
def test_lookup_states_matches_interpret(setup, dtype, sort, n):
    """The states entry on the reference's table and states, tile 128 and
    tblk 8, against the interpret-mode kernel at the reference's
    coordinates: an equal miss set, values within rtol 1e-6; sorted (most
    tiles covered) and unsorted (most tiles blown)."""
    jlut = setup["jluts"][dtype]
    jstates, states = cloud(n, spread_th=0.55, sort=sort)
    xi, yi, t = J.windowed_coords(jlut, jstates)
    scale = {"scale": jlut.scale} if dtype == "int8" else {}
    want = np.asarray(j_winlut_lookup(jlut.values_t, xi, yi, t, jlut.miss, base=1.0, tile=128,
                                      tblk=8, interpret=True, **scale))
    lut = convert.windowed_scan_lut(jax.device_get(jlut))
    assert lut.values_t.dtype == (torch.int8 if dtype == "int8" else torch.bfloat16)
    got = cuda_winlut.winlut_lookup_states(lut, states, lut.miss, 1.0, tile=128, tblk=8).numpy()
    miss = float(jlut.miss)
    np.testing.assert_array_equal(got == miss, want == miss)
    hit = want != miss
    assert 0.1 < hit.mean() < 1.0 if not sort else hit.mean() > 0.9
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the model's call is the states entry, and the plain version its chain
    assert np.array_equal(P.windowed_scan_lut_weights(lut, states, tile=128, tblk=8).numpy(), got)
    plain = cuda_winlut.winlut_lookup_states_reference(lut, states, lut.miss, 1.0, 128, 8)
    assert np.array_equal(plain.numpy(), got)


def coverage_clouds():
    rng = np.random.default_rng(3)
    scattered = [rng.uniform(0.2, 6.0, 256).astype(np.float32),
                 rng.uniform(0.2, 6.0, 256).astype(np.float32),
                 rng.uniform(-np.pi, np.pi, 256).astype(np.float32)]
    jst = JSE2.from_xytheta(*map(jnp.asarray, scattered))
    return {"covered": cloud(512), "blown": cloud(512, spread_th=0.55, sort=False),
            "scattered": (jst, SE2(torch.tensor(np.array(jst.xy)),
                                   SO2(torch.tensor(np.array(jst.rot.z)))))}


@pytest.mark.parametrize("which", ["covered", "blown", "scattered"])
@pytest.mark.parametrize("tile,tblk", [(128, 8), (64, 16)])
def test_coverage_states_equals_reference(setup, which, tile, tblk):
    """The coverage entry, through its wrapper and through the model's gate,
    equals the reference's ``windowed_coverage_tiled_from_center``."""
    jst, st = coverage_clouds()[which]
    want = float(J.windowed_coverage_tiled_from_center(
        setup["jfield"], jst, *map(jnp.float32, CENTER), tile=tile, tblk=tblk, **JGEO))
    center = [torch.tensor(c) for c in CENTER]
    geo = P.field_window(setup["field"], GEO["k_bins"], GEO["win"], GEO["dth"],
                         GEO["max_point_radius"])
    got = cuda_winlut.winlut_coverage_states(geo, st, *center, tile=tile, tblk=tblk)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == want
    assert float(P.windowed_coverage_tiled_from_center(setup["field"], st, *center, tile=tile,
                                                       tblk=tblk, **GEO)) == want
    assert 0.0 < want < 1.0 if which != "covered" else want > 0.9


def test_states_wrappers_reject_bad_inputs(setup):
    lut = convert.windowed_scan_lut(jax.device_get(setup["jluts"]["bf16"]))
    int8 = convert.windowed_scan_lut(jax.device_get(setup["jluts"]["int8"]))
    _, st = cloud(64)
    cuda_winlut.winlut_lookup_states(lut, st, lut.miss)  # accepted
    xy, z = st.xy, st.rot.z
    geo = P.field_window(setup["field"], GEO["k_bins"], GEO["win"], GEO["dth"],
                         GEO["max_point_radius"])
    center = [torch.tensor(c) for c in CENTER]
    bad_states = [
        (SE2(xy.double(), SO2(z)), "states.xy must be float32"),
        (SE2(torch.zeros(64, 3), SO2(z)), r"float32\[N, 2\]"),
        (SE2(xy, SO2(z[:32])), "states.rot must be float32"),
        (SE2(xy, SO2(torch.zeros(2, 64).T)), "states.rot must be contiguous"),
        (SE2(xy, SO2(z.to("meta"))), "states.rot is on meta"),
        (SE2(xy.to("meta"), SO2(z.to("meta"))), "world_to_field.xy must be float32"),
    ]
    for states, match in bad_states:
        with pytest.raises(ValueError, match=match):
            cuda_winlut.winlut_lookup_states(lut, states, lut.miss)
        with pytest.raises(ValueError, match=match):
            cuda_winlut.winlut_coverage_states(geo, states, *center)
    with pytest.raises(ValueError, match="scale"):  # an int8 table without its scale
        cuda_winlut.winlut_lookup_states(P.WindowedScanLut(**{**vars(int8), "scale": None}), st,
                                         int8.miss)
    with pytest.raises(ValueError, match="values_t must be bfloat16 or int8"):
        cuda_winlut.winlut_lookup_states(P.WindowedScanLut(**{**vars(lut),
                                                              "values_t": lut.values_t.float()}),
                                         st, lut.miss)
    with pytest.raises(ValueError, match="lut.x0 must be one torch.int64"):
        cuda_winlut.winlut_lookup_states(P.WindowedScanLut(**{**vars(lut), "x0": lut.x0.int()}),
                                         st, lut.miss)
    with pytest.raises(ValueError, match="tile and tblk must be positive"):
        cuda_winlut.winlut_coverage_states(geo, st, *center, tile=0)
