"""Maps, distance transform, likelihood field, code table and kernel B1
of the PyTorch port, held against the JAX package on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX side runs as its own tests run it (the Pallas reweight kernel in
interpret mode).  Tolerances:

* grid masks, free cells, the EDT and the code table: exact;
* field values: at most 3 ulp.  XLA's CPU ``exp`` is off by up to 29 ulp
  where the Gaussian is small (PyTorch's by at most 1), and XLA fuses
  ``amplitude * exp + offset`` into one FMA; the field keeps up to 3 ulp
  of that.  The field-frame transform ``origin.inverse()`` differs by
  1 ulp for the same reason (an FMA in ``-R^T t``);
* weights of kernel B1's plain version: atol 2e-5, the beam sum's order
  (as tests/test_gather2d.py); every cell index is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.filters.builders import _make_field_codes
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.codebook import likelihood_field_codebook as j_codebook
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor.likelihood_field import (
    LikelihoodFieldParams as JLFParams,
)
from beluga_tpu.models.sensor.likelihood_field import (
    likelihood_field_weights_codebook as j_weights_codebook,
)
from beluga_tpu.models.sensor.likelihood_field import make_likelihood_field as j_make_field
from beluga_tpu.ops.distance_transform import squared_distance_transform as j_edt
from beluga_tpu.ops.pallas_reweight import fused_reweight as j_fused_reweight
from beluga_tpu_torch import convert
from beluga_tpu_torch.filters.builders import make_field_codes
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.codebook import likelihood_field_codebook
from beluga_tpu_torch.maps.occupancy import (
    OCCUPIED_VALUE,
    UNKNOWN_VALUE,
    make_grid,
)
from beluga_tpu_torch.models.sensor.likelihood_field import (
    LikelihoodFieldParams,
    likelihood_field_weights_codebook,
    make_likelihood_field,
)
from beluga_tpu_torch.ops.cuda_reweight import (
    endpoint_cells,
    fused_reweight,
    fused_reweight_reference,
)
from beluga_tpu_torch.ops.distance_transform import squared_distance_transform
from beluga_tpu_torch.ops.gather2d import build_device_codebook, encode_table

torch.set_num_threads(1)

CPU = "cpu"


def random_map(h, w, seed, unknown=True):
    """Walled map with random obstacle blocks and (optionally) unknown cells."""
    rng = np.random.default_rng(seed)
    data = np.zeros((h, w), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    for _ in range(max(h * w // 400, 2)):
        r, c = rng.integers(0, h - 3), rng.integers(0, w - 3)
        data[r : r + rng.integers(1, 4), c : c + rng.integers(1, 4)] = OCCUPIED_VALUE
    if unknown:
        data[rng.random((h, w)) < 0.05] = UNKNOWN_VALUE
    return data


MAPS = [  # (h, w, resolution, origin)
    (40, 40, 0.1, None),
    (75, 53, 0.1, (0.3, -0.7, 0.0)),  # odd dims, translated
    (33, 61, 0.05, (-1.0, 2.0, 0.6)),  # rotated
]


@pytest.mark.parametrize("h,w,res,origin", MAPS)
def test_grid_masks_and_free_cells(h, w, res, origin):
    data = random_map(h, w, seed=h * w)
    ref = jax.device_get(j_make_grid(data, res, origin))
    got = make_grid(data, res, origin, device=CPU)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    for name in ("free_mask", "obstacle_mask", "unknown_mask"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )
    np.testing.assert_array_equal(
        got.obstacle_edge_mask().numpy(), np.asarray(ref.obstacle_edge_mask())
    )
    assert got.num_free == int(ref.num_free)
    np.testing.assert_array_equal(got.free_xy.numpy(), np.asarray(ref.free_xy))
    np.testing.assert_array_equal(got.origin.xy.numpy(), np.asarray(ref.origin.xy))
    np.testing.assert_array_equal(got.origin.rot.z.numpy(), np.asarray(ref.origin.rot.z))
    assert got.resolution == float(np.float32(res))


def test_grid_cell_math():
    data = random_map(20, 30, seed=5)
    ref = j_make_grid(data, 0.5)
    got = make_grid(data, 0.5, device=CPU)
    pts = np.random.default_rng(0).uniform(-3, 18, (200, 2)).astype(np.float32)
    cells = got.cell_near(torch.as_tensor(pts))
    np.testing.assert_array_equal(cells.numpy(), np.asarray(ref.cell_near(jnp.asarray(pts))))
    np.testing.assert_array_equal(
        got.value_at(cells).numpy(), np.asarray(ref.value_at(jnp.asarray(cells.numpy())))
    )
    np.testing.assert_array_equal(
        got.free_at(cells).numpy(), np.asarray(ref.free_at(jnp.asarray(cells.numpy())))
    )
    np.testing.assert_array_equal(
        got.coordinates_at(cells).numpy(),
        np.asarray(ref.coordinates_at(jnp.asarray(cells.numpy()))),
    )


@pytest.mark.parametrize("h,w,res,max_d", [(40, 40, 0.1, 2.0), (75, 53, 0.05, 100.0),
                                           (17, 90, 0.2, 0.5)])
def test_edt_exact(h, w, res, max_d):
    rng = np.random.default_rng(h + w)
    obs = rng.random((h, w)) < 0.03
    want = np.asarray(j_edt(jnp.asarray(obs), jnp.float32(res), max_d))
    got = squared_distance_transform(torch.as_tensor(obs), float(np.float32(res)), max_d)
    np.testing.assert_array_equal(got.numpy(), want)


LF_VARIANTS = [
    dict(),
    dict(max_obstacle_distance=2.0, max_laser_distance=100.0),  # nav2 defaults
    dict(max_obstacle_distance=2.0, max_laser_distance=20.0, model_unknown_space=True),
    dict(max_obstacle_distance=1.0, max_laser_distance=3.5, model_unknown_space=True,
         only_obstacle_boundaries=True),
]


def field_pair(kw, h=48, w=37, res=0.1, origin=(0.2, -0.4, 0.3), seed=9):
    data = random_map(h, w, seed)
    jgrid = j_make_grid(data, res, origin)
    jparams = JLFParams(**kw)
    jfield = j_make_field(jparams, jgrid)
    grid = make_grid(data, res, origin, device=CPU)
    field = make_likelihood_field(LikelihoodFieldParams(**kw), grid)
    return jgrid, jparams, jfield, grid, field


@pytest.mark.parametrize("kw", LF_VARIANTS)
def test_field_values_within_3ulp(kw):
    _, _, jfield, _, field = field_pair(kw)
    np.testing.assert_array_max_ulp(field.values.numpy(), np.asarray(jfield.values), maxulp=3)
    assert field.resolution == float(np.asarray(jfield.resolution))
    assert field.unknown_prob == float(np.asarray(jfield.unknown_prob))
    np.testing.assert_array_max_ulp(field.world_to_field.xy.numpy(),
                                    np.asarray(jfield.world_to_field.xy), maxulp=1)
    np.testing.assert_array_equal(field.world_to_field.rot.z.numpy(),
                                  np.asarray(jfield.world_to_field.rot.z))


@pytest.mark.parametrize("kw", LF_VARIANTS)
def test_codebook_and_codes_exact(kw):
    """Built from the same values, the codebook and the codes are equal;
    the analytic host codebook (the > 256-values fallback) is too."""
    jgrid, jparams, jfield, grid, _ = field_pair(kw)
    jcodes, jbook = _make_field_codes(jfield, jparams, jgrid)
    values = torch.as_tensor(np.asarray(jfield.values))
    fallback = torch.as_tensor(likelihood_field_codebook(LikelihoodFieldParams(**kw), 0.1))
    np.testing.assert_array_equal(fallback.numpy(), j_codebook(jparams, 0.1))
    book = build_device_codebook(values, fallback)
    np.testing.assert_array_equal(book.numpy(), np.asarray(jbook))
    codes = encode_table(values, book)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy().astype(np.int32), np.asarray(jcodes))
    # decoding is exact: every cell reads its field value back
    np.testing.assert_array_equal(book[codes.long()].numpy(), np.asarray(jfield.values))


def test_codebook_falls_back_beyond_capacity():
    table = torch.arange(300, dtype=torch.float32).reshape(15, 20)
    fallback = torch.linspace(0, 1, 256)
    assert torch.equal(build_device_codebook(table, fallback), fallback)


# -- golden weights (docs/parity.md:11, test_likelihood_field_model.cpp) -----

GOLDEN = LikelihoodFieldParams(max_obstacle_distance=2.0, max_laser_distance=20.0,
                               z_hit=0.5, z_random=0.5, sigma_hit=0.2)


def grid_5x5(resolution=0.5, origin=None):
    data = np.zeros((5, 5), np.int8)
    data[2, 2] = OCCUPIED_VALUE
    return make_grid(data, resolution, origin, device=CPU)


def golden_weight(grid, points, pose=(0.0, 0.0, 0.0)):
    """One particle's weight through the code table (kernel B1's path)."""
    field = make_likelihood_field(GOLDEN, grid)
    pts = torch.as_tensor(np.asarray(points, np.float32))
    mask = torch.ones(len(points), dtype=torch.bool)
    states = SE2.from_xytheta(*(torch.tensor([v], dtype=torch.float32) for v in pose))
    codes_book = make_field_codes(field, GOLDEN, grid)
    return float(likelihood_field_weights_codebook(field, codes_book, states, pts, mask)[0])


@pytest.mark.parametrize("points,pose,want,tol", [
    ([[1.25, 1.25]], (0.0, 0.0, 0.0), 2.068, 0.003),  # at the obstacle
    ([[2.25, 2.25]], (0.0, 0.0, 0.0), 1.000, 0.003),  # far
    ([[-50.0, 50.0]], (0.0, 0.0, 0.0), 1.000, 0.003),  # outside the map
    ([[1.20, 1.20], [1.25, 1.25], [1.30, 1.30]], (0.0, 0.0, 0.0), 4.205, 0.01),
    ([[0.0, 0.0]], (1.25, 1.25, 0.0), 2.068, 0.003),  # translated state
])
def test_golden_weights(points, pose, want, tol):
    assert golden_weight(grid_5x5(), points, pose) == pytest.approx(want, abs=tol)


@pytest.mark.parametrize("origin,points,pose", [
    ((-5.0, -5.0, 0.0), [[4.5, 4.5]], (0.0, 0.0, 0.0)),  # offset grid
    ((-5.0, -5.0, 0.0), [[9.5, 9.5]], (-5.0, -5.0, 0.0)),
    ((0.0, 0.0, np.pi / 2), [[-9.5, 9.5]], (0.0, 0.0, 0.0)),  # rotated grid
])
def test_golden_weights_offset_and_rotated_grid(origin, points, pose):
    data = np.zeros((5, 5), np.int8)
    data[4, 4] = OCCUPIED_VALUE
    grid = make_grid(data, 2.0, origin, device=CPU)
    assert golden_weight(grid, points, pose) == pytest.approx(2.068, abs=0.003)


# -- kernel B1's plain version against the Pallas kernel ---------------------


def reweight_case(h, w, res, n, b, seed):
    """Both packages' inputs for one reweight: N not a multiple of 128,
    masked beams, particles off the map, the JAX field and code table
    carried across with convert.py."""
    data = random_map(h, w, seed, unknown=False)
    jgrid = j_make_grid(data, res)
    jparams = JLFParams()
    jfield = j_make_field(jparams, jgrid)
    jcodes, jbook = _make_field_codes(jfield, jparams, jgrid)
    rng = np.random.default_rng(seed)
    span_x, span_y = w * res, h * res
    xs = rng.uniform(-0.2 * span_x, 1.2 * span_x, n).astype(np.float32)
    ys = rng.uniform(-0.2 * span_y, 1.2 * span_y, n).astype(np.float32)
    th = rng.uniform(-3.2, 3.2, n).astype(np.float32)
    pts = rng.uniform(-3, 3, (b, 2)).astype(np.float32)
    mask = rng.random(b) < 0.8
    jstates = JSE2.from_xytheta(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(th))
    jtf = jfield.world_to_field @ jstates
    field = convert.field(jax.device_get(jfield))
    codes, book = convert.field_codes(jax.device_get((jcodes, jbook)))
    tf = [torch.as_tensor(np.asarray(v)) for v in (jtf.x, jtf.y, jtf.rot.cos, jtf.rot.sin)]
    return dict(jfield=jfield, jcb=(jcodes, jbook), jstates=jstates, jtf=jtf,
                jpts=jnp.asarray(pts), jmask=jnp.asarray(mask), field=field,
                codes=codes, book=book, tf=tf, pts=torch.as_tensor(pts),
                mask=torch.as_tensor(mask), xs=xs, ys=ys, th=th)


REWEIGHT_CASES = [(40, 40, 0.1, 130, 17, 11), (75, 53, 0.1, 90, 11, 3),
                  (33, 61, 0.05, 1000, 60, 7)]


@pytest.mark.parametrize("h,w,res,n,b,seed", REWEIGHT_CASES)
def test_b1_plain_matches_pallas_interpret(h, w, res, n, b, seed):
    c = reweight_case(h, w, res, n, b, seed)
    jtf = c["jtf"]
    want = j_fused_reweight(*c["jcb"], jtf.x, jtf.y, jtf.rot.cos, jtf.rot.sin, c["jpts"],
                            c["jmask"], c["jfield"].resolution, c["jfield"].unknown_prob,
                            interpret=True)
    args = (c["codes"], c["book"], *c["tf"], c["pts"], c["mask"], c["field"].resolution,
            c["field"].unknown_prob)
    got = fused_reweight(*args)  # CPU tensors: the wrapper runs the plain version
    np.testing.assert_array_equal(got.numpy(), fused_reweight_reference(*args).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("h,w,res,n,b,seed", REWEIGHT_CASES)
def test_b1_cells_and_weights_match_xla_codebook_path(h, w, res, n, b, seed):
    """Against the JAX package's XLA code-table path on the CPU.  The cell
    indices are compared one by one: all of them are equal (XLA's CPU
    backend did not contract the transform into FMAs here)."""
    c = reweight_case(h, w, res, n, b, seed)
    want = j_weights_codebook(c["jfield"], c["jcb"], c["jstates"], c["jpts"], c["jmask"])
    states = SE2.from_xytheta(c["xs"], c["ys"], c["th"])
    got = likelihood_field_weights_codebook(c["field"], (c["codes"], c["book"]), states,
                                            c["pts"], c["mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)

    # cell indices, the reference's formula (likelihood_field.py:226-233)
    jtf = c["jtf"]
    px, py = c["jpts"][None, :, 0], c["jpts"][None, :, 1]
    jx = px * jtf.rot.cos[:, None] - py * jtf.rot.sin[:, None] + jtf.x[:, None]
    jy = px * jtf.rot.sin[:, None] + py * jtf.rot.cos[:, None] + jtf.y[:, None]
    jxi = np.asarray(jnp.floor(jx / c["jfield"].resolution).astype(jnp.int32))
    jyi = np.asarray(jnp.floor(jy / c["jfield"].resolution).astype(jnp.int32))
    tf = c["field"].world_to_field @ states
    fx, fy = endpoint_cells(tf.x, tf.y, tf.rot.cos, tf.rot.sin, c["pts"], c["field"].resolution)
    differing = int((fx.numpy() != jxi).sum() + (fy.numpy() != jyi).sum())
    assert differing == 0, f"{differing} cell indices differ"
    inside = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    assert 0 < int(inside.sum()) < inside.numel()  # on- and off-map endpoints both occur


def test_b1_wrapper_rejects_bad_inputs():
    c = reweight_case(40, 40, 0.1, 8, 4, 1)
    args = [c["codes"], c["book"], *c["tf"], c["pts"], c["mask"], 0.1, 0.5]
    with pytest.raises(ValueError, match="uint8"):
        fused_reweight(c["codes"].int(), *args[1:])
    with pytest.raises(ValueError, match="points"):
        fused_reweight(*args[:6], c["pts"][:, :1].contiguous(), *args[7:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_reweight(*args[:2], torch.zeros(16)[::2], *args[3:])
    with pytest.raises(ValueError, match="beam_mask"):
        fused_reweight(*args[:7], c["mask"][:2], *args[8:])


@pytest.mark.parametrize("negate", [0, 1])
def test_load_pgm_yaml_matches_reference(tmp_path, negate):
    from beluga_tpu.maps.occupancy import load_pgm_yaml as j_load

    from beluga_tpu_torch.maps.occupancy import load_pgm_yaml

    img = np.random.default_rng(negate).choice([0, 100, 205, 254], (7, 9)).astype(np.uint8)
    (tmp_path / "m.pgm").write_bytes(b"P5\n# a comment\n9 7\n255\n" + img.tobytes())
    (tmp_path / "m.yaml").write_text(
        f"image: m.pgm\nresolution: 0.05\norigin: [-1.0, 2.0, 0.3]\nnegate: {negate}\n"
        "occupied_thresh: 0.65\nfree_thresh: 0.196\n")
    ref = jax.device_get(j_load(str(tmp_path / "m.yaml")))
    got = load_pgm_yaml(str(tmp_path / "m.yaml"), device=CPU)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.free_xy.numpy(), np.asarray(ref.free_xy))
    np.testing.assert_array_equal(got.origin.rot.z.numpy(), np.asarray(ref.origin.rot.z))
    assert got.origin_xytheta == (-1.0, 2.0, 0.3)
