"""Kernel R1's bit plane and its exact beam-weights entry on the CPU
(``beluga_tpu_torch/ops/raycast.py``).

* ``pack_free_bits`` against ``grid.free_mask``, bit by bit: odd widths,
  widths that are not a multiple of 32, all-free and all-occupied maps;
  padding bits are non-free.
* ``exact_beam_weights``' plain version (what the entry runs on CPU tensors)
  against the JAX package's ``beam_weights`` and ``beam_log_weights``, both
  Bresenham variants, on seeded numpy inputs and a map with a rotated
  origin: every particle within rtol 2e-5 (the tolerance of
  tests/test_torch_beam.py: ``torch.erf``/``exp`` against XLA's differ by an
  ulp or two, which ``eta_hit``'s difference of two erfs can raise to
  ~1.6e-5 relative), the log weights within abs 2e-5.
* The plane lives with its grid: packed once, a new grid (``update_map_ctx``,
  ``grid.to``) packs its own, and the exact filter's weights follow a map
  swap.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor.beam import BeamModelParams as JBeamModelParams
from beluga_tpu.models.sensor.beam import beam_log_weights as j_beam_log_weights
from beluga_tpu.models.sensor.beam import beam_weights as j_beam_weights
from beluga_tpu_torch.filters.builders import make_beam_filter, update_map_ctx
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import (
    FREE_VALUE,
    OCCUPIED_VALUE,
    UNKNOWN_VALUE,
    make_grid,
)
from beluga_tpu_torch.models.sensor.beam import BeamModelParams, exact_mixture
from beluga_tpu_torch.ops import raycast

torch.set_num_threads(1)


def unpack(words: torch.Tensor, width: int) -> np.ndarray:
    """``bool[H, 32 * wpr]`` from the packed words, bit x % 32 of word x // 32."""
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    bits = (w[:, :, None] >> np.arange(32)) & 1
    return bits.reshape(w.shape[0], -1).astype(bool)


@pytest.mark.parametrize("h,w,fill", [(7, 33, "random"), (40, 50, "random"), (5, 1, "random"),
                                      (3, 64, "random"), (9, 31, "free"), (6, 95, "occupied"),
                                      (1, 32, "free"), (4, 65, "unknown")])
def test_pack_free_bits_matches_free_mask(h, w, fill):
    rng = np.random.default_rng(h * 100 + w)
    if fill == "random":
        data = rng.choice([FREE_VALUE, OCCUPIED_VALUE, UNKNOWN_VALUE], (h, w)).astype(np.int8)
    else:
        data = np.full((h, w), {"free": FREE_VALUE, "occupied": OCCUPIED_VALUE,
                                "unknown": UNKNOWN_VALUE}[fill], np.int8)
    grid = make_grid(data, 0.1, device="cpu")
    words = raycast.pack_free_bits(grid.free_mask)
    wpr = -(-w // 32)
    assert words.dtype == torch.int32 and tuple(words.shape) == (h, wpr)
    bits = unpack(words, w)
    np.testing.assert_array_equal(bits[:, :w], grid.free_mask.numpy())
    assert not bits[:, w:].any()  # padding reads as non-free
    if fill == "free":
        assert bits[:, :w].all()
    if fill in ("occupied", "unknown"):
        assert not bits.any()


def beam_case(seed, n=200, nb=24, origin=None):
    """A walled 64 x 72 map with blocks and unknown cells at 0.1 m, ``n``
    particles inside it, and a scan of ``nb`` beams with a masked one."""
    rng = np.random.default_rng(seed)
    data = np.zeros((64, 72), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[rng.random((64, 72)) < 0.03] = OCCUPIED_VALUE
    data[20:26, 30:40] = OCCUPIED_VALUE
    data[40:44, 10:14] = UNKNOWN_VALUE
    ox, oy, oyaw = (0.0, 0.0, 0.0) if origin is None else origin
    c, s = np.cos(oyaw), np.sin(oyaw)
    local = rng.uniform([0.5, 0.5], [6.7, 5.9], (n, 2))
    xs = ox + c * local[:, 0] - s * local[:, 1]
    ys = oy + s * local[:, 0] + c * local[:, 1]
    ths = rng.uniform(-np.pi, np.pi, n)
    ang = np.linspace(-np.pi, np.pi, nb, endpoint=False)
    r = rng.uniform(0.3, 7.0, nb)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    mask = np.ones(nb, bool)
    mask[5] = False
    return (data, xs.astype(np.float32), ys.astype(np.float32), ths.astype(np.float32), pts,
            mask)


@pytest.mark.parametrize("variant", ["standard", "supercover"])
@pytest.mark.parametrize("bmr,origin", [(8.0, None), (100.0, None), (8.0, (1.5, -2.0, 0.4))])
def test_exact_entry_plain_version_matches_reference(variant, bmr, origin):
    data, xs, ys, ths, pts, mask = beam_case(0 if origin is None else 1, origin=origin)
    jgrid = j_make_grid(data, 0.1, origin=origin)
    jargs = (JBeamModelParams(beam_max_range=bmr), jgrid, JSE2.from_xytheta(xs, ys, ths),
             jnp.asarray(pts), jnp.asarray(mask))
    want = np.asarray(j_beam_weights(*jargs, variant=variant))
    want_log = np.asarray(j_beam_log_weights(*jargs, variant=variant))
    grid = make_grid(data, 0.1, origin=origin, device="cpu")
    params = BeamModelParams(beam_max_range=bmr)
    args = (grid, SE2.from_xytheta(xs, ys, ths), torch.as_tensor(pts), torch.as_tensor(mask),
            exact_mixture(params), bmr, variant)
    before = raycast.exact_launches
    got = raycast.exact_beam_weights(*args).numpy()
    got_log = raycast.exact_beam_weights(*args, log_space=True).numpy()
    assert raycast.exact_launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    np.testing.assert_allclose(got_log, want_log, rtol=0, atol=2e-5)
    assert np.ptp(want_log) > 1.0  # the weights do discriminate


def test_exact_entry_plain_version_sums_beams_in_order():
    """The plain version's sum is each particle's pz³ added beam by beam,
    masked beams left out, and its pz³ are ``exact_pz3_reference``'s."""
    data, xs, ys, ths, pts, mask = beam_case(2, n=50)
    grid = make_grid(data, 0.1, device="cpu")
    states = SE2.from_xytheta(xs, ys, ths)
    mix = exact_mixture(BeamModelParams(beam_max_range=8.0))
    pz3 = raycast.exact_pz3_reference(grid, states, torch.as_tensor(pts), mix, 8.0)
    acc = torch.zeros(50)
    for b in np.nonzero(mask)[0]:
        acc = acc + pz3[:, b]
    got = raycast.exact_beam_weights(grid, states, torch.as_tensor(pts), torch.as_tensor(mask),
                                     mix, 8.0)
    assert torch.equal(got, acc)


def test_plane_lives_with_its_grid():
    """``free_plane(grid)`` is packed once a grid, holds ``world_to_grid`` as
    lie.py computes ``origin.inverse()``, and a moved grid packs its own."""
    data = beam_case(3)[0]
    grid = make_grid(data, 0.1, origin=(1.5, -2.0, 0.4), device="cpu")
    plane = raycast.free_plane(grid)
    assert raycast.free_plane(grid) is plane
    assert torch.equal(plane.bits, raycast.pack_free_bits(grid.free_mask))
    inv = grid.origin.inverse()
    assert plane.world_to_grid == (*inv.xy.tolist(), *inv.rot.z.tolist())
    moved = grid.to("cpu")
    assert raycast.free_plane(moved) is not plane
    assert torch.equal(raycast.free_plane(moved).bits, plane.bits)


def test_update_map_ctx_gives_the_exact_filter_the_new_plane():
    """A map swap on an exact beam ctx: the new grid's plane is the new
    map's, the old one untouched, and the weights follow the new map
    (equal to a filter built on it, unequal to the old map's)."""
    data, xs, ys, ths, pts, mask = beam_case(4)
    models, ctx = make_beam_filter(make_grid(data, 0.1, device="cpu"),
                                   BeamModelParams(beam_max_range=8.0), device="cpu")
    assert set(ctx) == {"grid"}
    old_bits = raycast.free_plane(ctx["grid"]).bits.clone()
    states = SE2.from_xytheta(xs, ys, ths)
    args = (states, torch.as_tensor(pts), torch.as_tensor(mask))
    before = models.log_weight(ctx, *args)
    data2 = data.copy()
    data2[10:50, 45:60] = OCCUPIED_VALUE
    grid2 = make_grid(data2, 0.1, device="cpu")
    swapped = update_map_ctx(ctx, grid2, AmclNodeConfig().likelihood_field_params())
    new_bits = raycast.free_plane(swapped["grid"]).bits
    assert torch.equal(new_bits, raycast.pack_free_bits(grid2.free_mask))
    assert torch.equal(raycast.free_plane(ctx["grid"]).bits, old_bits)
    assert not torch.equal(new_bits, old_bits)
    after = models.log_weight(swapped, *args)
    fresh = models.log_weight(make_beam_filter(grid2, BeamModelParams(beam_max_range=8.0),
                                               device="cpu")[1], *args)
    assert torch.equal(after, fresh) and not torch.equal(after, before)
