"""The codebook16 lookup mode of the PyTorch port (kernel B4, its table
``build_values3`` and the builder's ctx), held against the JAX package on
the CPU.

* The port's table is bit-equal to copy 0 of the reference's
  ``build_values3`` (transposed back to ``[H, W]``).
* On converged clouds the reference's fast path reads the same bf16 pz³
  entries (tests/test_gather2d.py:380-405), so B4's plain version agrees
  with ``fused_reweight(values3=..., interpret=True)`` within rtol 1e-5
  (the beam-sum order).
* Elsewhere the two differ by design.  The reference clamps in-map queries
  that fall outside their per-beam window to the field floor, and sends a
  flagged stray block, or a tile whose clamp fraction exceeds 0.5%, down
  the exact path (pallas_reweight.py:113-116): a diverged cloud on the
  384x384 map comes back bit-exact.  The port has no windows: every
  in-map query reads its own bf16 entry.  So there the test holds B4
  within 5e-3 relative of the exact path (the bound the reference's own
  tests use, tests/test_gather2d.py:407-446), not to the reference's
  fast path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.filters.builders import _make_field_codes as j_make_field_codes
from beluga_tpu.filters.builders import make_likelihood_field_filter as j_make_filter
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import OCCUPIED_VALUE
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor.likelihood_field import LikelihoodFieldParams as JLFParams
from beluga_tpu.models.sensor.likelihood_field import make_likelihood_field as j_make_field
from beluga_tpu.ops.pallas_reweight import build_values3 as j_build_values3
from beluga_tpu.ops.pallas_reweight import fused_reweight as j_fused_reweight
from beluga_tpu_torch import convert
from beluga_tpu_torch.filters.builders import make_likelihood_field_filter, update_map_ctx
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import make_grid
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams
from beluga_tpu_torch.ops.cuda_reweight import (
    build_values3,
    fused_reweight,
    fused_reweight_reference,
    fused_reweight_values3_reference,
)

torch.set_num_threads(1)


def small_map(size=96, block=(40, 44, 60, 66)):
    data = np.zeros((size, size), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    r0, r1, c0, c1 = block
    data[r0:r1, c0:c1] = OCCUPIED_VALUE
    return data


def case(data):
    """Both packages' field and tables on one map (nav2-default field)."""
    jgrid = j_make_grid(data, 0.05)
    jfield = j_make_field(JLFParams(), jgrid)
    jcodes, jbook = j_make_field_codes(jfield, JLFParams(), jgrid)
    codes, book = convert.field_codes(jax.device_get((jcodes, jbook)))
    return dict(jfield=jfield, jcodes=jcodes, jbook=jbook, jv3=j_build_values3(jcodes, jbook),
                field=convert.field(jax.device_get(jfield)), codes=codes, book=book,
                v3=build_values3(codes, book))


def cloud(n, cx, cy, sig_xy=0.02, sig_th=0.01, seed=5, uniform=None):
    """tests/test_gather2d.py:352-360, or a uniform cloud over ``uniform``."""
    rng = np.random.default_rng(seed)
    if uniform is None:
        xyt = (rng.normal(cx, sig_xy, n), rng.normal(cy, sig_xy, n), rng.normal(0.4, sig_th, n))
    else:
        lo, hi = uniform
        xyt = (rng.uniform(lo, hi, n), rng.uniform(lo, hi, n), rng.uniform(-3.1, 3.1, n))
    return [np.asarray(v, np.float32) for v in xyt]


def scan(b=23, r=1.9, seed=2):
    """tests/test_gather2d.py:372-378."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(-2.0, 2.0, b)
    rr = rng.uniform(0.2, r, b)
    return (np.stack([rr * np.cos(ang), rr * np.sin(ang)], -1).astype(np.float32),
            rng.random(b) < 0.9)


def weights(c, xyt, pts, mask):
    """(reference fast path, reference exact path, port B4 plain, port B1
    plain) on one cloud."""
    jtf = c["jfield"].world_to_field @ JSE2.from_xytheta(*map(jnp.asarray, xyt))
    jargs = (c["jcodes"], c["jbook"], jtf.x, jtf.y, jtf.rot.cos, jtf.rot.sin, jnp.asarray(pts),
             jnp.asarray(mask), c["jfield"].resolution, c["jfield"].unknown_prob)
    j_fast = np.asarray(j_fused_reweight(*jargs, interpret=True, values3=c["jv3"]))
    j_exact = np.asarray(j_fused_reweight(*jargs, interpret=True))
    field = c["field"]
    tf = field.world_to_field @ SE2.from_xytheta(*map(torch.as_tensor, xyt))
    tf = [t.contiguous() for t in (tf.x, tf.y, tf.rot.cos, tf.rot.sin)]
    rest = (torch.as_tensor(pts), torch.as_tensor(mask), field.resolution, field.unknown_prob)
    b4 = fused_reweight_values3_reference(c["v3"], *tf, *rest)
    b1 = fused_reweight_reference(c["codes"], c["book"], *tf, *rest)
    # CPU tensors: the wrapper runs the plain versions
    assert torch.equal(fused_reweight(c["codes"], c["book"], *tf, *rest, values3=c["v3"]), b4)
    return j_fast, j_exact, b4.numpy(), b1.numpy()


@pytest.mark.parametrize("data", [small_map(), small_map(75, (10, 20, 30, 33)),
                                  synthetic.tracking_arena(384, 0.05)],
                         ids=["96", "75", "arena"])
def test_build_values3_bit_equal_to_reference_copy0(data):
    c = case(data)
    h, w = data.shape
    ref = np.asarray(c["jv3"])
    assert ref.shape[0] >= w and ref.shape[1] >= 4 * h  # padded, four shifted copies
    want = np.ascontiguousarray(ref[:w, :h].T).view(np.uint16)
    got = c["v3"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(convert.field_values3(ref, (h, w)).view(torch.int16).numpy(),
                                  c["v3"].view(torch.int16).numpy())


@pytest.mark.parametrize("cx,cy,seed", [(2.4, 2.4, 5), (1.7, 3.1, 6), (3.2, 1.2, 7)])
def test_b4_plain_matches_reference_fast_path_on_converged_clouds(cx, cy, seed):
    """The reference's fast branch fires on a converged cloud and reads the
    same bf16(pz³) entries: rtol 1e-5, the beam-sum order."""
    c = case(small_map())
    pts, mask = scan()
    j_fast, j_exact, b4, b1 = weights(c, cloud(130, cx, cy, seed=seed), pts, mask)
    np.testing.assert_allclose(b4, j_fast, rtol=1e-5, atol=0)
    assert not np.array_equal(j_fast, j_exact)  # the table is bf16: not the exact path
    np.testing.assert_allclose(b1, j_exact, rtol=0, atol=2e-5)
    assert np.max(np.abs(b4 - b1) / b1) < 5e-3


@pytest.mark.parametrize("kind", ["corner_low", "corner_high", "corner_mixed", "diverged_small",
                                  "diverged_large"])
def test_b4_plain_within_5e3_of_exact_on_edge_and_diverged_clouds(kind):
    """Edge clouds clip the reference's windows at the map corners; a
    diverged cloud on a small map stays on its fast path; on the 384x384
    map it overflows every window and the reference falls back to the
    exact path, bit for bit.  B4 reads its own bf16 entry everywhere."""
    if kind == "diverged_large":
        data = np.zeros((384, 384), np.int8)
        data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
        data[100:120, 200:230] = OCCUPIED_VALUE
        xyt = cloud(200, 0, 0, seed=9, uniform=(1.0, 18.0))
    else:
        data = small_map()
        xyt = {"corner_low": cloud(90, 0.2, 0.2, seed=2),
               "corner_high": cloud(90, 4.6, 4.6, seed=92),
               "corner_mixed": cloud(90, 0.2, 4.6, seed=48),
               "diverged_small": cloud(140, 0, 0, seed=9, uniform=(0.3, 4.5))}[kind]
    c = case(data)
    pts, mask = scan()
    j_fast, j_exact, b4, b1 = weights(c, xyt, pts, mask)
    np.testing.assert_allclose(b1, j_exact, rtol=0, atol=2e-5)
    assert np.max(np.abs(b4 - j_exact) / j_exact) < 5e-3
    assert np.max(np.abs(j_fast - j_exact) / j_exact) < 5e-3
    if kind == "diverged_large":
        np.testing.assert_array_equal(j_fast, j_exact)  # the reference fell back
        assert not np.array_equal(b4, b1)  # the port stays on its bf16 table


def test_builder_codebook16_ctx_survives_update_map_ctx():
    """``lookup_mode="codebook16"`` builds ``field_values3`` as the
    reference's builder does; a map swap rebuilds it for the new map; the
    model's log-weights are the log of B4's."""
    lf = dict(max_obstacle_distance=2.0, max_laser_distance=100.0)
    data, data2 = small_map(), small_map(96, (20, 30, 20, 26))
    models, ctx = make_likelihood_field_filter(make_grid(data, 0.05, device="cpu"),
                                               LikelihoodFieldParams(**lf),
                                               lookup_mode="codebook16", device="cpu")
    _, jctx = j_make_filter(j_make_grid(data, 0.05), JLFParams(**lf), lookup_mode="codebook16")
    ref = convert.ctx(jax.device_get(jctx))
    assert ctx["field_values3"].dtype == torch.bfloat16
    assert torch.equal(ctx["field_values3"].view(torch.int16), ref["field_values3"].view(torch.int16))
    ctx2 = update_map_ctx(ctx, make_grid(data2, 0.05, device="cpu"), LikelihoodFieldParams(**lf))
    assert torch.equal(ctx2["field_values3"], build_values3(*ctx2["field_codes"]))
    assert not torch.equal(ctx2["field_values3"], ctx["field_values3"])
    # the exact mode carries no bf16 table
    _, exact_ctx = make_likelihood_field_filter(make_grid(data, 0.05, device="cpu"),
                                                device="cpu")
    assert "field_values3" not in update_map_ctx(exact_ctx, make_grid(data2, 0.05, device="cpu"),
                                                 LikelihoodFieldParams())
    x, y, th = cloud(50, 2.4, 2.4)
    states = SE2.from_xytheta(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(th))
    pts, mask = (torch.as_tensor(a) for a in scan())
    tf = ctx2["field"].world_to_field @ states
    want = fused_reweight_values3_reference(
        ctx2["field_values3"], tf.x.contiguous(), tf.y.contiguous(), tf.rot.cos.contiguous(),
        tf.rot.sin.contiguous(), pts, mask, ctx2["field"].resolution, ctx2["field"].unknown_prob)
    assert torch.equal(models.log_weight(ctx2, states, pts, mask), torch.log(want))


def test_b4_wrapper_rejects_bad_tables():
    c = case(small_map())
    x, y, th = cloud(8, 2.4, 2.4)
    tf = c["field"].world_to_field @ SE2.from_xytheta(*map(torch.as_tensor, (x, y, th)))
    pts, mask = (torch.as_tensor(a) for a in scan())
    args = (c["codes"], c["book"], tf.x.contiguous(), tf.y.contiguous(), tf.rot.cos.contiguous(),
            tf.rot.sin.contiguous(), pts, mask, 0.05, 0.5)
    with pytest.raises(ValueError, match="values3"):
        fused_reweight(*args, values3=c["v3"].float())
    with pytest.raises(ValueError, match="values3"):
        fused_reweight(*args, values3=c["v3"][:10].contiguous())
