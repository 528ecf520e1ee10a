"""nav2's likelihood-field probability model in the port (kernels B1-log and
B4-log, ``likelihood_field_prob_weights``, the builder and the node) and
the float-table lookup modes (``gather``, ``onehot``, ``lowrank``), held
against the JAX package on the CPU.

Tolerances:
* ``likelihood_field_prob_weights`` through the float table: within 2e-5
  of the reference (``log`` of the same float32 values in two libraries,
  summed in other orders);
* B1-log's plain version against ``fused_reweight(interpret=True,
  log_space=True)``: atol 1e-4 at 17 beams, the reference's own bound
  (tests/test_gather2d.py:573-607); measured ~1e-5;
* B4-log: the port's ``bf16(log pz)`` table is bit-equal to copy 0 of the
  reference's; a single-beam weight is that table entry (or
  ``f32(log unknown)`` off the map) exactly, the full sum within rtol 1e-6
  of a float64 sum of the same entries; against the exact log weights
  within ``Σ_b |log pz_b| · 2⁻⁸``: bf16 keeps 8 significant bits, so an
  entry may be off by half its spacing, 2⁻⁸ of its magnitude (a bound of
  2⁻⁹ is too tight by that factor of 2: these inputs reach 0.54 of the
  2⁻⁸ bound, 1.08 of a 2⁻⁹ one);
* ``gather`` and ``onehot`` equal the reference's ``gather`` weights
  within rtol 1e-6; ``lowrank`` factors equal the reference's to 1e-5 and
  the weights are within rtol 1e-5;
* one filter update with the reference's draws: particle states within
  1e-5 where the same donor was taken (a weight within ~1e-7 of a CDF step
  may take the neighbouring donor; at most 0.5% of the slots), the model's
  log-weights within 2e-4 (sums of 60 logs of magnitude up to ~5).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.core.random import sample_normal_se2 as j_sample_normal_se2
from beluga_tpu.core.random import sample_uniform_free_cells as j_sample_free_cells
from beluga_tpu.filters import amcl as j_amcl
from beluga_tpu.filters.builders import _make_field_codes as j_make_field_codes
from beluga_tpu.filters.builders import make_likelihood_field_filter as j_make_filter
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import OCCUPIED_VALUE
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor import likelihood_field as JLF
from beluga_tpu.ops import gather2d as JG
from beluga_tpu.ops.pallas_reweight import build_values3 as j_build_values3
from beluga_tpu.ops.pallas_reweight import fused_reweight as j_fused_reweight
from beluga_tpu.ops.resample import systematic_positions as j_systematic_positions
from beluga_tpu_torch import convert
from beluga_tpu_torch.filters import amcl
from beluga_tpu_torch.filters.builders import make_likelihood_field_filter, update_map_ctx
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import make_grid
from beluga_tpu_torch.models.sensor import likelihood_field as PLF
from beluga_tpu_torch.node import AmclNode
from beluga_tpu_torch.ops import cuda_reweight as b1
from beluga_tpu_torch.ops import gather2d as PG

torch.set_num_threads(1)

LF = dict(max_obstacle_distance=2.0, max_laser_distance=100.0)  # nav2 defaults
GATE_POS, GATE_YAW = 0.9, math.radians(30.0)  # tests/test_system.py:44-45


def t(a):
    return torch.as_tensor(np.array(a))


def small_map():
    """tests/test_gather2d.py:343-346 plus an unknown patch."""
    data = np.zeros((96, 96), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[40:44, 60:66] = OCCUPIED_VALUE
    data[10:14, 10:12] = -1
    return data


@pytest.fixture(scope="module")
def case():
    """Both packages' nav2-default field and tables on the 96x96 map at 5 cm."""
    jgrid = j_make_grid(small_map(), 0.05)
    jfield = JLF.make_likelihood_field(JLF.LikelihoodFieldParams(**LF), jgrid)
    jcodes, jbook = j_make_field_codes(jfield, JLF.LikelihoodFieldParams(**LF), jgrid)
    codes, book = convert.field_codes(jax.device_get((jcodes, jbook)))
    return dict(jfield=jfield, jcodes=jcodes, jbook=jbook,
                field=convert.field(jax.device_get(jfield)), codes=codes, book=book)


def cloud(n, cx, cy, sig_xy, sig_th, seed):
    rng = np.random.default_rng(seed)
    xyt = [rng.normal(cx, sig_xy, n), rng.normal(cy, sig_xy, n), rng.normal(0.4, sig_th, n)]
    xyt = [np.asarray(v, np.float32) for v in xyt]
    return JSE2.from_xytheta(*map(jnp.asarray, xyt)), SE2.from_xytheta(*map(torch.as_tensor, xyt))


def scan(b=17, r=1.9, seed=2):
    """tests/test_gather2d.py:372-378."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(-2.0, 2.0, b)
    rr = rng.uniform(0.2, r, b)
    return (np.stack([rr * np.cos(ang), rr * np.sin(ang)], -1).astype(np.float32),
            rng.random(b) < 0.9)


def transforms(field, states):
    tf = field.world_to_field @ states
    return [v.contiguous() for v in (tf.x, tf.y, tf.rot.cos, tf.rot.sin)]


@pytest.mark.parametrize("spread", ["converged", "diverged"])
def test_prob_weights_and_b1_log_match_reference(case, spread):
    """The float-table prob weights and B1-log's plain version (through the
    wrapper, on CPU tensors) against the reference's."""
    sig = (0.05, 0.05) if spread == "converged" else (1.5, 1.5)
    jst, st = cloud(150, 2.4, 2.4, *sig, seed=13)
    pts, mask = scan()
    want = np.asarray(JLF.likelihood_field_prob_weights(case["jfield"], jst, jnp.asarray(pts),
                                                        jnp.asarray(mask), lookup_mode="gather"))
    got = PLF.likelihood_field_prob_weights(case["field"], st, t(pts), t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert (got <= 0).all() and got.min() < -10  # log of probabilities below 1
    jtf = case["jfield"].world_to_field @ jst
    j_log = np.asarray(j_fused_reweight(
        case["jcodes"], case["jbook"], jtf.x, jtf.y, jtf.rot.cos, jtf.rot.sin, jnp.asarray(pts),
        jnp.asarray(mask), case["jfield"].resolution, case["jfield"].unknown_prob,
        interpret=True, log_space=True))
    field = case["field"]
    rest = (t(pts), t(mask), field.resolution, field.unknown_prob)
    plain = b1.fused_reweight_reference(case["codes"], case["book"], *transforms(field, st),
                                        *rest, log_space=True)
    via = b1.fused_reweight(case["codes"], case["book"], *transforms(field, st), *rest,
                            log_space=True)
    assert torch.equal(via, plain)
    np.testing.assert_allclose(plain.numpy(), j_log, rtol=0, atol=1e-4)
    # through the code table: the same weights as the float table
    codes_w = PLF.likelihood_field_prob_weights(field, st, t(pts), t(mask),
                                                codes_book=(case["codes"], case["book"]))
    np.testing.assert_allclose(codes_w.numpy(), got, rtol=0, atol=2e-5)


def test_b4_log_table_and_plain_version(case):
    field = case["field"]
    jv3 = j_build_values3(case["jcodes"], case["jbook"], log_space=True)
    v3 = b1.build_values3(case["codes"], case["book"], log_space=True)
    h, w = field.values.shape
    np.testing.assert_array_equal(v3.view(torch.int16).numpy(),
                                  convert.field_values3(jv3, (h, w)).view(torch.int16).numpy())
    _, st = cloud(300, 2.4, 2.4, 1.2, 1.0, seed=4)  # some endpoints off the map
    pts, mask = scan(b=23)
    tf = transforms(field, st)
    rest = (t(pts), t(mask), field.resolution, field.unknown_prob)
    got = b1.fused_reweight(case["codes"], case["book"], *tf, *rest, values3=v3, log_space=True)
    assert torch.equal(got, b1.fused_reweight_values3_reference(v3, *tf, *rest, log_space=True))
    # single beams: the table entry, or f32(log unknown) off the map
    fx, fy = b1.endpoint_cells(*tf, t(pts), field.resolution)
    inside = ((fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)).numpy()
    table = v3.float().numpy()
    entry = np.where(inside, table[np.clip(fy.numpy(), 0, h - 1).astype(int),
                                   np.clip(fx.numpy(), 0, w - 1).astype(int)],
                     np.float32(np.log(np.float32(field.unknown_prob))))
    assert (~inside).any() and inside.any()
    for b in np.nonzero(mask)[0][:4]:
        one = np.zeros_like(mask)
        one[b] = True
        single = b1.fused_reweight_values3_reference(v3, *tf, t(pts), t(one), field.resolution,
                                                     field.unknown_prob, log_space=True)
        np.testing.assert_array_equal(single.numpy(), entry[:, b])
    want64 = np.sum(np.where(mask[None, :], entry.astype(np.float64), 0.0), axis=1)
    np.testing.assert_allclose(got.numpy(), want64, rtol=1e-6, atol=0)
    exact = b1.fused_reweight(case["codes"], case["book"], *tf, *rest, log_space=True)
    # |entry| is |log pz| to within 2^-8 of itself
    bound = np.sum(np.where(mask[None, :], np.abs(entry), 0.0), axis=1) * 2.0**-8 * (1 + 2.0**-7)
    err = np.abs(got.numpy() - exact.numpy())
    print(f"B4-log against B1-log: at most {float(np.max(err / bound)):.3f} of the 2^-8 bound")
    assert (err <= bound + 1e-5).all()
    assert not torch.equal(got, exact)


@pytest.mark.parametrize("cx,cy,seed", [(2.4, 2.4, 5), (1.7, 3.1, 6)])
def test_b4_log_matches_reference_fast_path_on_converged_clouds(case, cx, cy, seed):
    """The reference's per-beam-window fast path fires on a converged cloud
    and reads the same bf16(log pz) entries: rtol 1e-5, the beam-sum
    order (the port's codebook16 test, in log space)."""
    field = case["field"]
    jst, st = cloud(130, cx, cy, 0.02, 0.01, seed)
    pts, mask = scan(b=23)
    jtf = case["jfield"].world_to_field @ jst
    jv3 = j_build_values3(case["jcodes"], case["jbook"], log_space=True)
    want = np.asarray(j_fused_reweight(
        case["jcodes"], case["jbook"], jtf.x, jtf.y, jtf.rot.cos, jtf.rot.sin, jnp.asarray(pts),
        jnp.asarray(mask), case["jfield"].resolution, case["jfield"].unknown_prob,
        interpret=True, values3=jv3, log_space=True))
    v3 = b1.build_values3(case["codes"], case["book"], log_space=True)
    got = b1.fused_reweight_values3_reference(v3, *transforms(field, st), t(pts), t(mask),
                                              field.resolution, field.unknown_prob,
                                              log_space=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


def test_prob_model_builder_ctx():
    """tests/test_gather2d.py:609-624: the prob model carries the code table
    (and the log-space table in codebook16 mode) in the ctx; a map swap
    rebuilds both, in log space; the model returns the log-weights as they
    are."""
    data, data2 = small_map(), small_map()
    data2[60:70, 20:26] = OCCUPIED_VALUE
    lf = PLF.LikelihoodFieldParams(**LF)
    models, ctx = make_likelihood_field_filter(make_grid(data, 0.05, device="cpu"), lf,
                                               prob_model=True, lookup_mode="codebook16",
                                               device="cpu")
    assert "field_codes" in ctx and "field_values3" in ctx and ctx["field_values3_log"]
    _, ctx2 = make_likelihood_field_filter(make_grid(data, 0.05, device="cpu"), lf,
                                           prob_model=True, device="cpu")
    assert "field_codes" in ctx2 and "field_values3" not in ctx2
    _, jctx = j_make_filter(j_make_grid(data, 0.05), JLF.LikelihoodFieldParams(**LF),
                            prob_model=True, lookup_mode="codebook16")
    ref = convert.ctx(jax.device_get(jctx))
    assert sorted(ref) == sorted(ctx)
    assert torch.equal(ctx["field_values3"].view(torch.int16),
                       ref["field_values3"].view(torch.int16))
    swapped = update_map_ctx(ctx, make_grid(data2, 0.05, device="cpu"), lf)
    assert torch.equal(swapped["field_values3"],
                       b1.build_values3(*swapped["field_codes"], log_space=True))
    assert not torch.equal(swapped["field_values3"], ctx["field_values3"])
    _, st = cloud(40, 2.4, 2.4, 0.05, 0.05, seed=1)
    pts, mask = (t(a) for a in scan())
    tf = transforms(swapped["field"], st)
    want = b1.fused_reweight_values3_reference(swapped["field_values3"], *tf, pts, mask,
                                               swapped["field"].resolution,
                                               swapped["field"].unknown_prob, log_space=True)
    assert torch.equal(models.log_weight(swapped, st, pts, mask), want)


@pytest.mark.parametrize("mode", ["gather", "onehot", "lowrank"])
def test_lookup_modes_match_reference(case, mode):
    """The float-table modes and the lowrank mode, weights and filter
    log-weights, against the reference's on the same field."""
    jf, field = case["jfield"], case["field"]
    jst, st = cloud(120, 2.4, 2.4, 0.8, 1.0, seed=8)
    pts, mask = scan(b=23)
    if mode == "lowrank":
        ju, jv = JG.factorize_table(jf.values, 24)
        u, v = PG.factorize_table(field.values, 24)
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
        want = np.asarray(JLF.likelihood_field_weights_lowrank(jf, (ju, jv), jst,
                                                               jnp.asarray(pts),
                                                               jnp.asarray(mask)))
        got = PLF.likelihood_field_weights_lowrank(field, (t(ju), t(jv)), st, t(pts),
                                                   t(mask)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        rng = np.random.default_rng(1)
        yi, xi = rng.integers(-5, 101, (2, 500))
        np.testing.assert_allclose(PG.lowrank_lookup(t(ju), t(jv), t(yi), t(xi)).numpy(),
                                   np.asarray(JG._lowrank_lookup(ju, jv, yi, xi)), rtol=0,
                                   atol=1e-6)
        return
    want = np.asarray(JLF.likelihood_field_weights(jf, jst, jnp.asarray(pts), jnp.asarray(mask),
                                                   lookup_mode="gather"))
    got = PLF.likelihood_field_weights(field, st, t(pts), t(mask), lookup_mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    rng = np.random.default_rng(2)
    yi, xi = rng.integers(-5, 101, (2, 300, 7))
    np.testing.assert_array_equal(PG.table_lookup(field.values, t(yi), t(xi), mode).numpy(),
                                  np.asarray(JG.table_lookup(jf.values, yi, xi, "gather")))


def test_lookup_mode_filters():
    """The builder's gather, onehot and lowrank filters: ctx keys as the
    reference's, log-weights the log of their weights."""
    data = small_map()
    lf = PLF.LikelihoodFieldParams(**LF)
    _, st = cloud(30, 2.4, 2.4, 0.1, 0.1, seed=3)
    pts, mask = (t(a) for a in scan())
    for mode in ("gather", "onehot", "lowrank"):
        models, ctx = make_likelihood_field_filter(make_grid(data, 0.05, device="cpu"), lf,
                                                   lookup_mode=mode, lowrank_rank=16,
                                                   device="cpu")
        _, jctx = j_make_filter(j_make_grid(data, 0.05), JLF.LikelihoodFieldParams(**LF),
                                lookup_mode=mode, lowrank_rank=16)
        assert sorted(ctx) == sorted(jctx), mode
        if mode == "lowrank":
            w = PLF.likelihood_field_weights_lowrank(ctx["field"], ctx["field_factors"], st, pts,
                                                     mask)
            assert ctx["field_factors"][0].shape == (96, 16)
            swapped = update_map_ctx(ctx, make_grid(data, 0.05, device="cpu"), lf)
            assert swapped["field_factors"][1].shape == (96, 16)
        else:
            w = PLF.likelihood_field_weights(ctx["field"], st, pts, mask)
        assert torch.equal(models.log_weight(ctx, st, pts, mask), torch.log(w))
    with pytest.raises(ValueError, match="lookup_mode"):
        make_likelihood_field_filter(make_grid(data, 0.05, device="cpu"), lookup_mode="bogus",
                                     device="cpu")


# -- the prob model's filter update and node -----------------------------------


@functools.partial(jax.jit, static_argnums=3)
def _draws(key, free_xy, num_free, n):
    _, k_prop, k_res, k_rand, k_mask = jax.random.split(key, 5)
    return (jax.random.normal(k_prop, (3, n), jnp.float32), j_systematic_positions(k_res, n),
            jax.random.uniform(k_mask, (n,), jnp.float32),
            j_sample_free_cells(k_rand, n, free_xy, num_free))


def reference_draws(jstate, jctx, n):
    """Every draw of the reference's update from its key
    (filters/amcl.py:315), as the port's ``UpdateDraws``; one jit, so the
    reference compiles once rather than per operation."""
    grid = jctx["grid"]
    normals, positions, uniform, randoms = _draws(jstate.key, grid.free_xy, grid.num_free, n)
    return amcl.UpdateDraws(
        motion_normals=t(normals),
        positions=t(positions),
        inject_uniform=t(uniform),
        random_states=convert.se2(jax.device_get(randoms)),
    )


def test_one_prob_update_matches_reference():
    """One update of the prob-model filter (systematic resampling, 1500
    particles) on the arena with the reference's draws: the reference reads
    the float table, the port its code table through B1-log's plain
    version; same donors but for slots whose weight sits at a CDF step."""
    size, res, n = 160, 0.05, 1500
    data = synthetic.tracking_arena(size, res)
    xs, ys, yaws = synthetic.circle_trajectory(2, size, res)
    pts, mask = synthetic.simulate_scans(data, res, xs, ys, yaws, 60)
    jgrid = j_make_grid(data, res)
    jmodels, jctx = j_make_filter(jgrid, JLF.LikelihoodFieldParams(**LF), prob_model=True)
    models, own_ctx = make_likelihood_field_filter(make_grid(data, res, device="cpu"),
                                                   PLF.LikelihoodFieldParams(**LF),
                                                   prob_model=True, device="cpu")
    ctx = convert.ctx(jax.device_get(jctx))
    assert sorted(ctx) == sorted(own_ctx) == ["field", "field_codes", "grid"]
    kw = dict(max_particles=n, min_particles=n, resampling="systematic")
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    k_init, k_state = jax.random.split(jax.random.PRNGKey(7))
    start = JSE2.from_xytheta(float(xs[0]), float(ys[0]), float(yaws[0]))
    jstates = j_sample_normal_se2(k_init, n, start, jnp.diag(jnp.asarray([0.05, 0.05, 0.02])))
    jstate = j_amcl.init_state(k_state, jstates, jparams)
    state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
    draws = reference_draws(jstate, jctx, n)
    odom = (float(xs[0]), float(ys[0]), float(yaws[0]))
    jnew, jest = jax.jit(lambda s, o, p, m: j_amcl.update(jparams, jmodels, jctx, s, o, p, m))(
        jstate, JSE2.from_xytheta(*odom), jnp.asarray(pts[0]), jnp.asarray(mask[0]))
    new, est = amcl.update(params, models, ctx, state, amcl.host_pose(*odom), t(pts[0]),
                           t(mask[0]), draws=draws)
    # the model's log-weights on the initial cloud
    want = np.asarray(jmodels.log_weight(jctx, jstates, jnp.asarray(pts[0]),
                                         jnp.asarray(mask[0])))
    got = models.log_weight(ctx, state.particles.state, t(pts[0]), t(mask[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    assert got.max() - got.min() > 50  # the prob model's peaked weights
    ref = jax.device_get(jnew)
    assert est.valid and bool(jest.valid)
    xy, z = new.particles.state.xy.numpy(), new.particles.state.rot.z.numpy()
    jxy, jz = np.asarray(ref.particles.state.xy), np.asarray(ref.particles.state.rot.z)
    other = (np.abs(xy - jxy).max(1) > 1e-5) | (np.abs(z - jz).max(1) > 1e-5)
    assert other.sum() <= n // 200, f"{other.sum()} slots hold another donor"
    np.testing.assert_allclose(xy[~other], jxy[~other], rtol=0, atol=1e-5)
    d = np.abs(np.concatenate([xy - jxy, z - jz], 1)).max(1)[other]
    np.testing.assert_allclose(est.pose.xy.numpy(), np.asarray(jest.pose.xy),
                               atol=1e-4 + float(d.sum()) / n)


def test_prob_node_tracks_arena_on_cpu():
    """AmclNode with ``laser_model_type="likelihood_field_prob"`` at nav2
    defaults tracks the arena's circle within the system-test gate."""
    res, scans = 0.05, 10
    data = synthetic.tracking_arena(384, res)
    xs, ys, yaws = synthetic.circle_trajectory(scans, 384, res)
    pts, mask = synthetic.simulate_scans(data, res, xs, ys, yaws, 60)
    cfg = AmclNodeConfig(laser_model_type="likelihood_field_prob", set_initial_pose=True,
                         initial_pose_x=float(xs[0]), initial_pose_y=float(ys[0]),
                         initial_pose_yaw=float(yaws[0]), initial_pose_covariance_yaw=0.068)
    node = AmclNode(cfg, seed=0, device="cpu")
    node.set_map(make_grid(data, res, device="cpu"))
    assert "field_codes" in node._ctx and "field_values3" not in node._ctx
    for i in range(scans):
        r = node.handle_scan((xs[i], ys[i], yaws[i]), pts[i], mask[i])
        assert r.valid
        err_yaw = abs(math.atan2(math.sin(r.pose[2] - yaws[i]), math.cos(r.pose[2] - yaws[i])))
        assert math.hypot(r.pose[0] - xs[i], r.pose[1] - ys[i]) < GATE_POS, i
        assert err_yaw < GATE_YAW, i
