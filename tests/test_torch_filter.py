"""The PyTorch port's filter update and node, held against the JAX package
on the CPU, plus the package rules: no JAX anywhere in the port, entry
points that default to the card and raise without one, and the packed
scan input that rejects points not shaped ``[P, 2]``.

One full update: the reference runs on the CPU, where it resamples with
``systematic_indices`` + ``tree_take``; the port takes its accelerator
branch (positions, then kernel B2's plain version).  Both give donors in
the same order.  The port is handed every draw the reference made from
its key splits (``filters/amcl.py:315``).  Tolerances: the particle
states agree within 1e-5 (sin/cos/atan2 of the motion sample differ in
the last bits between XLA and PyTorch); log-weights, the gates and
counters are equal; the estimate agrees within 1e-4.  The weights differ
in the last bits too (the beam sum and the cumsum add in other orders),
so a resampling position that falls within ~1e-7 of a CDF step takes the
neighbouring donor: up to 0.5% of the slots may hold another particle,
and the KLD count, equal when no slot differs, may then move by 1%.
"""

import ast
import math
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.algorithms.thrun import ExpFilterState as JExpFilterState
from beluga_tpu.algorithms.thrun import ThrunState as JThrunState
from beluga_tpu.core.random import sample_normal_se2 as j_sample_normal_se2
from beluga_tpu.core.random import sample_uniform_free_cells as j_sample_free_cells
from beluga_tpu.filters import amcl as j_amcl
from beluga_tpu.filters.builders import make_likelihood_field_filter as j_make_filter
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor.likelihood_field import LikelihoodFieldParams as JLFParams
from beluga_tpu.ops.resample import systematic_positions as j_systematic_positions
from beluga_tpu_torch import convert
from beluga_tpu_torch.core.random import sample_normal_se2
from beluga_tpu_torch.filters import amcl
from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.maps.occupancy import make_grid
from beluga_tpu_torch.models.sensor.likelihood_field import LikelihoodFieldParams
from beluga_tpu_torch.node import AmclNode, pack_scan_input

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
GATE_POS, GATE_YAW = 0.9, math.radians(30.0)  # tests/test_system.py:44-45
LF = dict(max_obstacle_distance=2.0, max_laser_distance=100.0)  # nav2 defaults


@pytest.fixture(scope="module")
def world():
    """The synthetic arena (160 cells at 5 cm), one trajectory and its
    scans, and both packages' filters on it with the same field tables."""
    size, res = 160, 0.05
    data = synthetic.tracking_arena(size, res)
    xs, ys, yaws = synthetic.circle_trajectory(3, size, res)
    pts, mask = synthetic.simulate_scans(data, res, xs, ys, yaws, 60)
    jgrid = j_make_grid(data, res)
    jmodels, jctx = j_make_filter(jgrid, JLFParams(**LF), lookup_mode="codebook")
    models, _ = make_likelihood_field_filter(make_grid(data, res, device="cpu"),
                                             LikelihoodFieldParams(**LF), device="cpu")
    return dict(jmodels=jmodels, jctx=jctx, models=models,
                ctx=convert.ctx(jax.device_get(jctx)), traj=(xs, ys, yaws),
                pts=pts, mask=mask)


def reference_draws(jstate, jctx, n, m):
    """Every draw the reference's update makes from its key, as the port's
    ``UpdateDraws``."""
    _, k_prop, k_res, k_rand, k_mask = jax.random.split(jstate.key, 5)
    grid = jctx["grid"]
    randoms = j_sample_free_cells(k_rand, m, grid.free_xy, grid.num_free)

    def t(a):
        return torch.as_tensor(np.array(a))

    return amcl.UpdateDraws(
        motion_normals=t(jax.random.normal(k_prop, (3, n), jnp.float32)),
        positions=t(j_systematic_positions(k_res, m)),
        inject_uniform=t(jax.random.uniform(k_mask, (m,), jnp.float32)),
        random_states=convert.se2(jax.device_get(randoms)),
    )


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("inject", [False, True])
def test_one_update_matches_reference(world, adaptive, inject):
    n = 1500
    kw = dict(max_particles=n, min_particles=n // 4 if adaptive else n,
              resampling="systematic")
    jparams, params = j_amcl.AmclParams(**kw), amcl.AmclParams(**kw)
    xs, ys, yaws = world["traj"]
    k_init, k_state = jax.random.split(jax.random.PRNGKey(3))
    start = JSE2.from_xytheta(float(xs[0]), float(ys[0]), float(yaws[0]))
    # a tight cloud, so that adaptive KLD keeps fewer than max particles
    jstates = j_sample_normal_se2(k_init, n, start, jnp.diag(jnp.asarray([0.01, 0.01, 0.005])))
    jstate = j_amcl.init_state(k_state, jstates, jparams)
    if inject:  # a recovery probability of ~0.8: most slots take a random state
        jstate = jstate._replace(thrun=JThrunState(
            JExpFilterState(jnp.float32(0.01), jnp.asarray(True)),
            JExpFilterState(jnp.float32(0.002), jnp.asarray(True))))
    jstep = jax.jit(lambda s, o, p, m: j_amcl.update(jparams, world["jmodels"],
                                                     world["jctx"], s, o, p, m))
    for t in range(2):  # the forced first update, then a gated-in move
        odom = (float(xs[t]), float(ys[t]), float(yaws[t]))
        pts, mask = world["pts"][t], world["mask"][t]
        state = convert.amcl_state(jax.device_get(jstate), torch.Generator())
        draws = reference_draws(jstate, world["jctx"], n, n)
        jstate, jest = jstep(jstate, JSE2.from_xytheta(*odom), jnp.asarray(pts),
                             jnp.asarray(mask))
        state, est = amcl.update(params, world["models"], world["ctx"], state,
                                 amcl.host_pose(*odom), torch.as_tensor(pts),
                                 torch.as_tensor(mask), draws=draws)
        ref = jax.device_get(jstate)
        assert est.valid and bool(jest.valid)
        xy, z = state.particles.state.xy.numpy(), state.particles.state.rot.z.numpy()
        jxy, jz = np.asarray(ref.particles.state.xy), np.asarray(ref.particles.state.rot.z)
        other = (np.abs(xy - jxy).max(1) > 1e-5) | (np.abs(z - jz).max(1) > 1e-5)
        assert other.sum() <= n // 200, f"{other.sum()} slots hold another donor"
        active, j_active = int(state.particles.active), int(ref.particles.active)
        assert abs(active - j_active) <= (n // 100 if other.any() else 0)
        if adaptive and not inject:
            assert active < n
        np.testing.assert_allclose(xy[~other], jxy[~other], rtol=0, atol=1e-5)
        np.testing.assert_allclose(z[~other], jz[~other], rtol=0, atol=1e-5)
        mask = np.arange(n) < min(active, j_active)
        np.testing.assert_array_equal(state.particles.log_weight.numpy()[mask],
                                      np.asarray(ref.particles.log_weight)[mask])
        for got, want in ((state.thrun.slow, ref.thrun.slow), (state.thrun.fast, ref.thrun.fast)):
            np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value), rtol=1e-6)
        assert state.resample_count == int(ref.resample_count)
        assert not state.force_update and not bool(ref.force_update)
        # a slot that holds another donor moves the mean by its offset / n
        d = np.abs(np.concatenate([xy - jxy, z - jz], 1)).max(1)[other]
        moved = float(d.sum()) / n
        np.testing.assert_allclose(est.pose.xy.numpy(), np.asarray(jest.pose.xy),
                                   atol=1e-4 + moved)
        np.testing.assert_allclose(est.pose.rot.z.numpy(), np.asarray(jest.pose.rot.z),
                                   atol=1e-4 + moved)
        np.testing.assert_allclose(est.covariance.numpy(), np.asarray(jest.covariance),
                                   rtol=1e-3, atol=1e-5 + 2 * float((d * (d + 1.0)).sum()) / n)
        jstate = ref


def test_motion_gate_matches_reference(world):
    """A move right below ``update_min_d`` is gated out by both, with the
    estimate of the skip branch; a move above it passes."""
    params = amcl.AmclParams(max_particles=200, min_particles=200)
    gen = torch.Generator().manual_seed(0)
    states = sample_normal_se2(gen, 200, amcl.host_pose(2.0, 2.0, 0.0), np.eye(3) * 0.01)
    state = amcl.init_state(gen, states, params, device="cpu")
    pts, mask = torch.as_tensor(world["pts"][0]), torch.as_tensor(world["mask"][0])
    state, est = amcl.update(params, world["models"], world["ctx"], state,
                             amcl.host_pose(0.0, 0.0, 0.0), pts, mask)
    assert est.valid
    for d, valid in ((0.2499, False), (0.2501, True)):
        delta = amcl.se2_motion_delta(amcl.host_pose(0.0, 0.0, 0.0), amcl.host_pose(d, 0, 0))
        jdelta = j_amcl.se2_motion_delta(JSE2.from_xytheta(0.0, 0.0, 0.0),
                                         JSE2.from_xytheta(d, 0.0, 0.0))
        assert float(delta[0]) == float(jdelta[0])
        _, est = amcl.update(params, world["models"], world["ctx"], state,
                             amcl.host_pose(d, 0.0, 0.0), pts, mask)
        assert est.valid is valid


def test_node_tracks_synthetic_arena_on_cpu():
    """AmclNode at nav2 defaults (2000 particles, KLD down to 500, cluster
    estimate) tracks the arena's circle within the system-test gate."""
    res, scans = 0.05, 16
    data = synthetic.tracking_arena(384, res)
    xs, ys, yaws = synthetic.circle_trajectory(scans, 384, res)
    pts, mask = synthetic.simulate_scans(data, res, xs, ys, yaws, 60)
    cfg = AmclNodeConfig(set_initial_pose=True, initial_pose_x=float(xs[0]),
                         initial_pose_y=float(ys[0]), initial_pose_yaw=float(yaws[0]),
                         initial_pose_covariance_yaw=0.068)
    node = AmclNode(cfg, seed=0, device="cpu")
    node.set_map(make_grid(data, res, device="cpu"))
    valid = 0
    for t in range(scans):
        r = node.handle_scan((xs[t], ys[t], yaws[t]), pts[t], mask[t])
        assert r.valid
        valid += 1
        err_yaw = abs(math.atan2(math.sin(r.pose[2] - yaws[t]), math.cos(r.pose[2] - yaws[t])))
        assert math.hypot(r.pose[0] - xs[t], r.pose[1] - ys[t]) < GATE_POS, t
        assert err_yaw < GATE_YAW, t
    assert valid == scans
    assert int(node._state.particles.active) < 2000  # KLD shrank the filter


# -- package rules ---------------------------------------------------------------


def port_sources():
    files = sorted((REPO / "beluga_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    return files


def imported_names(nodes):
    for node in nodes:
        if isinstance(node, ast.Import):
            yield node, [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, [node.module]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """An AST walk of every module of the port and of chip_smoke.py: no
    import of jax or beluga_tpu anywhere, and yaml only inside functions."""
    for path in port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node, names in imported_names(ast.walk(tree)):
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "beluga_tpu"), (
                    f"{path.relative_to(REPO)}:{node.lineno} imports {name}")
        for node, names in imported_names(tree.body):
            assert "yaml" not in [n.split(".")[0] for n in names], (
                f"{path.relative_to(REPO)}:{node.lineno} imports yaml at module level")


def test_port_imports_without_jax_cuda_or_triton():
    """Importing every module of the port loads neither JAX, the JAX
    package, triton nor yaml, and needs no GPU or nvcc."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "beluga_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = [m for m in ('jax', 'beluga_tpu', 'triton', 'yaml') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        AmclNode()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_grid(np.zeros((4, 4), np.int8), 0.1)
    grid = make_grid(np.zeros((4, 4), np.int8), 0.1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_likelihood_field_filter(grid)
    params = amcl.AmclParams(max_particles=4, min_particles=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        amcl.init_state(0, amcl.host_pose(0, 0, 0), params)


@pytest.mark.parametrize("points", [np.zeros((10, 3)), np.zeros(20), np.zeros((2, 5, 2))])
def test_pack_scan_input_rejects_points_not_p_by_2(points):
    """The reference leaves the shape unchecked (node.py:62): a [P, 3]
    cloud would be re-partitioned into wrong points and mask."""
    with pytest.raises(ValueError, match=r"\[P, 2\]"):
        pack_scan_input((0.0, 0.0, 0.0), points)


def test_pack_scan_input_layout_and_mask_check():
    pts = np.arange(8, dtype=np.float32).reshape(4, 2)
    packed = pack_scan_input((1.0, 2.0, 0.5), pts, [True, False, True, True])
    np.testing.assert_array_equal(packed, [1, 2, 0.5, 0, 1, 2, 3, 4, 5, 6, 7, 1, 0, 1, 1])
    with pytest.raises(ValueError, match="point_mask"):
        pack_scan_input((0.0, 0.0, 0.0), pts, [True, False])
