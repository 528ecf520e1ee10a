"""The port's omnidirectional and stationary motion models against the
JAX package's, given the reference's own ``jax.random.normal`` draws, and
both through the builder, the config and the node on the CPU.

Tolerance 1e-6 absolute on poses: the same float32 operations in the same
order, within XLA's fused multiply-adds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.models.motion import omnidirectional as j_omni
from beluga_tpu.models.motion import stationary as j_stat
from beluga_tpu_torch.filters.builders import make_likelihood_field_filter, make_motion_fn
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, make_grid
from beluga_tpu_torch.models.motion.omnidirectional import (
    OmnidirectionalDriveParams,
    omni_drive_propagate,
)
from beluga_tpu_torch.models.motion.stationary import stationary_propagate
from beluga_tpu_torch.node import AmclNode

torch.set_num_threads(1)

ATOL = 1e-6
N = 500

# (previous pose, pose): a strafe, a diagonal move with a turn, a move below
# the distance threshold, a turn in place, a move backwards past pi
MOTIONS = [
    ((1.0, 2.0, 0.3), (1.0, 2.5, 0.3)),
    ((0.0, 0.0, 0.0), (0.4, -0.3, 0.5)),
    ((2.0, 1.0, -1.0), (2.004, 1.003, -0.9)),
    ((2.0, 1.0, 3.0), (2.0, 1.0, -3.0)),
    ((0.5, 0.5, 1.2), (0.2, 0.1, -2.9)),
]


def cloud(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(1.0, 0.5, n).astype(np.float32), rng.normal(2.0, 0.5, n).astype(np.float32),
            rng.uniform(-np.pi, np.pi, n).astype(np.float32)]


def pair(xyt):
    return JSE2.from_xytheta(*map(jnp.asarray, xyt)), SE2.from_xytheta(*xyt)


def host_pair(p):
    return JSE2.from_xytheta(*p), SE2.from_xytheta(*p, device="cpu")


def close(got: SE2, want: JSE2):
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(want.xy), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.rot.z.numpy(), np.asarray(want.rot.z), rtol=0, atol=ATOL)


@pytest.mark.parametrize("motion", range(len(MOTIONS)))
def test_omni_against_reference_draws(motion):
    params = OmnidirectionalDriveParams(0.1, 0.05, 0.1, 0.05, 0.3)
    jparams = j_omni.OmnidirectionalDriveParams(0.1, 0.05, 0.1, 0.05, 0.3)
    jst, st = pair(cloud(N, motion))
    jprev, prev = host_pair(MOTIONS[motion][0])
    jpose, pose = host_pair(MOTIONS[motion][1])
    key = jax.random.PRNGKey(motion)
    want = j_omni.omni_drive_propagate(jparams, key, jst, jpose, jprev)
    z = torch.as_tensor(np.asarray(jax.random.normal(key, (3, N), jnp.float32)))
    close(omni_drive_propagate(params, z, st, pose, prev), want)


def test_omni_strafe_moves_sideways():
    """A pure strafe of 0.5 m to the robot's left with no noise moves every
    particle 0.5 m along its own left: the reference's sign of the strafe
    draw and its rotation of (trans, -strafe) by the first rotation."""
    params = OmnidirectionalDriveParams(0.0, 0.0, 0.0, 0.0, 0.0)
    _, st = pair(cloud(64, 9))
    prev = SE2.from_xytheta(1.0, 2.0, 0.0, device="cpu")
    pose = SE2.from_xytheta(1.0, 2.5, 0.0, device="cpu")
    out = omni_drive_propagate(params, torch.zeros(3, 64), st, pose, prev)
    d = out.xy - st.xy
    left = torch.stack([-st.rot.sin, st.rot.cos], -1)
    np.testing.assert_allclose(d.numpy(), 0.5 * left.numpy(), atol=1e-6)
    np.testing.assert_allclose(out.rot.z.numpy(), st.rot.z.numpy(), atol=1e-6)


def test_stationary_against_reference_draws():
    jst, st = pair(cloud(N, 3))
    key = jax.random.PRNGKey(5)
    want = j_stat.stationary_propagate(key, jst)
    z = torch.as_tensor(np.asarray(jax.random.normal(key, (3, N), jnp.float32)))
    close(stationary_propagate(z, st), want)


def test_fleet_axes_match_each_filter():
    """Batched states ``[B, N]`` with one pose pair per filter ``[B]`` give
    each filter's single-filter result, for both models."""
    b = 3
    params = OmnidirectionalDriveParams()
    jparams = j_omni.OmnidirectionalDriveParams()
    xyt = [np.stack(v) for v in zip(*(cloud(N, 10 + i) for i in range(b)))]
    st = SE2.from_xytheta(*map(torch.as_tensor, xyt))
    prevs = [MOTIONS[i][0] for i in range(b)]
    poses = [MOTIONS[i][1] for i in range(b)]
    prev = SE2.from_xytheta(*map(torch.tensor, zip(*prevs)))
    pose = SE2.from_xytheta(*map(torch.tensor, zip(*poses)))
    keys = [jax.random.PRNGKey(20 + i) for i in range(b)]
    z = torch.as_tensor(np.stack([np.asarray(jax.random.normal(k, (3, N), jnp.float32))
                                  for k in keys]))
    got = omni_drive_propagate(params, z, st, pose, prev)
    still = stationary_propagate(z, st)
    for i in range(b):
        jst = JSE2.from_xytheta(*(jnp.asarray(v[i]) for v in xyt))
        want = j_omni.omni_drive_propagate(jparams, keys[i], jst, JSE2.from_xytheta(*poses[i]),
                                           JSE2.from_xytheta(*prevs[i]))
        close(SE2(got.xy[i], type(got.rot)(got.rot.z[i])), want)
        want = j_stat.stationary_propagate(keys[i], jst)
        close(SE2(still.xy[i], type(still.rot)(still.rot.z[i])), want)


def small_grid():
    data = np.zeros((60, 60), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[20:28, 30:36] = OCCUPIED_VALUE
    return make_grid(data, 0.1, device="cpu")


@pytest.mark.parametrize("model", ["omni", "stationary"])
def test_builder_takes_the_model(model):
    """The filter's ``propagate`` is the model's, on the builder's table."""
    motion = OmnidirectionalDriveParams(0.2, 0.1, 0.2, 0.1, 0.4) if model == "omni" \
        else "stationary"
    models, _ = make_likelihood_field_filter(small_grid(), motion_params=motion, device="cpu")
    _, st = pair(cloud(N, 7))
    z = torch.as_tensor(np.random.default_rng(7).standard_normal((3, N)), dtype=torch.float32)
    prev = SE2.from_xytheta(1.0, 1.0, 0.2, device="cpu")
    pose = SE2.from_xytheta(1.3, 1.4, 0.6, device="cpu")
    got = models.propagate({}, z, st, pose, prev)
    if model == "omni":
        want = omni_drive_propagate(motion, z, st, pose, prev)
    else:
        want = stationary_propagate(z, st)
    assert torch.equal(got.xy, want.xy) and torch.equal(got.rot.z, want.rot.z)
    assert make_motion_fn(motion) is not None


def node(robot_model_type, **kw):
    cfg = AmclNodeConfig(robot_model_type=robot_model_type, max_particles=300,
                         min_particles=100, set_initial_pose=True, initial_pose_x=2.0,
                         initial_pose_y=2.0, **kw)
    n = AmclNode(cfg, device="cpu", seed=3)
    n.set_map(small_grid())
    return n


def scan():
    ang = np.linspace(-np.pi, np.pi, 40, endpoint=False)
    return np.stack([1.5 * np.cos(ang), 1.5 * np.sin(ang)], -1).astype(np.float32)


def test_omni_node_strafes():
    """The node from an omni robot's nav2 configuration runs, and a strafe
    of the odometry moves its particles sideways."""
    n = node("nav2_amcl::OmniMotionModel")
    assert n.handle_scan((0.0, 0.0, 0.0), scan()).valid
    before = n.particle_cloud()[0][:, 1].mean()
    r = n.handle_scan((0.0, 0.4, 0.0), scan())  # 0.4 m to the left, heading kept
    assert r.valid and np.isfinite(r.pose).all()
    assert n.particle_cloud()[0][:, 1].mean() > before + 0.2


def test_stationary_node_forced_updates():
    """A stationary robot updates only when forced; the forced updates keep
    the cloud where it was, with the jitter of the model."""
    n = node("stationary")
    assert n.handle_scan((0.0, 0.0, 0.0), scan()).valid
    x0 = n.particle_cloud()[0][:, :2].mean(0)
    assert not n.handle_scan((0.0, 0.0, 0.0), scan()).valid
    for _ in range(3):
        n.request_nomotion_update()
        r = n.handle_scan((0.0, 0.0, 0.0), scan())
        assert r.valid and np.isfinite(r.pose).all()
    assert np.abs(n.particle_cloud()[0][:, :2].mean(0) - x0).max() < 0.3
