"""The PyTorch port's node configuration, lifecycle and AmclNode behaviour
on the CPU: the behaviours of tests/test_config_and_node.py that need no
map from outside the repository, with the JAX package's config as the
reference for the parameter mappings."""

import dataclasses

import numpy as np
import pytest
import torch

from beluga_tpu.io.config import AmclNodeConfig as JAmclNodeConfig
from beluga_tpu_torch.io.config import AmclNodeConfig, load_config
from beluga_tpu_torch.lifecycle import LifecycleError, LifecycleState
from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, make_grid
from beluga_tpu_torch.node import AmclNode

torch.set_num_threads(1)


def small_world():
    data = np.zeros((80, 80), np.int8)
    data[0, :] = data[-1, :] = OCCUPIED_VALUE
    data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[30:40, 30:40] = OCCUPIED_VALUE
    return make_grid(data, 0.1, device="cpu")


def scan_toward_wall(n=30):
    return np.random.default_rng(0).uniform(0.5, 2.0, (n, 2)).astype(np.float32)


def make_node(**kw):
    cfg = AmclNodeConfig(max_particles=300, min_particles=50, set_initial_pose=True,
                         initial_pose_x=2.0, initial_pose_y=2.0, **kw)
    node = AmclNode(cfg, device="cpu")
    node.set_map(small_world())
    return node


# -- configuration ----------------------------------------------------------------


def test_config_fields_and_mappings_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(AmclNodeConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JAmclNodeConfig)}
    assert ours == theirs
    cfg, jcfg = AmclNodeConfig(min_particles=100, pf_err=0.02), JAmclNodeConfig(
        min_particles=100, pf_err=0.02)
    assert dataclasses.asdict(cfg.amcl_params()) == dataclasses.asdict(jcfg.amcl_params())
    assert dataclasses.asdict(cfg.likelihood_field_params()) == dataclasses.asdict(
        jcfg.likelihood_field_params())
    assert dataclasses.asdict(cfg.motion_params()) == dataclasses.asdict(jcfg.motion_params())
    np.testing.assert_array_equal(cfg.initial_pose_covariance(), jcfg.initial_pose_covariance())


@pytest.mark.parametrize("field,value", [
    ("min_particles", -1), ("max_particles", 0), ("pf_err", -0.1),
    ("resample_interval", 0), ("sigma_hit", 0.0), ("robot_model_type", "not_a_model"),
    ("laser_model_type", "sonar"), ("execution_policy", "gpu"),
])
def test_invalid_values_rejected(field, value):
    with pytest.raises(ValueError):
        AmclNodeConfig(**{field: value})


def test_min_greater_than_max_rejected():
    with pytest.raises(ValueError):
        AmclNodeConfig(min_particles=3000, max_particles=2000)


def test_load_config_yaml(tmp_path):
    path = tmp_path / "amcl.yaml"
    path.write_text("amcl:\n  ros__parameters:\n    max_particles: 1000\n"
                    "    min_particles: 200\n    alpha1: 0.3\n    unknown_key: 1\n")
    cfg = load_config(str(path))
    assert (cfg.max_particles, cfg.min_particles, cfg.alpha1) == (1000, 200, 0.3)


@pytest.mark.parametrize("kw,match", [
    (dict(laser_model_type="likelihood_field_prob"), "laser_model_type"),
    (dict(laser_model_type="likelihood_field_prob", beam_fast_path="sphere_trace"),
     "laser_model_type"),
])
def test_models_not_ported_raise(kw, match):
    """The probability model waits for ROADMAP A11 (the beam model is
    ported: tests/test_torch_beam_filter.py), whatever the beam knob says."""
    with pytest.raises(NotImplementedError, match=match) as err:
        AmclNode(AmclNodeConfig(**kw), device="cpu")
    assert "A11" in str(err.value)


def test_other_motion_models_raise():
    with pytest.raises(NotImplementedError, match="motion model"):
        AmclNodeConfig(robot_model_type="nav2_amcl::OmniMotionModel").motion_params()


# -- node behaviour -----------------------------------------------------------------


def test_initializes_from_config_pose():
    xyt, w = make_node().particle_cloud()
    assert len(xyt) == 300 and len(w) == 300
    assert abs(np.mean(xyt[:, 0]) - 2.0) < 0.3


def test_scan_produces_estimate_and_tf():
    node = make_node()
    res = node.handle_scan((0.0, 0.0, 0.0), scan_toward_wall())
    assert res.valid and np.isfinite(res.pose).all() and res.latency_s > 0
    mx, my, myaw = res.map_to_odom  # map->odom with an identity odom pose
    np.testing.assert_allclose([mx, my], res.pose[:2], atol=1e-5)


def test_motion_gating_and_nomotion_update():
    node = make_node()
    assert node.handle_scan((0.0, 0.0, 0.0), scan_toward_wall()).valid
    assert not node.handle_scan((0.01, 0.0, 0.0), scan_toward_wall()).valid
    node.request_nomotion_update()
    assert node.handle_scan((0.01, 0.0, 0.0), scan_toward_wall()).valid


def test_global_localization_spreads_particles():
    node = make_node()
    node.global_localization()
    xyt, _ = node.particle_cloud()
    assert xyt[:, 0].std() > 1.0


def test_map_hot_swap_keeps_estimate():
    node = make_node()
    assert node.handle_scan((0.0, 0.0, 0.0), scan_toward_wall()).valid
    before = node.last_known_estimate[0].copy()
    node.set_map(small_world())
    xyt, _ = node.particle_cloud()
    assert abs(np.mean(xyt[:, 0]) - before[0]) < 0.5


def test_first_map_only_ignores_later_maps():
    node = make_node(first_map_only=True)
    grid = node._grid
    node.set_map(small_world())
    assert node._grid is grid


# -- lifecycle ------------------------------------------------------------------------


def test_transition_ordering():
    node = AmclNode(AmclNodeConfig(max_particles=128, min_particles=32), device="cpu",
                    autostart=False)
    assert node.lifecycle_state is LifecycleState.UNCONFIGURED
    with pytest.raises(LifecycleError):
        node.activate()
    node.configure()
    with pytest.raises(LifecycleError):
        node.configure()
    node.activate()
    assert node.is_active
    node.deactivate()
    node.cleanup()
    node.configure()
    node.shutdown()
    assert node.lifecycle_state is LifecycleState.FINALIZED
    assert node.transition_log == ["configure", "activate", "deactivate", "cleanup",
                                   "configure", "shutdown"]


def test_inactive_drops_scans():
    node = make_node()
    node.deactivate()
    res = node.handle_scan((2.0, 2.0, 0.0), scan_toward_wall())
    assert not res.valid and node.dropped_scans == 1
    node.activate()
    assert node.handle_scan((2.0, 2.0, 0.0), scan_toward_wall()).valid


def test_cleanup_retains_estimate():
    node = make_node()
    assert node.handle_scan((2.0, 2.0, 0.0), scan_toward_wall()).valid
    far = np.array([6.2, 1.1, 0.4])
    node.last_known_estimate = (far, np.eye(3) * 0.01)
    node.deactivate()
    node.cleanup()
    assert node._state is None and node.last_known_estimate is not None
    node.configure()
    node.activate()
    node.set_map(small_world())
    xyt, _ = node.particle_cloud()
    assert abs(np.mean(xyt[:, 0]) - far[0]) < 0.3
    assert abs(np.mean(xyt[:, 1]) - far[1]) < 0.3


def test_periodic_viz_timer():
    node = make_node()
    assert node.latest_viz is None
    assert node.tick(now=10.0) == 0
    assert node.tick(now=10.3) == 1
    poses, weights = node.latest_viz
    assert len(poses) == len(weights) > 0
    node.deactivate()
    assert node.tick(now=11.0) == 0
