"""The port's pipelined node (``AmclNode(pipelined=True)``, ``flush``) and
its staging buffers (``node.py:ScanStaging``) on the CPU.

The pipelined node runs the same updates as the synchronous one with the
same seed, so on the CPU its results are the synchronous node's bit for
bit, shifted by one scan: the first call is invalid, each later call
returns the previous scan's estimate with that scan's map→odom
correction, and ``flush`` gives the last one, then None (the behaviour of
``tests/test_config_and_node.py``'s ``TestPipelinedNode``).  Inputs come
from a numpy seed; the maps are built in memory or written to
``tmp_path``.
"""

import numpy as np
import pytest
import torch

from beluga_tpu_torch.io import synthetic
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, load_pgm_yaml, make_grid
from beluga_tpu_torch.node import EST2_LEN, AmclNode, ScanStaging

torch.set_num_threads(1)


def small_world():
    data = np.zeros((80, 80), np.int8)
    data[0, :] = data[-1, :] = OCCUPIED_VALUE
    data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[30:40, 30:40] = OCCUPIED_VALUE
    return make_grid(data, 0.1, device="cpu")


def scan_toward_wall(seed=0, n=30):
    return np.random.default_rng(seed).uniform(0.5, 2.0, (n, 2)).astype(np.float32)


def make_node(pipelined, grid=None, **kw):
    cfg = AmclNodeConfig(max_particles=300, min_particles=50, set_initial_pose=True,
                         initial_pose_x=2.0, initial_pose_y=2.0, **kw)
    node = AmclNode(cfg, seed=3, device="cpu", pipelined=pipelined)
    node.set_map(grid or small_world())
    return node


ODOMS = [(0.0, 0.0, 0.0), (0.3, 0.0, 0.05), (0.65, 0.02, 0.1), (1.0, 0.05, 0.12),
         (1.0, 0.05, 0.12), (1.4, 0.1, 0.3), (1.8, 0.2, 0.5)]


def assert_same(s, p):
    assert s.valid == p.valid
    if s.valid:
        for a in ("pose", "covariance", "map_to_odom"):
            np.testing.assert_array_equal(getattr(s, a), getattr(p, a), err_msg=a)


def test_pipelined_is_the_synchronous_node_shifted_by_one():
    """Bit-equal to the synchronous node a scan later, a gated-out scan
    (the repeated odometry) included; the first call invalid, ``flush``
    the tail, then None."""
    sync_node, pipe_node = make_node(False), make_node(True)
    sync_res = [sync_node.handle_scan(o, scan_toward_wall(i)) for i, o in enumerate(ODOMS)]
    pipe_res = [pipe_node.handle_scan(o, scan_toward_wall(i)) for i, o in enumerate(ODOMS)]
    assert not pipe_res[0].valid and pipe_res[0].pose is None
    tail = pipe_node.flush()
    for s, p in zip(sync_res, pipe_res[1:] + [tail]):
        assert_same(s, p)
    assert not sync_res[4].valid and sync_res[5].valid  # the motion gate, in both
    assert pipe_node.flush() is None
    np.testing.assert_array_equal(pipe_node.last_known_estimate[0], sync_node.last_known_estimate[0])
    for a, b in zip(pipe_node.particle_cloud(), sync_node.particle_cloud()):
        np.testing.assert_array_equal(a, b)


def test_pipelined_raw_inputs_and_a_new_capacity(tmp_path):
    """``handle_laser_scan`` and ``handle_point_cloud`` through the
    pipelined node, on a map loaded from PGM and YAML, with a cloud whose
    call sets its own capacity (the staging buffers re-size while a scan
    is in flight)."""
    data = synthetic.tracking_arena(160, 0.05, seed=2)
    grid = load_pgm_yaml(synthetic.write_map_yaml(tmp_path, data, 0.05), device="cpu")
    nodes = [make_node(p, grid, update_min_d=0.0, update_min_a=0.0) for p in (False, True)]
    for n in nodes:
        n.set_initial_pose(4.0, 4.0, 0.0)
    rng = np.random.default_rng(1)
    results = [[], []]
    for t in range(5):
        ranges = rng.uniform(0.2, 3.0, 360).astype(np.float32)
        ranges[rng.random(360) < 0.1] = np.nan
        odom = (0.05 * t, 0.0, 0.02 * t)
        angles = np.linspace(-np.pi, np.pi, 360, endpoint=False)
        cloud = np.stack([ranges * np.cos(angles), ranges * np.sin(angles),
                          np.full(360, 0.15)], -1)
        for node, out in zip(nodes, results):
            if t % 2:
                out.append(node.handle_point_cloud(odom, cloud, (0.1, 0.0, 0.0),
                                                   max_beams=90 if t == 3 else None))
            else:
                out.append(node.handle_laser_scan(odom, ranges, -np.pi, 2 * np.pi / 360,
                                                  0.12, 3.5))
    results[1] = results[1][1:] + [nodes[1].flush()]
    assert all(r.valid for r in results[0])
    for s, p in zip(*results):
        assert_same(s, p)
    assert nodes[1]._staging.length == 3 + 3 * 60  # back to the configured capacity


def test_staging_slots_alternate_and_refuse_reuse_before_the_wait():
    """Scan t takes slot t mod 2; a slot whose scan was not harvested is
    not written again (the invariant the card's buffers rely on)."""
    st = ScanStaging(9, torch.device("cpu"))
    est = torch.arange(EST2_LEN, dtype=torch.float32)
    for t in range(2):
        slot, host = st.stage(np.full(9, t, np.float32))
        assert slot == t % 2 and host is st.inputs[slot] and (host == t).all()
        st.finish(slot, est + t)
    with pytest.raises(RuntimeError, match="reused"):
        st.stage(np.zeros(9, np.float32))
    np.testing.assert_array_equal(st.harvest(0), (est + 0).numpy())
    slot, _ = st.stage(np.zeros(9, np.float32))
    assert slot == 0
    assert st.events == [None, None] and not st.inputs[0].is_pinned()


def test_cleanup_drops_the_scan_in_flight_and_inactive_scans_are_dropped():
    node = make_node(True)
    assert not node.handle_scan(ODOMS[0], scan_toward_wall()).valid
    node.deactivate()
    assert not node.handle_scan(ODOMS[1], scan_toward_wall()).valid
    assert node.dropped_scans == 1
    node.cleanup()
    assert node.flush() is None and node._staging is None
    node.configure()
    node.activate()
    node.set_map(small_world())
    assert not node.handle_scan(ODOMS[1], scan_toward_wall()).valid  # a new pipeline
    assert node.flush().valid


def test_a_capacity_change_keeps_results_exact():
    """A scan of another beam count re-sizes the input buffers; the
    results stay the synchronous node's."""
    sync_node, pipe_node = make_node(False), make_node(True)
    counts = [30, 30, 45, 12, 45]
    sync_res = [sync_node.handle_scan(o, scan_toward_wall(i, n))
                for i, (o, n) in enumerate(zip(ODOMS, counts))]
    pipe_res = [pipe_node.handle_scan(o, scan_toward_wall(i, n))
                for i, (o, n) in enumerate(zip(ODOMS, counts))]
    for s, p in zip(sync_res, pipe_res[1:] + [pipe_node.flush()]):
        assert_same(s, p)
