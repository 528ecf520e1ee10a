"""The port's fleet on a ``("dp", "tp")`` mesh (``parallel/fleet.py``), the
weak-scaling sweep and the pod run (``parallel/scaling.py``,
``parallel/multihost.py``) and the sharded checkpoints
(``utils/checkpoint.py``) on gloo CPU ranks.

Ports of ``tests/test_parallel.py:81-130`` (every estimate valid and each
rank's block ``[B / 2, N / 2]`` on a (2, 2) mesh; sharded against the dense
fleet on the same draws within ``atol=2e-4``, the JAX test's own
tolerance; bit-equal at (1, 1)), ``tests/test_scaling.py``,
``tests/test_mega.py:113-125`` and ``tests/test_checkpoint_and_tutorial.py:
78-112`` (a save on the 4 ranks of a (2, 2) mesh loads bit-equal on the
same mesh, generators included; loaded on 2 ranks, each block equals its
slice of the whole).  Each world size spawns its ranks once for the module;
a rank imports only torch and the port.

The sharded fleet is compared on the same draws with systematic resampling
and adaptive KLD, and with multinomial resampling at a fixed count: with
adaptive KLD, multinomial's slots are interleaved a rank at a time, so its
KLD prefix holds other particles than the dense fleet's.
"""

import json

import numpy as np
import pytest
import torch

from beluga_tpu_torch.parallel.multihost import spawn_ranks

SPAWN_TIMEOUT = 60.0
BATCH, N, BEAMS = 4, 64, 20
FLEET_CASES = (dict(max_particles=N, min_particles=16, resampling="systematic"),
               dict(max_particles=N, min_particles=N, resampling="multinomial"))


def small_world():
    """``tests/test_parallel.py:small_world``: ``(models, ctx)`` on the CPU."""
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, make_grid

    data = np.zeros((60, 60), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[25:30, 25:30] = OCCUPIED_VALUE
    return make_likelihood_field_filter(make_grid(data, 0.1, device="cpu"), device="cpu")


def fleet_state(params, batch=BATCH, seed=0):
    from beluga_tpu_torch.filters.amcl import host_pose, init_fleet_state

    gen = torch.Generator()
    gen.manual_seed(seed)
    return init_fleet_state(gen, batch, host_pose(3.0, 3.0, 0.0), np.eye(3) * 0.2, params,
                            device="cpu")


def fake_scan(batch=BATCH):
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-1.5, 1.5, (batch, BEAMS, 2)), dtype=torch.float32)
    return pts, torch.ones((batch, BEAMS), dtype=torch.bool)


def odometry(batch, x=0.0):
    from beluga_tpu_torch.lie import SE2

    return SE2.from_xytheta(np.full(batch, x), np.zeros(batch), np.zeros(batch), device="cpu")


def dense_draws(params, models, ctx, state, seed):
    from beluga_tpu_torch.filters.amcl import draw_update

    gen = torch.Generator()
    gen.manual_seed(seed)
    draws = draw_update(params, models, ctx, state.particles, gen)
    return draws._replace(inject_uniform=torch.ones_like(draws.inject_uniform))


def leaves_equal(a, b) -> bool:
    """Every leaf of two state trees bit-equal, generators by their state."""
    from beluga_tpu_torch.utils.checkpoint import _leaves

    la, lb = [], []
    _leaves(a, la)
    _leaves(b, lb)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if not np.array_equal(np.asarray(x), np.asarray(y)) or type(x) is not type(y):
            return False
    return True


# -- the ranks -----------------------------------------------------------------


def _gather_filters(x, mesh):
    """``x`` ``[B_local, ...]`` of every ``dp`` rank, ``[B, ...]``."""
    from beluga_tpu_torch.parallel.collectives import all_gather_last

    return all_gather_last(x.movedim(0, -1), mesh.get_group("dp")).movedim(-1, 0)


def _fleet_on_mesh(mesh, pts, mask):
    """One step of the sharded fleet (``tests/test_parallel.py:81-107``)."""
    from beluga_tpu_torch.filters.amcl import AmclParams
    from beluga_tpu_torch.parallel.fleet import make_fleet_update, replicate, shard_fleet

    params = AmclParams(max_particles=128, min_particles=32)
    models, ctx = small_world()
    state = shard_fleet(mesh, fleet_state(params, batch=2))
    at, b = mesh.get_local_rank("dp"), 1
    state, est = make_fleet_update(params, models, mesh)(
        replicate(mesh, ctx), state, odometry(b), pts[at:at + b].contiguous(),
        mask[at:at + b].contiguous())
    return dict(valid=bool(np.all(est.valid)),
                finite=bool(torch.isfinite(est.pose.xy).all()),
                block=tuple(state.particles.log_weight.shape))


def _fleet_same_draws(mesh, pts, mask, draws_by_case):
    from beluga_tpu_torch.filters.amcl import AmclParams
    from beluga_tpu_torch.parallel.fleet import make_fleet_update, replicate, shard_fleet
    from beluga_tpu_torch.parallel.mega import all_gather_states, shard_draws
    from beluga_tpu_torch.parallel.placement import axis_size

    models, ctx = small_world()
    ctx = replicate(mesh, ctx)
    dp = axis_size(mesh, "dp")
    b, at = BATCH // dp, mesh.get_local_rank("dp")
    out = []
    for kw, draws in zip(FLEET_CASES, draws_by_case):
        params = AmclParams(**kw)
        state = shard_fleet(mesh, fleet_state(params))
        state, est = make_fleet_update(params, models, mesh)(
            ctx, state, odometry(b, 0.1), pts[at * b:(at + 1) * b].contiguous(),
            mask[at * b:(at + 1) * b].contiguous(), draws=shard_draws(draws, params, mesh))
        s = all_gather_states(state.particles.state, mesh.get_group("tp"), batch_dims=1)
        out.append(dict(est=_gather_filters(est.pose.as_xytheta(), mesh).numpy(),
                        xy=_gather_filters(s.xy, mesh).numpy(),
                        active=_gather_filters(state.particles.active, mesh).numpy()))
    return out


def _scaling():
    from beluga_tpu_torch.filters.amcl import AmclParams
    from beluga_tpu_torch.parallel.scaling import measure_fleet_scaling

    models, ctx = small_world()
    return measure_fleet_scaling(models, ctx, AmclParams(max_particles=64, min_particles=16),
                                 filters_per_device=2, num_beams=10, iters=2,
                                 device_counts=[1, 2, 4])


def _checkpoints(mesh, path):
    """Save and load a fleet on ``mesh`` and a mega filter on the 4 ranks
    along ``tp``; whether each came back bit-equal, and whether the next
    update from the restored mega state equals the one from the saved."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from beluga_tpu_torch.filters.amcl import AmclParams
    from beluga_tpu_torch.parallel.collectives import all_gather_last
    from beluga_tpu_torch.parallel.fleet import shard_fleet
    from beluga_tpu_torch.parallel.mega import make_mega_update, shard_mega_state
    from beluga_tpu_torch.utils.checkpoint import load_state_sharded, save_state_sharded

    params = AmclParams(max_particles=N, min_particles=16)
    fleet = shard_fleet(mesh, fleet_state(params))
    save_state_sharded(f"{path}/fleet", fleet, mesh)
    restored = load_state_sharded(f"{path}/fleet", shard_fleet(mesh, fleet_state(params, seed=9)),
                                  mesh)

    line = init_device_mesh("cpu", (4,), mesh_dim_names=("tp",))
    models, ctx = small_world()
    pts, mask = fake_scan(1)
    update = make_mega_update(params, models, line)
    mega, _ = update(ctx, shard_mega_state(line, fleet_state(params, batch=1, seed=3)),
                     odometry(1, 0.2), pts, mask)
    save_state_sharded(f"{path}/mega", mega, line)
    back = load_state_sharded(f"{path}/mega", shard_mega_state(line, fleet_state(params, 1, 4)),
                              line)
    same_mega = leaves_equal(mega, back)
    nxt, _ = update(ctx, mega._replace(force_update=np.ones(1, bool)), odometry(1, 0.4), pts,
                    mask)
    nxt_back, _ = update(ctx, back._replace(force_update=np.ones(1, bool)), odometry(1, 0.4),
                         pts, mask)
    flags = torch.tensor([leaves_equal(fleet, restored), same_mega,
                          leaves_equal(nxt, nxt_back)], dtype=torch.int32)
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    lw = all_gather_last(nxt.particles.log_weight, line.get_group("tp"))
    return dict(fleet=bool(flags[0]), mega=bool(flags[1]), next_update=bool(flags[2]),
                next_finite=bool(torch.isfinite(lw).all()))


def _reshard(mesh, path):
    """Load the 4-rank fleet checkpoint on this 2-rank mesh: whether each
    rank's block equals its slice of the whole."""
    import torch.distributed as dist

    from beluga_tpu_torch.filters.amcl import AmclParams
    from beluga_tpu_torch.parallel.fleet import fleet_state_sharding, shard_fleet
    from beluga_tpu_torch.parallel.placement import place
    from beluga_tpu_torch.utils.checkpoint import load_state_sharded

    params = AmclParams(max_particles=N, min_particles=16)
    whole = fleet_state(params)
    loaded = load_state_sharded(f"{path}/fleet", shard_fleet(mesh, fleet_state(params, seed=9)),
                                mesh)
    want = place(whole, fleet_state_sharding(mesh, whole), mesh)
    ok = torch.tensor([leaves_equal(loaded._replace(generator=None),
                                    want._replace(generator=None))], dtype=torch.int32)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return dict(block=tuple(loaded.particles.log_weight.shape), equal=bool(ok))


def _sharded_ranks(rank, world, device, draws_by_case, path):
    from torch.distributed.device_mesh import init_device_mesh

    from beluga_tpu_torch.parallel.multihost import build_pod_mesh

    pts, mask = fake_scan()
    if world == 1:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "tp"))
        return dict(same_draws=_fleet_same_draws(mesh, pts, mask, draws_by_case))
    if world == 2:
        return dict(reshard=_reshard(init_device_mesh("cpu", (1, 2), mesh_dim_names=("dp", "tp")),
                                     path))
    mesh = build_pod_mesh(num_hosts=2)
    return dict(pod_mesh=tuple(mesh.shape), on_mesh=_fleet_on_mesh(mesh, *fake_scan(2)),
                same_draws=_fleet_same_draws(mesh, pts, mask, draws_by_case),
                scaling=_scaling(), checkpoints=_checkpoints(mesh, path))


# -- this process --------------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    """The dense fleet's first update of each case, on draws from a seed
    (no injection)."""
    from beluga_tpu_torch.filters.amcl import AmclParams, update

    models, ctx = small_world()
    pts, mask = fake_scan()
    out = []
    for i, kw in enumerate(FLEET_CASES):
        params = AmclParams(**kw)
        state = fleet_state(params)
        draws = dense_draws(params, models, ctx, state, 50 + i)
        new, est = update(params, models, ctx, state, odometry(BATCH, 0.1), pts, mask, draws)
        out.append(dict(draws=draws, est=est.pose.as_xytheta().numpy(),
                        xy=new.particles.state.xy.numpy(), active=new.particles.active.numpy()))
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_ckpt"))


def _spawn(world, dense, path):
    return spawn_ranks(_sharded_ranks, world, "cpu", ([d["draws"] for d in dense], path),
                       timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def world1(dense, ckpt_dir):
    return _spawn(1, dense, ckpt_dir)


@pytest.fixture(scope="module")
def world4(dense, ckpt_dir):
    return _spawn(4, dense, ckpt_dir)


@pytest.fixture(scope="module")
def world2(world4, dense, ckpt_dir):  # loads what the 4 ranks saved
    return _spawn(2, dense, ckpt_dir)


def test_sharded_fleet_on_mesh(world4):
    r = world4["on_mesh"]
    assert r["valid"] and r["finite"]
    assert r["block"] == (1, 64)  # [B / 2, N / 2] of 2 x 128


@pytest.mark.parametrize("case", range(len(FLEET_CASES)),
                         ids=[kw["resampling"] for kw in FLEET_CASES])
def test_sharded_fleet_matches_dense_on_same_draws(world4, dense, case):
    got, want = world4["same_draws"][case], dense[case]
    np.testing.assert_allclose(got["est"][:, :2], want["est"][:, :2], atol=2e-4)
    np.testing.assert_array_equal(got["active"], want["active"])


@pytest.mark.parametrize("case", range(len(FLEET_CASES)),
                         ids=[kw["resampling"] for kw in FLEET_CASES])
def test_fleet_on_one_rank_is_the_dense_fleet(world1, dense, case):
    got, want = world1["same_draws"][case], dense[case]
    for key in ("est", "xy", "active"):
        np.testing.assert_array_equal(got[key], want[key])


def test_weak_scaling_rows(world4):
    rows = world4["scaling"]
    assert [r["devices"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["filters"] == 2 * r["devices"]
        assert r["filters_per_s"] > 0
    assert rows[0]["efficiency"] == 1.0


def test_pod_mesh(world4):
    assert world4["pod_mesh"] == (2, 2)


def test_multihost_main_on_simulated_devices(capsys):
    from beluga_tpu_torch.parallel.multihost import main

    main(["--simulate-devices", "2", "--particles", "64", "--beams", "8", "--grid-size", "48",
          "--filters-per-device", "2", "--timeout", str(SPAWN_TIMEOUT)])
    out = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in out if line.startswith("{")]
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["filters_per_s"] > 0 for r in rows)


def _never_run(rank, world, device):
    raise AssertionError("no rank may start")


def test_spawn_ranks_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """No device means the card: without CUDA the call raises before it
    starts a rank, and never falls back to gloo on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn_ranks(_never_run, 1, timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("what", ["fleet", "mega", "next_update", "next_finite"])
def test_sharded_checkpoint_roundtrip(world4, what):
    assert world4["checkpoints"][what]


def test_sharded_checkpoint_reshards_onto_two_ranks(world2):
    r = world2["reshard"]
    assert r["block"] == (BATCH, N // 2)
    assert r["equal"]
