"""The port's particle-axis collectives (``parallel/collectives.py``) on 4
gloo CPU ranks, held against the JAX package's ``shard_map`` functions on
4 virtual devices, on the same inputs.

The ranks run in one spawned world for the whole module (a module-scoped
fixture); each rank imports only torch and the port, and the JAX side runs
in this process.  Tolerances: logsumexp, normalize, ESS and the mean
within rtol 1e-6; the CDF within 64 ulp of its total (1.0); the systematic
donors equal except where a position lies within 64 ulp of a CDF edge, and
those that differ fewer than 1 in 1000.  A fleet case (two filters a rank) checks
the leading filter axes against plain float64 numpy.
"""

import functools

import numpy as np
import pytest
import torch

from beluga_tpu_torch.parallel.multihost import spawn_ranks

N = 1024  # global particle count; 256 a rank
WORLD = 4
CDF_ULP = 64 * 2.0**-24
SPAWN_TIMEOUT = 60.0


def inputs():
    rng = np.random.default_rng(0)
    return dict(
        log_w=rng.normal(0, 2, N).astype(np.float32),
        mask=rng.random(N) < 0.8,
        w=rng.random(N).astype(np.float32),
        values=rng.normal(0, 1, (N, 3)).astype(np.float32),
        fleet_log_w=rng.normal(0, 2, (2, N)).astype(np.float32),
    )


def _ranks(rank, world, device, data, u0):
    """Each collective on this rank's slice; rank 0 returns the gathered
    results as numpy."""
    import torch.distributed as dist

    from beluga_tpu_torch.parallel import collectives as c

    group = dist.group.WORLD
    n_local = N // world
    part = slice(rank * n_local, (rank + 1) * n_local)
    log_w = torch.as_tensor(data["log_w"][part])
    mask = torch.as_tensor(data["mask"][part])
    w = torch.as_tensor(data["w"][part])
    values = torch.as_tensor(data["values"][part])
    fleet = torch.as_tensor(data["fleet_log_w"][:, part])
    local_cdf, offset = c.sharded_cdf(w, group)
    fleet_cdf, fleet_offset = c.sharded_cdf(torch.exp(fleet), group)
    gidx, shard = c.sharded_systematic_resample(torch.tensor(u0), w, group)
    out = dict(
        logsumexp=c.sharded_logsumexp(log_w, mask, group),
        normalize=c.all_gather_last(c.sharded_normalize(log_w, mask, group), group),
        ess=c.sharded_effective_sample_size(log_w, mask, group),
        cdf=c.all_gather_last(local_cdf + offset, group),
        gidx=c.all_gather_last(gidx, group),
        donor_shard=c.all_gather_last(shard, group),
        mean=c.sharded_mean(values, w, group),
        fleet_logsumexp=c.sharded_logsumexp(fleet, torch.ones_like(fleet, dtype=torch.bool),
                                            group),
        fleet_cdf=c.all_gather_last(fleet_cdf + fleet_offset[..., None], group),
    )
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's functions under ``shard_map`` on 4 devices, and its
    systematic ``u0``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from beluga_tpu.parallel import collectives as jc

    data = inputs()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("tp",))

    def smap(fn, in_specs, out_specs):
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

    log_w, mask = jnp.asarray(data["log_w"]), jnp.asarray(data["mask"])
    w, values = jnp.asarray(data["w"]), jnp.asarray(data["values"])
    key = jax.random.PRNGKey(7)

    def cdf(w):
        local, off = jc.sharded_cdf(w, "tp")
        return local + off

    def systematic(w):
        return jc.sharded_systematic_resample(key, w, "tp", num_shards=WORLD)

    out = dict(
        logsumexp=smap(functools.partial(jc.sharded_logsumexp, axis_name="tp"),
                       (P("tp"), P("tp")), P())(log_w, mask),
        normalize=smap(functools.partial(jc.sharded_normalize, axis_name="tp"),
                       (P("tp"), P("tp")), P("tp"))(log_w, mask),
        ess=smap(functools.partial(jc.sharded_effective_sample_size, axis_name="tp"),
                 (P("tp"), P("tp")), P())(log_w, mask),
        cdf=smap(cdf, (P("tp"),), P("tp"))(w),
        mean=smap(functools.partial(jc.sharded_mean, axis_name="tp"),
                  (P("tp"), P("tp")), P())(values, w),
    )
    gidx, shard = smap(systematic, (P("tp"),), (P("tp"), P("tp")))(w)
    out.update(gidx=gidx, donor_shard=shard)
    u0 = np.float32(jax.random.uniform(key, (), jnp.float32))
    return {k: np.asarray(v) for k, v in out.items()}, u0


@pytest.fixture(scope="module")
def port_side(jax_side):
    _, u0 = jax_side
    return spawn_ranks(_ranks, WORLD, "cpu", (inputs(), u0), timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("name", ["logsumexp", "normalize", "ess", "mean"])
def test_matches_jax_within_rtol(jax_side, port_side, name):
    want, got = jax_side[0][name], port_side[name]
    if name == "normalize":  # dead slots: both hold the dead log-weight
        live = inputs()["mask"]
        np.testing.assert_allclose(got[live], want[live], rtol=1e-6, atol=1e-6)
        assert np.all(got[~live] <= -1e29) and np.all(want[~live] <= -1e29)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cdf_matches_jax_within_64_ulp(jax_side, port_side):
    got, want = port_side["cdf"], jax_side[0]["cdf"]
    assert np.all(np.diff(got) >= 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=CDF_ULP * float(want[-1]))


def test_systematic_donors_match_jax(jax_side, port_side):
    want, u0 = jax_side
    w = inputs()["w"].astype(np.float64)
    cdf = np.cumsum(w) / w.sum()
    u = (np.arange(N) + np.float64(u0)) / N
    near_edge = np.min(np.abs(u[:, None] - cdf[None, :]), axis=1) <= CDF_ULP
    for key in ("gidx", "donor_shard"):
        differ = port_side[key] != want[key]
        assert not np.any(differ & ~near_edge), f"{key}: a donor differs away from an edge"
        assert differ.sum() < N / 1000, f"{key}: {differ.sum()} donors differ at an edge"


def test_fleet_axes_reduce_per_filter(port_side):
    fleet = inputs()["fleet_log_w"].astype(np.float64)
    top = fleet.max(-1, keepdims=True)
    want = (top + np.log(np.exp(fleet - top).sum(-1, keepdims=True)))[:, 0]
    np.testing.assert_allclose(port_side["fleet_logsumexp"], want, rtol=1e-6)
    w = np.exp(fleet)
    np.testing.assert_allclose(port_side["fleet_cdf"], np.cumsum(w, -1) / w.sum(-1, keepdims=True),
                               rtol=0, atol=CDF_ULP)
