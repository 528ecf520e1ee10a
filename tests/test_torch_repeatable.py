"""The port's float running sums and segment sums, which sum in a fixed
order, held against the JAX package on the CPU.

On the card the sorted positions (``ops/resample.py``: the spacings of the
sorted multinomial and residual positions), the index-form CDFs and the
sharded CDF's local sums (``parallel/collectives.py``) run B2's CDF kernel
(``ops/cuda_resample.py:running_sum`` and ``monotone_cdf``), and the NDT
measurement cells (``models/sensor/ndt.py``) sum each cell's points in
sort order through ``torch.segment_reduce``: equal inputs give equal bits
on every call (``tests/test_torch_cuda.py`` holds that on the card).  On
the CPU the wrappers run their plain versions, which must keep the bits
the port had with ``torch.cumsum`` and the parity with the JAX package it
had.

Tolerances, as the existing parity tests state them: the sorted positions
within 2e-6 relative of the reference's (its cumsums add in another
order), the CDFs' donors equal but where a position lies between the two
packages' values of one entry (fewer than 5 in 1000), the sharded CDF
within 64 ulp of its total; the ordered segment sums within 2e-5 absolute
of ``jax.ops.segment_sum`` (sums of ~7 values near 3), their counts
exact; the NDT cells' counts and masks exact, their means within 4e-6
relative (32 ulp: a cell sums up to ~40 points in another order; 1.5e-6
seen on the 3D node's cloud) and covariances within 1e-7 absolute (their
entries are at most ~0.035; 1.1e-8 seen) of the reference's.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.models.sensor.ndt import fit_measurement_cells as j_fit_cells
from beluga_tpu.ops import resample as J
from beluga_tpu_torch.models.sensor import ndt as ndt_mod
from beluga_tpu_torch.ops import cuda_resample as b2
from beluga_tpu_torch.ops import resample as P

torch.set_num_threads(1)

CDF_ULP = 64 * 2.0**-24


def uniforms(shape, seed, zeros=0):
    """f32 uniforms in [0, 1) with ``zeros`` exact zeros (zero spacings)."""
    rng = np.random.default_rng(seed)
    u = rng.random(shape, dtype=np.float32)
    flat = u.reshape(-1)
    flat[rng.choice(flat.size, zeros, replace=False)] = 0.0
    return u


def plain_running_sum(e):
    """The port's running sum before it took B2's CDF kernel."""
    return torch.cummax(torch.cumsum(e, dim=-1), dim=-1).values


@pytest.mark.parametrize("n,lead,zeros", [(1001, (), 0), (10002, (), 7), (4097, (3,), 5)])
def test_running_sum_plain_version_keeps_cumsum_bits(n, lead, zeros):
    """The CPU path of the positions' running sum is ``torch.cumsum`` bit for
    bit on nonnegative spacings (a zero spacing included), and launches
    nothing."""
    e = -torch.log1p(-torch.as_tensor(uniforms((*lead, n), n, zeros)))
    before = b2.sum_launches
    got = b2.running_sum(e)
    assert b2.sum_launches == before
    assert torch.equal(got, plain_running_sum(e))
    assert torch.equal(got, torch.cumsum(e, dim=-1))
    w = e.clone()
    w[..., : n // 3] = 0.0  # a dead prefix: the running sum stays 0 there
    assert torch.equal(b2.running_sum(w), torch.cumsum(w, dim=-1))
    assert torch.equal(b2.monotone_cdf(w),
                       torch.cumsum(w, -1) / torch.cumsum(w, -1)[..., -1:])


def test_running_sum_checks_its_input():
    with pytest.raises(ValueError, match="float32"):
        b2.running_sum(torch.ones(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        b2.running_sum(torch.ones(8, 4)[:, 0])
    with pytest.raises(ValueError, match="filters"):
        b2.running_sum(torch.ones(b2.MAX_FILTERS + 1, 2))


@pytest.mark.parametrize("m", [1000, 10001])
def test_sorted_multinomial_positions_match_reference(m):
    key = jax.random.PRNGKey(m)
    u = np.array(jax.random.uniform(key, (m + 1,), jnp.float32))
    want = np.asarray(J.sorted_multinomial_positions(key, m))
    tu = torch.as_tensor(u)
    got = P.sorted_multinomial_from_uniform(tu)
    e = -torch.log1p(-tu)
    s = plain_running_sum(e)
    old = torch.clamp_max(s[:-1] / torch.clamp_min(s[-1:], 1e-38), 1.0 - 2.0**-24)
    assert torch.equal(got, old)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)
    assert (np.diff(got.numpy()) >= 0).all() and got.max() < 1.0
    # per filter: each row alone
    rows = torch.stack([tu, tu.flip(0)])
    both = P.sorted_multinomial_from_uniform(rows)
    assert torch.equal(both[0], got)
    assert torch.equal(both[1], P.sorted_multinomial_from_uniform(tu.flip(0)))


@pytest.mark.parametrize("r0", [0, 1234, 4095])
def test_sorted_residual_positions_match_reference(r0):
    m = 4096
    key = jax.random.PRNGKey(r0)
    u = np.asarray(jax.random.uniform(key, (m + 1,), jnp.float32))
    want = np.asarray(J.sorted_residual_multinomial_positions(key, jnp.float32(r0), m))
    got = P.sorted_residual_from_uniform(torch.as_tensor(u), torch.tensor(float(r0))).numpy()
    np.testing.assert_array_equal(got[:r0], 0.0)
    np.testing.assert_allclose(got[r0:], want[r0:], rtol=2e-6, atol=0)
    assert (np.diff(got[r0:]) >= 0).all() and (got < 1.0).all()


@pytest.mark.parametrize("strategy", ["systematic", "residual"])
def test_index_form_cdfs_match_reference(strategy):
    """``search_indices`` and the residual CDF on B2's plain CDF: the same
    donors as the port's ``cumsum / total`` form, and as the reference's
    but where a position lies between the two CDFs' values of one entry."""
    n, m = 5000, 4500
    rng = np.random.default_rng(9)
    w = rng.exponential(1.0, n).astype(np.float32)
    w[n // 4 : n // 3] = 0.0
    key = jax.random.PRNGKey(11)
    want = np.asarray(J.RESAMPLERS[strategy](key, jnp.asarray(w), m))
    tw = torch.as_tensor(w)
    c = torch.cumsum(tw, dim=-1)
    old_cdf = c / c[-1:]
    if strategy == "residual":
        u = torch.as_tensor(np.asarray(jax.random.uniform(key, (m,), jnp.float32)))
        got = P.residual_indices_from_uniform(tw, u).numpy()
    else:
        pos = torch.as_tensor(np.asarray(J.POSITIONERS[strategy](key, m)))
        got = P.search_indices(tw, pos).numpy()
        old = torch.clamp(torch.searchsorted(old_cdf, pos, right=True), 0, n - 1)
        np.testing.assert_array_equal(got, old.numpy())
    assert np.mean(got == want) > 0.995
    assert not np.isin(got, np.flatnonzero(w == 0)).any()


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process."""
    import torch.distributed as dist

    from beluga_tpu_torch.parallel.multihost import start_process_group

    with tempfile.TemporaryDirectory() as d:
        start_process_group("cpu", 0, 1, f"file://{d}/store", 60.0)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def test_sharded_cdf_matches_reference_at_one_rank(world_of_one):
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as PS

    from beluga_tpu.parallel import collectives as jc
    from beluga_tpu_torch.parallel import collectives as c

    rng = np.random.default_rng(3)
    w = rng.random(8192).astype(np.float32)
    w[100:200] = 0.0
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("tp",))

    def cdf(x):
        local, off = jc.sharded_cdf(x, "tp")
        return local + off

    want = np.asarray(jax.shard_map(cdf, mesh=mesh, in_specs=(PS("tp"),),
                                    out_specs=PS("tp"))(jnp.asarray(w)))
    local, offset = c.sharded_cdf(torch.as_tensor(w), world_of_one)
    got = (local + offset).numpy()
    assert float(offset) == 0.0
    s = torch.cumsum(torch.as_tensor(w), -1)
    assert torch.equal(local, s / s[-1])  # the cumsum bits on a CPU rank
    assert np.abs(got - want).max() <= CDF_ULP
    fleet = torch.as_tensor(np.stack([w, w[::-1].copy()]))
    fl, fo = c.sharded_cdf(fleet, world_of_one)
    assert torch.equal(fl[0], local) and torch.equal(fo, torch.zeros(2))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_ordered_segment_sums_match_segment_sum(lead):
    """``_segment_sum`` adds each segment's rows in order: integer counts
    exactly, float sums within a few ulp of ``jax.ops.segment_sum``."""
    n, k = 700, 3
    rng = np.random.default_rng(len(lead))
    seg = np.sort(rng.integers(0, n // 7, (*lead, n)), axis=-1)
    perm = np.argsort(rng.random((*lead, n)), axis=-1)  # the points in any order
    order = torch.as_tensor(perm)
    values = rng.normal(3.0, 2.0, (*lead, n, k)).astype(np.float32)
    scattered = np.take_along_axis(values, np.argsort(perm, axis=-1)[..., None], axis=-2)
    lengths = torch.as_tensor(np.apply_along_axis(
        lambda s: np.bincount(s, minlength=n), -1, seg))
    ones = torch.ones((*lead, n))
    count = ndt_mod._segment_sum(ones, order, lengths)
    got = ndt_mod._segment_sum(torch.as_tensor(scattered), order, lengths).numpy()
    np.testing.assert_array_equal(count.numpy(), lengths.numpy().astype(np.float32))
    seg_flat, val_flat = seg.reshape(-1, n), values.reshape(-1, n, k)
    for i in range(seg_flat.shape[0]):
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(val_flat[i]), jnp.asarray(seg_flat[i]),
                                              num_segments=n))
        np.testing.assert_allclose(got.reshape(-1, n, k)[i], want, rtol=0, atol=2e-5)


def ndt_node_cloud():
    """The NDT-3D node's first cloud: the arena's 360-beam scan at ten
    heights, 3600 points, in the base frame."""
    from beluga_tpu_torch.tools import workloads

    pts, mask = workloads.ndt_clouds(workloads.ndt_scans(1))
    return pts[0], mask[0]


@pytest.mark.parametrize("d", [2, 3])
def test_fit_measurement_cells_on_clouds_match_reference(d):
    """The cells of a 2D scan (at 0.4 m) and of the NDT-3D node's 3600-point
    cloud (at 0.5 m) against the reference: equal cell masks, hence exact
    counts; means and covariances within the module's tolerances; a second
    call bit-equal; and a fleet's rows each its own cloud."""
    pts, mask = ndt_node_cloud()
    if d == 2:
        pts = np.ascontiguousarray(pts[:360, :2])
        mask = mask[:360]
    res = 0.4 if d == 2 else 0.5
    jm, jc, jcm = jax.jit(j_fit_cells)(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(res))
    tp, tm = torch.as_tensor(pts), torch.as_tensor(mask)
    means, covs, cm = ndt_mod.fit_measurement_cells(tp, tm, res)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    assert int(cm.sum()) >= 10
    live = cm.numpy()
    np.testing.assert_allclose(means.numpy()[live], np.asarray(jm)[live], rtol=4e-6, atol=0)
    np.testing.assert_allclose(covs.numpy()[live], np.asarray(jc)[live], rtol=0, atol=1e-7)
    again = ndt_mod.fit_measurement_cells(tp, tm, res)
    assert all(torch.equal(a, b) for a, b in zip(again, (means, covs, cm)))
    rev = (tp.flip(0).contiguous(), tm.flip(0).contiguous())
    fleet = ndt_mod.fit_measurement_cells(torch.stack([tp, rev[0]]), torch.stack([tm, rev[1]]),
                                          res)
    alone = ndt_mod.fit_measurement_cells(*rev, res)
    for got, want in zip(fleet, (means, covs, cm)):
        assert torch.equal(got[0], want)
    for got, want in zip(fleet, alone):
        assert torch.equal(got[1], want)
