"""Residual resampling in the port against the JAX package on the CPU: the
residual positions, the two passes of kernel B2's plain version (the
reference's accelerator construction, filters/amcl.py:369-397), the floor
copies against ``residual_indices``, the index-form resamplers, a fleet
whose filters copy different counts, and the filter update with
``resampling="residual"``.

Tolerances: the floor copies are exact (integer prefix sums); the residual
positions are the spacings construction, whose cumsums add in another
order (2e-6 relative, as the sorted-multinomial positions); a residual
donor differs from the reference's only where the position lies between
the two packages' values of one CDF entry, and the test names those slots
(``moved``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.ops import resample as J
from beluga_tpu.ops.pallas_resample import resample_take_tree as j_take_tree
from beluga_tpu_torch.filters.amcl import AmclParams, UpdateDraws, init_state, update
from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, make_grid
from beluga_tpu_torch.ops import resample as P
from beluga_tpu_torch.ops.cuda_resample import (
    monotone_cdf_reference,
    resample_take_tree_residual,
)

torch.set_num_threads(1)


def weights(n, seed, zeros=True):
    rng = np.random.default_rng(seed)
    w = rng.exponential(1.0, n).astype(np.float32)
    if zeros:
        w[n // 4 : n // 4 + n // 16] = 0.0  # a block of dead slots
    return w


def counts_of(w, m):
    wn = w / w.sum(axis=-1, keepdims=True, dtype=np.float32)
    return np.floor(wn * np.float32(m))


@pytest.mark.parametrize("m,r0", [(512, 0), (512, 300), (512, 511), (512, 512), (1000, 77)])
def test_sorted_residual_from_uniform_matches_reference(m, r0):
    key = jax.random.PRNGKey(m + r0)
    u = np.asarray(jax.random.uniform(key, (m + 1,), jnp.float32))
    want = np.asarray(J.sorted_residual_multinomial_positions(key, jnp.float32(r0), m))
    got = P.sorted_residual_from_uniform(torch.as_tensor(u), torch.tensor(float(r0))).numpy()
    np.testing.assert_array_equal(got[:r0], 0.0)
    np.testing.assert_allclose(got[r0:], want[r0:], rtol=2e-6, atol=0)
    assert (np.diff(got[r0:]) >= 0).all() and (got < 1.0).all()
    # the generator form draws m + 1 uniforms and takes the same path
    g = torch.Generator().manual_seed(0)
    again = P.sorted_residual_multinomial_positions(g, torch.tensor(float(r0)), m)
    assert again.shape == (m,) and (again[:r0] == 0).all()


def test_sorted_residual_per_filter_shift():
    """A ``[B, M + 1]`` draw with a different ``r0`` per filter equals each
    filter's own call: the shift is a gather per filter, not a roll."""
    u = torch.rand(3, 257, generator=torch.Generator().manual_seed(1))
    r0 = torch.tensor([0.0, 100.0, 256.0])
    got = P.sorted_residual_from_uniform(u, r0)
    for i in range(3):
        assert torch.equal(got[i], P.sorted_residual_from_uniform(u[i], r0[i]))


@pytest.mark.parametrize("n,m,seed", [(512, 512, 0), (700, 1024, 1), (4096, 4096, 2)])
def test_two_pass_donors_against_reference_construction(n, m, seed):
    """The port's two passes against the reference's, built as
    ``tests/test_parallel.py`` builds it with ``resample_take_tree(...,
    interpret=True)``: the floor copies bit-equal, the residual slots
    bit-equal wherever both packages' position and CDF put it in the same
    interval."""
    w = weights(n, seed)
    key = jax.random.PRNGKey(seed)
    u = np.asarray(jax.random.uniform(key, (m + 1,), jnp.float32))
    state = np.arange(n, dtype=np.float32)  # identity payload
    got = resample_take_tree_residual(torch.as_tensor(w), torch.as_tensor(state),
                                      torch.as_tensor(u)).numpy()

    wn = jnp.asarray(w) / jnp.maximum(jnp.sum(jnp.asarray(w)), 1e-38)
    counts = jnp.floor(wn * m)
    r0 = jnp.sum(counts)
    slots = jnp.arange(m, dtype=jnp.float32)
    u_det = jnp.where(slots < r0, (slots + 0.5) / jnp.maximum(r0, 1.0), 1.5)
    det = np.asarray(j_take_tree(counts, u_det, jnp.asarray(state), interpret=True))
    u_res = J.sorted_residual_multinomial_positions(key, r0, m)
    res = np.asarray(j_take_tree(wn * m - counts, u_res, jnp.asarray(state), interpret=True))
    r0 = int(r0)
    assert 0 < r0 < m
    want = np.concatenate([det[:r0], res[r0:]])
    np.testing.assert_array_equal(got[:r0], want[:r0])
    np.testing.assert_array_equal(np.bincount(got[:r0].astype(int), minlength=n),
                                  np.asarray(counts).astype(int))

    t_w = torch.as_tensor(w)
    t_wn = t_w / torch.clamp_min(t_w.sum(), 1e-38)
    t_counts = torch.floor(t_wn * m)
    t_cdf = monotone_cdf_reference(t_wn * m - t_counts).numpy()
    c = jnp.cumsum(wn * m - counts)  # the CDF as pallas_resample.py:405-412 builds it
    j_cdf = np.asarray(jax.lax.cummax(c / jnp.maximum(c[-1], 1e-38)))
    t_pos = P.sorted_residual_from_uniform(torch.as_tensor(u), t_counts.sum()).numpy()
    moved = (np.searchsorted(t_cdf, t_pos, side="right")
             != np.searchsorted(j_cdf, np.asarray(u_res), side="right"))[r0:]
    np.testing.assert_array_equal(got[r0:] != want[r0:], moved)
    assert moved.mean() < 0.01
    total = np.bincount(got.astype(int), minlength=n)
    assert total.sum() == m and (total >= np.asarray(counts).astype(int)).all()
    assert not total[w == 0].any()


@pytest.mark.parametrize("n,m,seed", [(512, 512, 3), (300, 1000, 4)])
def test_floor_copies_exact_against_residual_indices(n, m, seed):
    """The first ``r0`` donors are ``residual_indices``' deterministic part,
    exactly: both list particle i ``floor(m·w_i)`` times, in index order."""
    w = weights(n, seed)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(J.residual_indices(key, jnp.asarray(w), m))
    r0 = int(np.asarray(jnp.sum(jnp.floor(jnp.asarray(w) / jnp.sum(jnp.asarray(w)) * m))))
    u = torch.rand(m + 1, generator=torch.Generator().manual_seed(seed))
    got = resample_take_tree_residual(torch.as_tensor(w),
                                      torch.arange(n, dtype=torch.float32), u).numpy()
    np.testing.assert_array_equal(got[:r0].astype(np.int32), ref[:r0])


@pytest.mark.parametrize("strategy", ["multinomial", "systematic", "stratified", "residual"])
def test_index_resamplers_match_reference(strategy):
    """The index-form resamplers given the reference's draws: equal but where
    a position lies between the two CDFs' values of one entry."""
    n, m = 1000, 1500
    w = weights(n, 5)
    key = jax.random.PRNGKey(6)
    want = np.asarray(J.RESAMPLERS[strategy](key, jnp.asarray(w), m))
    tw = torch.as_tensor(w)
    if strategy == "residual":
        u = torch.as_tensor(np.asarray(jax.random.uniform(key, (m,), jnp.float32)))
        got = P.residual_indices_from_uniform(tw, u).numpy()
    else:
        pos = torch.as_tensor(np.asarray(J.POSITIONERS[strategy](key, m)))
        got = P.search_indices(tw, pos).numpy()
    assert got.dtype == np.int32 and got.shape == (m,)
    assert np.mean(got == want) > 0.995
    assert not np.isin(got, np.flatnonzero(w == 0)).any()
    # the generator forms draw their own positions through the same search
    g = torch.Generator().manual_seed(0)
    idx = P.RESAMPLERS[strategy](g, tw, m)
    assert idx.shape == (m,) and not np.isin(idx.numpy(), np.flatnonzero(w == 0)).any()


def test_fleet_with_a_different_r0_per_filter():
    """A ``[B, N]`` fleet whose filters copy different floor counts: each
    filter's donors are its single call's, bit for bit."""
    n, m, b = 256, 256, 3
    w = np.stack([weights(n, 10, zeros=False), weights(n, 11) ** 3, np.ones(n, np.float32)])
    r0 = counts_of(w, m).sum(-1)
    assert len(set(r0.tolist())) == 3  # 3 different r0, one of them m
    u = torch.rand(b, m + 1, generator=torch.Generator().manual_seed(2))
    xy = torch.randn(b, n, 2, generator=torch.Generator().manual_seed(3))
    st = SE2.from_xytheta(xy[..., 0], xy[..., 1], torch.linspace(-3, 3, n).expand(b, n))
    got = resample_take_tree_residual(torch.as_tensor(w), st, u)
    for i in range(b):
        one = resample_take_tree_residual(torch.as_tensor(w[i]),
                                          SE2(st.xy[i], type(st.rot)(st.rot.z[i])), u[i])
        assert torch.equal(got.xy[i], one.xy) and torch.equal(got.rot.z[i], one.rot.z)


def world():
    data = np.zeros((60, 60), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[20:28, 30:36] = OCCUPIED_VALUE
    return make_grid(data, 0.1, device="cpu")


@pytest.mark.parametrize("adaptive", [False, True])
def test_filter_update_resamples_residual(adaptive):
    """``AmclParams(resampling="residual")``: the update's donors are the two
    passes on the normalized weights, given the draws, interleaved when the
    KLD prefix needs it; without draws the generator draws ``M + 1``
    uniforms."""
    n = 512
    params = AmclParams(max_particles=n, min_particles=128 if adaptive else n,
                        resampling="residual", alpha_fast=0.0, alpha_slow=0.0)
    models, ctx = make_likelihood_field_filter(world(), device="cpu")
    g = torch.Generator().manual_seed(4)
    xy = torch.randn(n, 2, generator=g) * 0.3 + 2.5
    st = SE2.from_xytheta(xy[:, 0], xy[:, 1], torch.randn(n, generator=g) * 0.2)
    state = init_state(g, st, params, device="cpu")
    ang = torch.linspace(-3.1, 3.1, 30)
    pts = torch.stack([1.5 * torch.cos(ang), 1.5 * torch.sin(ang)], -1)
    mask = torch.ones(30, dtype=torch.bool)
    z = torch.zeros(3, n)
    u = torch.rand(n + 1, generator=g)
    draws = UpdateDraws(motion_normals=z, positions=None, inject_uniform=torch.ones(n),
                        random_states=st, residual_uniforms=u)
    odom = SE2.from_xytheta(0.0, 0.0, 0.0, device="cpu")
    new, est = update(params, models, ctx, state, odom, pts, mask, draws=draws)
    assert est.valid
    log_w = models.log_weight(ctx, st, pts, mask)
    w = torch.exp(log_w - log_w.max())
    want = resample_take_tree_residual(w / w.sum(), st, u)
    if adaptive:
        want = SE2(P.interleave_slots(want.xy), type(want.rot)(P.interleave_slots(want.rot.z)))
    np.testing.assert_allclose(new.particles.state.xy.numpy(), want.xy.numpy(), atol=1e-6)
    again, _ = update(params, models, ctx, state, odom, pts, mask)
    assert torch.isfinite(again.particles.state.xy).all()
    with pytest.raises(ValueError, match="resampling"):
        AmclParams(resampling="bogus")
