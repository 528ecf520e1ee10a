"""Kernel B2 (the CDF build, the resampling search and the donor copy) of
the PyTorch port, held against ``beluga_tpu/ops/pallas_resample.py`` in
interpret mode on the CPU.  The port is fed the positions the reference
drew, and the search's plain version the CDF the reference built; donor
rows are bit-exact copies, so those comparisons are exact.

The CDF is built from the weights in both packages with each framework's
cumsum: XLA's CPU cumsum and PyTorch's add in other orders, so the two
CDFs differ by a few ulp (float32; up to 4 measured at N = 2048, growing
with the length of the sum) at some entries, and a position that falls
between the two values of such an entry picks the neighbouring donor.  The
tests of the whole function allow exactly those rows to differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.ops.pallas_resample import resample_take as j_resample_take
from beluga_tpu.ops.pallas_resample import (
    resample_take_tree_multinomial as j_take_multinomial,
)
from beluga_tpu.ops.resample import sorted_multinomial_positions as j_sorted_positions
from beluga_tpu.ops.resample import systematic_positions as j_systematic_positions
from beluga_tpu_torch import convert
from beluga_tpu_torch.ops.cuda_resample import (
    monotone_cdf,
    monotone_cdf_reference,
    pack_state,
    resample_take,
    resample_take_reference,
    resample_take_tree,
    resample_take_tree_multinomial,
    search_take,
    search_take_reference,
    unpack_state,
)

torch.set_num_threads(1)


@jax.jit
def j_cdf(weights):
    """The CDF as ``pallas_resample.resample_take`` builds it (:405-412)."""
    c = jnp.cumsum(weights.astype(jnp.float32))
    return jax.lax.cummax(c / jnp.maximum(c[-1], 1e-38))


def weights_with_zero_block(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.gamma(0.7, 1.0, n).astype(np.float32)
    w[n // 3 : n // 3 + max(n // 10, 1)] = 0.0  # a block of zero-weight slots
    w[-3:] = 0.0  # dead tail
    return w


CASES = [  # (N, M, D, padded positions)
    (1000, 1000, 4, 0),
    (1000, 1500, 4, 40),  # M > N, padded
    (2048, 700, 3, 25),  # M < N
    (333, 333, 1, 10),
]


@pytest.mark.parametrize("strategy", ["systematic", "sorted multinomial", "uniform"])
@pytest.mark.parametrize("n,m,d,pad", CASES)
def test_b2_plain_bit_exact_against_pallas_interpret(n, m, d, pad, strategy):
    key = jax.random.PRNGKey(n + m + d)
    if strategy == "systematic":
        pos = j_systematic_positions(key, m)
    elif strategy == "sorted multinomial":
        pos = j_sorted_positions(key, m)
    else:
        pos = jax.random.uniform(key, (m,), jnp.float32)
    pos = np.array(pos)
    if pad:
        pos[-pad:] = 1.5  # padding selects nothing
    w = weights_with_zero_block(n, n * d)
    vals = np.random.default_rng(m).normal(size=(d, n)).astype(np.float32)

    want = np.asarray(j_resample_take(jnp.asarray(w), jnp.asarray(pos), jnp.asarray(vals),
                                      interpret=True))
    cdf = torch.as_tensor(np.asarray(j_cdf(jnp.asarray(w))))
    got = search_take(cdf, torch.as_tensor(pos), torch.as_tensor(vals))
    assert got.shape == (m, d)
    np.testing.assert_array_equal(got.numpy(), want)
    if pad:
        assert not got[-pad:].any()
    # zero-weight slots are never chosen: every non-padded row is some
    # positive-weight particle's state
    alive = vals[:, w > 0].T
    rows = got.numpy()[: m - pad]
    assert all((alive == r).all(axis=1).any() for r in rows[:: max(m // 50, 1)])


@pytest.mark.parametrize("n,m,d,pad", CASES)
def test_b2_wrapper_differs_only_where_the_cdfs_do(n, m, d, pad):
    """The whole wrapper, CDF included: rows differ from the reference only
    where a position lies between the two packages' values of one CDF
    entry; the CDFs differ by at most 8 ulp at these lengths."""
    key = jax.random.PRNGKey(n * m)
    pos = np.array(jax.random.uniform(key, (m,), jnp.float32))
    if pad:
        pos[-pad:] = 1.5
    w = weights_with_zero_block(n, n * d)
    vals = np.random.default_rng(m).normal(size=(d, n)).astype(np.float32)
    want = np.asarray(j_resample_take(jnp.asarray(w), jnp.asarray(pos), jnp.asarray(vals),
                                      interpret=True))
    got = resample_take(torch.as_tensor(w), torch.as_tensor(pos), torch.as_tensor(vals))
    j_c = np.asarray(j_cdf(jnp.asarray(w)))
    t_c = monotone_cdf(torch.as_tensor(w)).numpy()
    np.testing.assert_array_max_ulp(t_c, j_c, maxulp=8)
    moved = (np.searchsorted(t_c, pos, side="right")
             != np.searchsorted(j_c, pos, side="right"))
    differs = (got.numpy() != want).any(axis=1)
    np.testing.assert_array_equal(differs, moved)


@pytest.mark.parametrize("n,m", [(1000, 1000), (2048, 1536), (777, 1200)])
def test_b2_tree_multinomial_against_reference_draws(n, m):
    """``resample_take_tree_multinomial`` with the positions the reference
    drew from its key: identical donor states, interleave included."""
    rng = np.random.default_rng(n)
    xs, ys, th = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    jstates = JSE2.from_xytheta(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(th))
    w = weights_with_zero_block(n, m)
    key = jax.random.PRNGKey(7)
    want = jax.device_get(j_take_multinomial(key, jnp.asarray(w), jstates, m,
                                             interpret=True))
    pos = torch.as_tensor(np.array(j_sorted_positions(key, m)))
    got = resample_take_tree_multinomial(None, torch.as_tensor(w),
                                         convert.se2(jax.device_get(jstates)), m,
                                         positions=pos)
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(got.rot.z.numpy(), np.asarray(want.rot.z))


def test_b2_monotone_cdf_and_search():
    """``search_take`` on a CDF with a flat stretch and an ulp dip: cummax
    keeps it monotone, the search is side='right'."""
    w = torch.tensor([1.0, 0.0, 0.0, 2.0, 1.0], dtype=torch.float32)
    cdf = monotone_cdf(w)
    assert torch.equal(cdf, torch.tensor([0.25, 0.25, 0.25, 0.75, 1.0]))
    vals = torch.arange(5, dtype=torch.float32)[None]
    pos = torch.tensor([0.0, 0.2499, 0.25, 0.74, 0.75, 0.99, 1.5])
    got = search_take(cdf, pos, vals)[:, 0]
    assert got.tolist() == [0.0, 0.0, 3.0, 3.0, 4.0, 4.0, 0.0]  # last: padding, zero row
    dipped = torch.tensor([0.3, 0.6, 0.6 - 2**-24, 1.0])
    fixed = torch.cummax(dipped, 0).values
    assert torch.equal(search_take(fixed, torch.tensor([0.6]), vals[:, :4]),
                       search_take_reference(fixed, torch.tensor([0.6]), vals[:, :4]))


def j_resample_rows(w, pos, vals):
    """The reference's ``resample_take`` per filter of ``[..., N]`` inputs,
    in interpret mode."""
    lead = w.shape[:-1]
    rows = [np.asarray(j_resample_take(jnp.asarray(w[i]), jnp.asarray(pos[i]),
                                       jnp.asarray(vals[i]), interpret=True))
            for i in np.ndindex(lead)]
    return np.stack(rows).reshape(*lead, *rows[0].shape)


FLEET_CASES = [  # (lead, N, M, D, padded positions, all-zero filter)
    ((), 1000, 1000, 4, 30, False),
    ((3,), 700, 500, 4, 20, True),
    ((2, 2), 300, 400, 3, 15, False),
]


@pytest.mark.parametrize("strategy", ["systematic", "sorted multinomial", "uniform"])
@pytest.mark.parametrize("lead,n,m,d,pad,dead", FLEET_CASES)
def test_b2_plain_whole_function_against_pallas_interpret(lead, n, m, d, pad, dead, strategy):
    """The new plain version, weights in: per filter, rows differ from the
    reference's ``resample_take`` only where a position lies between the
    two CDFs' values of one entry (at most 8 ulp apart); zero-weight blocks,
    an all-zero filter (every row zero in both: the reference's CDF is NaN
    there, XLA's CPU flushing the subnormal 1e-38 to 0, the port's 0) and
    padding at 1.5 included."""
    rng = np.random.default_rng(n + m)
    w = np.stack([weights_with_zero_block(n, n + i) for i in range(int(np.prod(lead)))])
    if dead:
        w[-1] = 0.0
    w = w.reshape(*lead, n)
    keys = jax.random.split(jax.random.PRNGKey(n * m), int(np.prod(lead)))
    draw = {"systematic": j_systematic_positions, "sorted multinomial": j_sorted_positions,
            "uniform": lambda k, num: jax.random.uniform(k, (num,), jnp.float32)}[strategy]
    pos = np.stack([np.array(draw(k, m)) for k in keys]).reshape(*lead, m)
    pos[..., m - pad:] = 1.5
    vals = rng.normal(size=(*lead, d, n)).astype(np.float32)
    want = j_resample_rows(w, pos, vals)
    got = resample_take_reference(torch.as_tensor(w), torch.as_tensor(pos),
                                  torch.as_tensor(vals)).numpy()
    assert got.shape == (*lead, m, d)
    t_c = monotone_cdf_reference(torch.as_tensor(w)).numpy()
    moved = np.zeros(pos.shape, bool)
    for i in np.ndindex(lead):
        if not w[i].any():
            continue
        j_c = np.asarray(j_cdf(jnp.asarray(w[i])))
        np.testing.assert_array_max_ulp(t_c[i], j_c, maxulp=8)
        moved[i] = (np.searchsorted(t_c[i], pos[i], side="right")
                    != np.searchsorted(j_c, pos[i], side="right"))
    np.testing.assert_array_equal((got != want).any(axis=-1), moved)
    assert not got[..., m - pad:, :].any()
    if dead:
        assert not got[(*((-1,) * len(lead)),)].any()  # an all-zero filter takes no donor
    # the wrapper is the plain version on the CPU
    np.testing.assert_array_equal(
        resample_take(torch.as_tensor(w), torch.as_tensor(pos), torch.as_tensor(vals)).numpy(),
        got)


@pytest.mark.parametrize("n", [1, 7, 4096, 4097, 10000])
def test_b2_plain_cdf_zero_weight_intervals_empty(n):
    """``monotone_cdf_reference``: monotone, every zero-weight slot's entry
    equal to the one before it (0 before the first live slot), the last
    live slot's entry exactly 1, an all-zero filter all 0, and within
    64 · 2^-24 of a float64 prefix sum; one CDF per filter."""
    rng = np.random.default_rng(n)
    w = rng.gamma(0.5, 1.0, (3, n)).astype(np.float32)
    w[0, rng.random(n) < 0.3] = 0.0
    w[0, 0] = 0.0
    w[1] = 0.0
    cdf = monotone_cdf_reference(torch.as_tensor(w)).numpy()
    assert monotone_cdf(torch.as_tensor(w)).numpy().tobytes() == cdf.tobytes()
    assert (np.diff(cdf, axis=-1) >= 0).all()
    assert not cdf[1].any()
    for f in (0, 2):
        dead = np.flatnonzero(w[f] == 0)
        before = np.where(dead > 0, cdf[f][np.maximum(dead - 1, 0)], 0.0)
        np.testing.assert_array_equal(cdf[f][dead], before)
        live = np.flatnonzero(w[f] > 0)
        if live.size:
            assert cdf[f][live[-1]] == 1.0
        exact = np.cumsum(w[f].astype(np.float64))
        exact = exact / max(exact[-1], 1e-38)
        assert np.abs(cdf[f] - exact).max() <= 64 * 2.0**-24


def test_b2_pack_unpack_round_trip():
    from beluga_tpu_torch.lie import SE2

    s = SE2.from_xytheta(torch.randn(9), torch.randn(9), torch.randn(9))
    planes, like = pack_state(s)
    assert planes.shape == (4, 9) and planes.is_contiguous()
    back = unpack_state(planes.T.contiguous(), like)
    assert torch.equal(back.xy, s.xy) and torch.equal(back.rot.z, s.rot.z)
    out = resample_take_tree(torch.ones(9), torch.tensor([0.05, 0.95]), s)
    assert torch.equal(out.xy, s.xy[[0, 8]])


def test_b2_wrapper_rejects_bad_inputs():
    cdf = torch.linspace(0.1, 1.0, 10)
    vals = torch.zeros(4, 10)
    with pytest.raises(ValueError, match="values"):
        search_take(cdf, torch.zeros(3), torch.zeros(4, 9))
    with pytest.raises(ValueError, match="float32"):
        search_take(cdf.double(), torch.zeros(3), vals)
    with pytest.raises(ValueError, match="contiguous"):
        search_take(cdf, torch.zeros(6)[::2], vals)
    with pytest.raises(ValueError, match="weights"):
        resample_take(torch.ones(2, 5), torch.zeros(3), vals)
    with pytest.raises(ValueError, match="weights"):
        monotone_cdf(torch.ones(5, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        monotone_cdf(torch.ones(10)[::2])
    with pytest.raises(ValueError, match="65535"):
        monotone_cdf(torch.ones(65536, 1))
