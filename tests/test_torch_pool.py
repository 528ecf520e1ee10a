"""Kernel B3 (pool take) and the pooled recovery sampler of the PyTorch
port, held against the JAX package on the CPU.

B3's plain version is compared with ``pallas_pool_take(interpret=True)``:
both are bit-exact float32 copies, so the comparison is exact, out-of-range
indices (zero rows) and several filters included.  The sampler's core is
fed the reference's own draws (``split(key, 3)``, core/random.py:129-133):
the translations are exact, the headings agree within 1e-5 (sin/cos differ
in the last bits between XLA and PyTorch).  The generator wrapper draws
other numbers than JAX, so it is held to the distribution instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.core import random as j_random
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.ops.pallas_lookup import pallas_pool_take
from beluga_tpu_torch import convert
from beluga_tpu_torch.core.random import (
    sample_uniform_free_cells_pooled,
    uniform_free_cells_pooled_from_draws,
)
from beluga_tpu_torch.filters.builders import make_grid_random_state_fn
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.ops.cuda_pool_take import pool_take, pool_take_reference

torch.set_num_threads(1)


@pytest.mark.parametrize("lead,p,c,n", [((), 256, 2, 3000), ((3,), 64, 3, 700),
                                         ((2,), 512, 4, 1000), ((), 40, 8, 333)])
def test_b3_plain_bit_exact_against_pallas_interpret(lead, p, c, n):
    rng = np.random.default_rng(p + n)
    pool = rng.normal(0, 10, (*lead, p, c)).astype(np.float32)
    idx = rng.integers(0, p, (*lead, n)).astype(np.int32)
    idx[..., :5] = [-1, p, p + 7, -3, 0]  # out of range: zero rows
    flat_pool, flat_idx = pool.reshape(-1, p, c), idx.reshape(-1, n)
    want = np.stack([
        np.asarray(pallas_pool_take(jnp.asarray(a), jnp.asarray(i), interpret=True))
        for a, i in zip(flat_pool, flat_idx)
    ]).reshape(*lead, n, c)
    got = pool_take_reference(torch.as_tensor(pool), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[..., :2, :].any() and not want[..., 3, :].any()
    # CPU tensors: the wrapper runs the plain version
    assert torch.equal(pool_take(torch.as_tensor(pool), torch.as_tensor(idx)), got)


def test_b3_wrapper_rejects_bad_inputs():
    pool, idx = torch.zeros(3, 16, 2), torch.zeros(3, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        pool_take(pool, idx.long())
    with pytest.raises(ValueError, match="filter axes"):
        pool_take(pool, idx[:2])
    with pytest.raises(ValueError, match="contiguous"):
        pool_take(pool, torch.zeros(3, 10, dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError, match="P <= 4096"):
        pool_take(torch.zeros(4097, 2), torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="float32"):
        pool_take(pool.double(), idx)


def reference_grid():
    data = np.full((30, 40), 100, np.int8)
    data[5:20, 3:30] = 0
    data[8:11, 10:12] = 100
    jgrid = jax.device_get(j_make_grid(data, 0.1, (0.5, -0.5, 0.3)))
    return jgrid, convert.grid(jgrid)


@pytest.mark.parametrize("n,pool", [(300, 64), (1000, 256)])
def test_pooled_sampler_core_from_reference_draws(n, pool):
    jgrid, grid = reference_grid()
    keys = [jax.random.PRNGKey(s) for s in (4, 11)]
    cands, idxs, thetas, wants = [], [], [], []
    for key in keys:
        wants.append(j_random.sample_uniform_free_cells_pooled(
            key, n, jnp.asarray(jgrid.free_xy), jnp.asarray(jgrid.num_free), pool=pool,
            interpret=True))
        k_pool, k_idx, k_th = jax.random.split(key, 3)
        cands.append(jax.random.randint(k_pool, (pool,), 0, max(int(jgrid.num_free), 1)))
        idxs.append(jax.random.randint(k_idx, (n,), 0, pool))
        thetas.append(jax.random.uniform(k_th, (n,), jnp.float32, -jnp.pi, jnp.pi))
    stack = lambda xs, dtype: torch.as_tensor(np.stack([np.asarray(x) for x in xs]).astype(dtype))  # noqa: E731
    got = uniform_free_cells_pooled_from_draws(
        stack(cands, np.int64), stack(idxs, np.int32), stack(thetas, np.float32), grid.free_xy)
    assert got.xy.shape == (2, n, 2)
    for b, want in enumerate(wants):
        np.testing.assert_array_equal(got.xy[b].numpy(), np.asarray(want.xy))
        np.testing.assert_allclose(got.rot.z[b].numpy(), np.asarray(want.rot.z), rtol=0, atol=1e-5)


def test_pooled_sampler_marginal_uniform():
    """The pooled wrapper's marginal is uniform over the free cells across
    calls (one call follows its pool's composition, the documented
    bootstrap deviation), with the bounds of the JAX package's test
    (tests/test_core.py:234-265); headings are uniform."""
    free = torch.stack([torch.arange(16, dtype=torch.float32), torch.zeros(16)], -1)
    gen = torch.Generator().manual_seed(0)
    xs = sample_uniform_free_cells_pooled(gen, 512, free, 16, pool=64, lead=(32,)).x
    counts = np.bincount(xs.numpy().astype(int).ravel(), minlength=16)
    mean = counts.sum() / 16
    assert counts.min() > 0.7 * mean and counts.max() < 1.3 * mean
    th = sample_uniform_free_cells_pooled(gen, 8192, free, 16, pool=64).theta.numpy()
    assert abs(np.mean(np.cos(th))) < 0.05 and abs(np.mean(np.sin(th))) < 0.05
    # each filter of one call draws from its own pool: no more distinct cells
    one = sample_uniform_free_cells_pooled(gen, 4096, free, 16, pool=4, lead=(6,)).x
    assert all(len(set(row.tolist())) <= 4 for row in one)
    assert len(set(one.ravel().tolist())) > 4


@pytest.mark.parametrize("n,candidates,pool", [(4096, 256, 512), (64, 16, 16), (40, 256, None)])
def test_builder_pool_size_and_fleet_shape(n, candidates, pool):
    """``make_grid_random_state_fn``: a pool of ``min(n, max(candidates,
    n // 8), 4096)`` cells per filter (builders.py:58-87), the exact
    sampler when ``candidates >= n``; states carry the fleet's axes."""
    from beluga_tpu_torch.core.particles import make_from_states

    _, grid = reference_grid()
    fn = make_grid_random_state_fn(recovery_candidates=candidates)
    particles = make_from_states(SE2.identity((3, 7)), batch_dims=1)
    states = fn({"grid": grid}, torch.Generator().manual_seed(1), n, particles)
    assert states.xy.shape == (3, n, 2)
    free = {tuple(r) for r in grid.free_xy[: grid.num_free].tolist()}
    for row in states.xy:
        cells = {tuple(r) for r in row.tolist()}
        assert cells <= free
        if pool is not None:
            assert len(cells) <= pool
        else:
            assert len(cells) > 30  # iid over ~390 free cells
