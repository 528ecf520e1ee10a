"""Kernel B3's draw entry (``ops/cuda_pool_take.py:pooled_free_cells``, the
pooled recovery sampler's whole draw) through its wrapper on CPU tensors,
where it runs its plain version, held against the JAX package's
``sample_uniform_free_cells_pooled(interpret=True)`` on the reference's own
draws (``split(key, 3)``, core/random.py:129-133).

Tolerances: the translations are exact (bit-exact float32 copies); the
headings agree within 1e-5 (sin and cos differ in the last bits between
XLA and PyTorch).  An ``idx`` outside ``[0, P)`` gives a zero row, as
``pallas_pool_take`` does for it.
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
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.ops.cuda_pool_take import pooled_free_cells, pooled_free_cells_reference

torch.set_num_threads(1)


def reference_grid():
    data = np.full((30, 40), 100, np.int8)
    data[5:20, 3:30] = 0
    data[8:11, 10:12] = 100
    jgrid = jax.device_get(j_make_grid(data, 0.1, (0.5, -0.5, 0.3)))
    return jgrid, convert.grid(jgrid)


def reference_draws(jgrid, key, n, pool):
    """The reference sampler's states and its three draws from ``key``."""
    want = j_random.sample_uniform_free_cells_pooled(
        key, n, jnp.asarray(jgrid.free_xy), jnp.asarray(jgrid.num_free), pool=pool,
        interpret=True)
    k_pool, k_idx, k_th = jax.random.split(key, 3)
    cand = jax.random.randint(k_pool, (pool,), 0, max(int(jgrid.num_free), 1))
    idx = jax.random.randint(k_idx, (n,), 0, pool)
    theta = jax.random.uniform(k_th, (n,), jnp.float32, -jnp.pi, jnp.pi)
    return want, np.array(cand, np.int64), np.array(idx, np.int32), np.array(theta)


@pytest.mark.parametrize("lead,n,pool", [((), 1000, 256), ((3,), 300, 64), ((2, 2), 129, 16)])
def test_draw_matches_reference_sampler(lead, n, pool):
    """Every filter of a ``lead`` stack on the reference's draws from its own
    key: the translations bit-equal, the headings within 1e-5."""
    jgrid, grid = reference_grid()
    filters = int(np.prod(lead))
    draws = [reference_draws(jgrid, jax.random.PRNGKey(7 + f), n, pool) for f in range(filters)]
    cand, idx, theta = (torch.as_tensor(np.stack([d[i] for d in draws]).reshape(*lead, -1))
                        for i in (1, 2, 3))
    got = pooled_free_cells(grid.free_xy, cand, idx, theta)
    assert isinstance(got, SE2) and got.xy.shape == got.rot.z.shape == (*lead, n, 2)
    for f, (want, *_) in enumerate(draws):
        at = np.unravel_index(f, lead) if lead else ()
        np.testing.assert_array_equal(got.xy[at].numpy(), np.asarray(want.xy))
        np.testing.assert_allclose(got.rot.z[at].numpy(), np.asarray(want.rot.z), rtol=0,
                                   atol=1e-5)


def test_out_of_range_idx_gives_zero_rows():
    """``idx`` of -1, P and beyond: zero translation rows, as the reference's
    ``pallas_pool_take`` gives for them; the other rows and every heading
    as the plain composition."""
    jgrid, grid = reference_grid()
    n, pool = 200, 32
    _, cand, idx, theta = reference_draws(jgrid, jax.random.PRNGKey(3), n, pool)
    idx[:6] = [-1, pool, pool + 9, -7, 0, pool - 1]
    pool_xy = jnp.take(jnp.asarray(jgrid.free_xy), jnp.asarray(cand), axis=0)
    want = np.asarray(pallas_pool_take(pool_xy, jnp.asarray(idx), interpret=True))
    got = pooled_free_cells(grid.free_xy, *map(torch.as_tensor, (cand, idx, theta)))
    np.testing.assert_array_equal(got.xy.numpy(), want)
    assert not want[:4].any() and want[4:6].all()
    th = torch.as_tensor(theta)
    assert torch.equal(got.rot.z, torch.stack([torch.cos(th), torch.sin(th)], -1))
    ref = pooled_free_cells_reference(grid.free_xy, *map(torch.as_tensor, (cand, idx, theta)))
    assert torch.equal(ref.xy, got.xy) and torch.equal(ref.rot.z, got.rot.z)


def test_draw_wrapper_rejects_bad_inputs():
    free = torch.zeros(50, 2)
    cand = torch.zeros(3, 16, dtype=torch.int64)
    idx = torch.zeros(3, 5, dtype=torch.int32)
    theta = torch.zeros(3, 5)
    pooled_free_cells(free, cand, idx, theta)  # accepted
    cases = [
        ((free.double(), cand, idx, theta), "free_xy must be float32"),
        ((torch.zeros(50, 3), cand, idx, theta), r"free_xy must be float32\[rows, 2\]"),
        ((free, cand.int(), idx, theta), "cand must be int64"),
        ((free, torch.zeros(3, 4097, dtype=torch.int64), idx, theta), "P <= 4096"),
        ((free, cand, idx.long(), theta), "idx must be int32"),
        ((free, cand, idx[:2], theta[:2]), "filter axes"),
        ((free, cand, idx, torch.zeros(3, 4)), "theta must be float32"),
        ((free, cand, idx, theta.double()), "theta must be float32"),
        ((free, cand, torch.zeros(3, 10, dtype=torch.int32)[:, ::2], theta), "contiguous"),
        ((free, cand, idx, theta.to("meta")), "theta is on meta"),
        ((free.to("meta"), cand.to("meta"), idx.to("meta"), theta.to("meta")),
         "unsupported device"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            pooled_free_cells(*args)
