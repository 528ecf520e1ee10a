"""The port's ray cast (``beluga_tpu_torch/ops/raycast.py``, the plain
version of kernel R1) held against the JAX package's ``cast_rays`` on the
CPU, both Bresenham variants.

Inputs: random maps with obstacles and unknown cells, rays that start in
obstacles, leave the grid, run along cell edges and axes.  Tolerances: hit
flags equal; distances within two ulp (``hypot`` is XLA's in one and
PyTorch's in the other and differs by one ulp, which the product with the
resolution can round to two).  Where XLA's CPU backend contracts the
far-cell product ``src + max_range · dir`` into an FMA, a far cell can
move by one; the test allows a differing hit flag only for such a ray
(its far point within one float32 ulp of a cell edge) and names it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.ops.raycast import cast_rays as j_cast_rays
from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, UNKNOWN_VALUE, make_grid
from beluga_tpu_torch.ops import raycast

torch.set_num_threads(1)


def random_map(seed, h=40, w=50):
    rng = np.random.default_rng(seed)
    data = np.zeros((h, w), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[rng.random((h, w)) < 0.05] = OCCUPIED_VALUE
    data[rng.random((h, w)) < 0.03] = UNKNOWN_VALUE
    data[5:9, 30:32] = 0  # a gap in the border: some rays leave the grid
    data[5:9, -1] = 0
    return data


def random_rays(seed, n, res, h, w):
    """Rays from inside and just outside the map; the first blocks run
    along the axes, start on cell edges, or point diagonally."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, np.array([w, h]) * res + 0.5, (n, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n)
    d = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    q = n // 8
    d[:q] = [1.0, 0.0]
    d[q:2 * q] = [0.0, -1.0]
    src[2 * q:3 * q] = np.round(src[2 * q:3 * q] / res) * res  # on cell corners
    d[3 * q:4 * q] = np.float32(np.sqrt(0.5)) * np.array([1.0, -1.0], np.float32)
    return src, d


def far_edge_rays(src, d, max_range, res):
    """Rays whose far point lies within one float32 ulp of a cell edge."""
    far = src + np.float32(max_range) * d
    cells = far / np.float32(res)
    return np.abs(cells - np.round(cells)).max(-1) <= 4 * np.spacing(np.abs(cells)).max(-1)


@pytest.mark.parametrize("variant", ["standard", "supercover"])
@pytest.mark.parametrize("seed,res,max_range", [(0, 0.1, 2.0), (1, 0.1, 8.0), (2, 0.05, 100.0),
                                                (3, 0.25, 3.0)])
def test_cast_rays_match_reference(variant, seed, res, max_range):
    data = random_map(seed)
    src, d = random_rays(seed, 2400, res, *data.shape)
    jd, jh = j_cast_rays(j_make_grid(data, res), jnp.asarray(src), jnp.asarray(d), max_range,
                         variant=variant)
    td, th = raycast.cast_rays(make_grid(data, res, device="cpu"), torch.as_tensor(src),
                               torch.as_tensor(d), max_range, variant=variant)
    jd, jh, td, th = np.asarray(jd), np.asarray(jh), td.numpy(), th.numpy()
    flips = np.nonzero(jh != th)[0]
    edge = far_edge_rays(src, d, max_range, res)
    assert edge[flips].all(), f"hit flags differ away from a far-cell edge: {flips[~edge[flips]]}"
    same = jh == th
    assert 0.2 < th.mean() < 0.95  # both hits and misses
    np.testing.assert_array_max_ulp(td[same], jd[same], maxulp=2)
    assert (td[~th] == np.float32(max_range)).all()


def test_source_in_an_obstacle_hits_at_zero_and_outside_misses():
    data = np.zeros((40, 50), np.int8)
    data[-1, :] = data[10, 10] = OCCUPIED_VALUE
    grid = make_grid(data, 0.1, device="cpu")
    src = torch.tensor([[1.05, 1.05], [-0.3, 2.0], [2.0, 3.5]])
    d = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0]])
    for variant in raycast.VARIANTS:
        dist, hit = raycast.cast_rays(grid, src, d, 5.0, variant=variant)
        assert hit.tolist() == [True, False, True]
        assert dist[0] == 0.0 and dist[1] == 5.0


def test_supercover_sees_a_thin_diagonal_wall_the_standard_line_skips():
    """A wall of single cells on the anti-diagonal: the standard line
    steps through its corners, the supercover line does not."""
    data = np.zeros((20, 20), np.int8)
    for i in range(20):
        data[i, 19 - i] = OCCUPIED_VALUE
    grid = make_grid(data, 0.1, device="cpu")
    src = torch.tensor([[0.05, 0.05]])
    d = torch.tensor([[np.sqrt(0.5), np.sqrt(0.5)]], dtype=torch.float32)
    _, hit_std = raycast.cast_rays(grid, src, d, 1.8)
    dist, hit_sc = raycast.cast_rays(grid, src, d, 1.8, variant="supercover")
    assert not bool(hit_std[0]) and bool(hit_sc[0]) and float(dist[0]) < 1.4


def test_broadcast_rays_and_the_cpu_path_launch_nothing():
    """Sources ``[H, W, 2]`` against directions ``[K, 1, 1, 2]`` (the range
    LUT build) give ``[K, H, W]``; the CPU path counts no launch; an
    unknown variant raises."""
    data = random_map(5, 12, 14)
    grid = make_grid(data, 0.1, device="cpu")
    src = torch.rand(12, 14, 2) * 1.2
    dirs = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]])[:, None, None, :]
    before = raycast.launches
    dist, hit = raycast.cast_rays(grid, src[None], dirs, 2.0)
    assert dist.shape == hit.shape == (3, 12, 14) and raycast.launches == before
    d1, h1 = raycast.cast_rays(grid, src, dirs[1].expand(12, 14, 2), 2.0)
    assert torch.equal(d1, dist[1]) and torch.equal(h1, hit[1])
    with pytest.raises(ValueError, match="variant"):
        raycast.cast_rays(grid, src, dirs[0, 0, 0], 2.0, variant="dda")


def test_num_steps_is_the_reference_bound():
    assert raycast.num_steps(100.0, 0.05) == 2002
    assert raycast.num_steps(4.0, 0.05) == 82
    assert raycast.num_steps(60.0, 0.1) == 602
