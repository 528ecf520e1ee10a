"""The sparse cluster estimate (N > 4096 in ``"auto"``) against the JAX
package's sparse form, against the port's dense form on the same input,
and through a node of 5000 particles, on the CPU.

Tolerances: the same cluster (mean within 1e-5 m and rad); covariance
within 1e-5 absolute: the port sums each cell's particles and then each
cluster's cells, the reference each cluster's particles, in another
order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.algorithms import cluster as J
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu_torch.algorithms.cluster import DENSE_MAX, cluster_based_estimate
from beluga_tpu_torch.algorithms.estimation import estimate_se2
from beluga_tpu_torch.io.config import AmclNodeConfig
from beluga_tpu_torch.lie import SE2
from beluga_tpu_torch.maps.occupancy import OCCUPIED_VALUE, make_grid
from beluga_tpu_torch.node import AmclNode

torch.set_num_threads(1)

TOL = 1e-5


def blobs(n, seed, dead=0.1):
    """Two weighted blobs and a thin uniform background, the last ``dead``
    share of the slots masked out."""
    rng = np.random.default_rng(seed)
    a, b = int(0.55 * n), int(0.3 * n)
    xyt = np.concatenate([
        rng.normal([1.0, 1.0, 0.3], [0.3, 0.3, 0.2], (a, 3)),
        rng.normal([4.0, 2.0, -1.0], [0.4, 0.4, 0.3], (b, 3)),
        np.stack([rng.uniform(-2, 8, n - a - b), rng.uniform(-2, 6, n - a - b),
                  rng.uniform(-np.pi, np.pi, n - a - b)], -1),
    ]).astype(np.float32)
    xyt = xyt[rng.permutation(n)]
    w = rng.random(n).astype(np.float32)
    mask = np.ones(n, bool)
    mask[n - int(dead * n):] = False
    return xyt, w, mask


def both(xyt):
    return (JSE2.from_xytheta(*(jnp.asarray(xyt[:, i]) for i in range(3))),
            SE2.from_xytheta(*(torch.as_tensor(xyt[:, i]) for i in range(3))))


def same(got, want):
    (m, c), (jm, jc) = got, want
    np.testing.assert_allclose(m.xy.numpy(), np.asarray(jm.xy), rtol=0, atol=TOL)
    np.testing.assert_allclose(m.rot.z.numpy(), np.asarray(jm.rot.z), rtol=0, atol=TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,seed,dead", [(600, 0, 0.1), (5000, 1, 0.1), (9000, 2, 0.0),
                                         (6000, 3, 0.5)])
def test_sparse_matches_reference_sparse(n, seed, dead):
    xyt, w, mask = blobs(n, seed, dead)
    jst, st = both(xyt)
    want = J.cluster_based_estimate(jst, jnp.asarray(w), jnp.asarray(mask), method="sparse")
    got = cluster_based_estimate(st, torch.as_tensor(w), torch.as_tensor(mask), method="sparse")
    same(got, want)
    if n > DENSE_MAX:  # "auto" takes the sparse form above 4096
        auto = cluster_based_estimate(st, torch.as_tensor(w), torch.as_tensor(mask))
        assert torch.equal(auto[0].xy, got[0].xy) and torch.equal(auto[1], got[1])


@pytest.mark.parametrize("n,seed", [(257, 4), (2000, 5), (4096, 6)])
def test_sparse_equals_dense(n, seed):
    """At node sizes both forms pick the same cluster; moments within TOL."""
    xyt, w, mask = blobs(n, seed)
    _, st = both(xyt)
    args = (st, torch.as_tensor(w), torch.as_tensor(mask))
    dm, dc = cluster_based_estimate(*args, method="dense")
    sm, sc = cluster_based_estimate(*args, method="sparse")
    np.testing.assert_allclose(sm.xy.numpy(), dm.xy.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(sm.rot.z.numpy(), dm.rot.z.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(sc.numpy(), dc.numpy(), rtol=TOL, atol=TOL)


def test_sparse_edge_cases():
    """Every particle alone in its cell: the plain estimate; one live
    particle left; two calls give the same bits."""
    n = 5000
    x = np.arange(n, dtype=np.float32) * 0.5
    st = SE2.from_xytheta(torch.as_tensor(x), torch.zeros(n), torch.zeros(n))
    w = torch.rand(n, generator=torch.Generator().manual_seed(0))
    m, c = cluster_based_estimate(st, w, method="sparse")
    pm, pc = estimate_se2(st, w)
    assert torch.equal(m.xy, pm.xy) and torch.equal(c, pc)
    mask = torch.zeros(n, dtype=torch.bool)
    mask[7] = True
    m, _ = cluster_based_estimate(st, w, mask, method="sparse")
    np.testing.assert_allclose(m.xy.numpy(), [x[7], 0.0], atol=1e-6)
    xyt, w, mask = blobs(6000, 7)
    _, st = both(xyt)
    args = (st, torch.as_tensor(w), torch.as_tensor(mask))
    a, b = cluster_based_estimate(*args), cluster_based_estimate(*args)
    assert torch.equal(a[0].xy, b[0].xy) and torch.equal(a[1], b[1])


def test_node_at_5000_particles():
    """A node whose ``max_particles`` is above 4096 runs (the reference node
    always takes the cluster estimate), and its estimate is the sparse form
    of its particles."""
    data = np.zeros((60, 60), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[20:28, 30:36] = OCCUPIED_VALUE
    cfg = AmclNodeConfig(max_particles=5000, min_particles=5000, set_initial_pose=True,
                         initial_pose_x=2.0, initial_pose_y=2.0)
    node = AmclNode(cfg, device="cpu", seed=1)
    node.set_map(make_grid(data, 0.1, device="cpu"))
    ang = np.linspace(-np.pi, np.pi, 40, endpoint=False)
    pts = np.stack([1.5 * np.cos(ang), 1.5 * np.sin(ang)], -1).astype(np.float32)
    r = node.handle_scan((0.0, 0.0, 0.0), pts)
    assert r.valid and np.isfinite(r.pose).all()
    p = node._state.particles
    m, _ = cluster_based_estimate(p.state, p.weight, p.mask, method="sparse")
    np.testing.assert_allclose(r.pose[:2], m.xy.numpy(), atol=1e-6)
    assert np.hypot(r.pose[0] - 2.0, r.pose[1] - 2.0) < 0.9
