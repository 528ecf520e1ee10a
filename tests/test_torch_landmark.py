"""The landmark and bearing sensor models, the unscented transform, the
scalar and vector estimates and the uniform SE2 box sampler of the port
against the JAX package's on the CPU, given the same inputs (numpy, from a
seed) and, for the sampler, the reference's own uniforms.

Tolerances: weights within 1e-5 relative (products of up to 8 Gaussian
terms, float32 rotations composed in the same order; the bearing model's
dot products are a matrix product in both); the estimates and the
transform within 1e-5; the sampler within 1e-6 absolute (XLA's fused
multiply-add in ``lo + u·(hi − lo)``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu import lie as jlie
from beluga_tpu.algorithms import estimation as j_est
from beluga_tpu.algorithms.unscented import unscented_transform as j_unscented
from beluga_tpu.core.random import sample_uniform_box_se2 as j_box_se2
from beluga_tpu.models.sensor import landmark as J
from beluga_tpu_torch.algorithms.estimation import estimate_scalar, estimate_vector
from beluga_tpu_torch.algorithms.unscented import unscented_transform
from beluga_tpu_torch.core.random import sample_uniform_box_se2, uniform_box_se2_from_draws
from beluga_tpu_torch.lie import SE2, SE3, SO3
from beluga_tpu_torch.models.sensor import landmark as P

torch.set_num_threads(1)

RTOL = 1e-5
N, D, L = 200, 8, 40


def landmarks(seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-5, 5, (L, 3)).astype(np.float32)
    pos[:, 2] *= 0.2
    cats = rng.integers(0, 3, L).astype(np.int32)  # categories 0-2; 3 has none
    return pos, cats


def detections(seed):
    rng = np.random.default_rng(seed + 100)
    det = rng.uniform(-3, 3, (D, 3)).astype(np.float32)
    det[:, 2] *= 0.1
    cats = rng.integers(0, 4, D).astype(np.int32)
    cats[0] = 3  # a category with no landmark
    mask = np.ones(D, bool)
    mask[-1] = False
    return det, cats, mask


def se2_states(seed):
    rng = np.random.default_rng(seed + 200)
    xyt = [rng.uniform(-2, 2, N).astype(np.float32), rng.uniform(-2, 2, N).astype(np.float32),
           rng.uniform(-np.pi, np.pi, N).astype(np.float32)]
    return jlie.SE2.from_xytheta(*map(jnp.asarray, xyt)), SE2.from_xytheta(*xyt)


def se3_states(seed):
    rng = np.random.default_rng(seed + 300)
    xyz = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    w = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    return (jlie.SE3(jnp.asarray(xyz), jlie.SO3.exp(jnp.asarray(w))),
            SE3(torch.as_tensor(xyz), SO3.exp(torch.as_tensor(w))))


def maps(seed):
    pos, cats = landmarks(seed)
    return J.make_landmark_map(pos, cats), P.make_landmark_map(pos, cats, device="cpu")


@pytest.mark.parametrize("space", ["se2", "se3"])
def test_landmark_weights(space):
    jmap, pmap = maps(0)
    det, cats, mask = detections(0)
    jst, st = (se2_states if space == "se2" else se3_states)(0)
    params = P.LandmarkModelParams(sigma_range=0.8, sigma_bearing=0.5, random_prob=1e-3)
    jparams = J.LandmarkModelParams(sigma_range=0.8, sigma_bearing=0.5, random_prob=1e-3)
    want = np.asarray(J.landmark_weights(jparams, jmap, jst, jnp.asarray(det),
                                         jnp.asarray(cats), jnp.asarray(mask)))
    got = P.landmark_weights(params, pmap, st, torch.as_tensor(det), torch.as_tensor(cats),
                             torch.as_tensor(mask)).numpy()
    assert got.shape == (N,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    # the detection of category 3 finds no landmark: random_prob alone
    only = np.zeros(D, bool)
    only[0] = True
    got = P.landmark_weights(params, pmap, st, torch.as_tensor(det), torch.as_tensor(cats),
                             torch.as_tensor(only)).numpy()
    np.testing.assert_allclose(got, np.float32(1e-3), rtol=1e-6)


def near_origin(space, seed):
    """States about the identity pose: SE2 within ~0.1 m / 0.1 rad, or SE3
    with rotations of ~0.05 rad."""
    rng = np.random.default_rng(seed + 400)
    if space == "se2":
        xyt = [(rng.normal(size=N) * 0.1).astype(np.float32) for _ in range(3)]
        return jlie.SE2.from_xytheta(*map(jnp.asarray, xyt)), SE2.from_xytheta(*xyt)
    xyz = (rng.normal(size=(N, 3)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(N, 3)) * 0.05).astype(np.float32)
    return (jlie.SE3(jnp.asarray(xyz), jlie.SO3.exp(jnp.asarray(w))),
            SE3(torch.as_tensor(xyz), SO3.exp(torch.as_tensor(w))))


@pytest.mark.parametrize("space,sensor", [("se2", False), ("se2", True), ("se3", True)])
def test_bearing_weights(space, sensor):
    """Bearings of D landmarks seen from the identity pose (through the
    sensor pose), scored at states about it; a detection of a category
    with no landmark weighs 0 in both."""
    pos, lcats = landmarks(1)
    jmap, pmap = J.make_landmark_map(pos, lcats), P.make_landmark_map(pos, lcats, device="cpu")
    jst, st = near_origin(space, 1)
    xyz, w = np.float32([0.2, -0.1, 0.3]), np.float32([0.0, 0.1, 0.4])
    if not sensor:
        xyz, w = np.zeros(3, np.float32), np.zeros(3, np.float32)
    jpose = jlie.SE3(jnp.asarray(xyz), jlie.SO3.exp(jnp.asarray(w))) if sensor else None
    ppose = SE3(torch.as_tensor(xyz), SO3.exp(torch.as_tensor(w))) if sensor else None
    seen = np.arange(D) * 3 % L
    inv = jlie.SE3(jnp.asarray(xyz), jlie.SO3.exp(jnp.asarray(w))).inverse()
    det = np.asarray(inv.act(jnp.asarray(pos[seen])))
    det = det + np.random.default_rng(5).normal(size=det.shape).astype(np.float32) * 0.02
    cats = lcats[seen].copy()
    mask = np.ones(D, bool)
    mask[-1] = False
    params, jparams = P.BearingModelParams(0.3), J.BearingModelParams(0.3)

    def both(cats):
        want = np.asarray(J.bearing_weights(jparams, jmap, jst, jnp.asarray(det),
                                            jnp.asarray(cats), jnp.asarray(mask), jpose))
        got = P.bearing_weights(params, pmap, st, torch.as_tensor(det), torch.as_tensor(cats),
                                torch.as_tensor(mask), ppose).numpy()
        return got, want

    got, want = both(cats)
    assert got.shape == (N,) and (want > 0).mean() > 0.9
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-30)
    cats[0] = 3  # no landmark of category 3
    got, want = both(cats)
    assert not got.any() and not want.any()


@pytest.mark.parametrize("custom", [False, True])
def test_unscented_transform(custom):
    rng = np.random.default_rng(2)
    mean = rng.normal(size=3).astype(np.float32)
    a = rng.normal(size=(3, 3)).astype(np.float32)
    cov = (a @ a.T + 0.5 * np.eye(3)).astype(np.float32)

    def jfn(p):
        return jnp.stack([p[:, 0] * p[:, 1], jnp.sin(p[:, 2]), p[:, 0] + p[:, 2] ** 2], -1)

    def pfn(p):
        return torch.stack([p[:, 0] * p[:, 1], torch.sin(p[:, 2]), p[:, 0] + p[:, 2] ** 2], -1)

    kw_j, kw_p = {}, {}
    if custom:  # an angle output: circular mean and wrapped residuals
        kw_j = dict(kappa=1.0,
                    mean_fn=lambda x, w: jnp.arctan2(w @ jnp.sin(x), w @ jnp.cos(x)),
                    residual_fn=lambda x, m: jnp.arctan2(jnp.sin(x - m), jnp.cos(x - m)))
        kw_p = dict(kappa=1.0,
                    mean_fn=lambda x, w: torch.atan2(w @ torch.sin(x), w @ torch.cos(x)),
                    residual_fn=lambda x, m: torch.atan2(torch.sin(x - m), torch.cos(x - m)))
    jm, jc = j_unscented(jnp.asarray(mean), jnp.asarray(cov), jfn, **kw_j)
    m, c = unscented_transform(torch.as_tensor(mean), torch.as_tensor(cov), pfn, **kw_p)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=RTOL, atol=RTOL)
    # a linear map is exact: A·mean and A·cov·Aᵀ
    lin = np.float32([[1.0, 2.0, 0.0], [0.0, -1.0, 3.0]])
    m, c = unscented_transform(torch.as_tensor(mean), torch.as_tensor(cov),
                               lambda p: p @ torch.as_tensor(lin).T)
    np.testing.assert_allclose(m.numpy(), lin @ mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), lin @ cov @ lin.T, rtol=1e-4, atol=1e-4)


def test_scalar_and_vector_estimates():
    rng = np.random.default_rng(3)
    v = rng.normal(2.0, 0.7, 300).astype(np.float32)
    vec = rng.normal(size=(300, 4)).astype(np.float32)
    w = rng.random(300).astype(np.float32)
    mask = rng.random(300) > 0.2
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.as_tensor(m)
        want = j_est.estimate_scalar(jnp.asarray(v), jnp.asarray(w), jm)
        got = estimate_scalar(torch.as_tensor(v), torch.as_tensor(w), tm)
        for g, x in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=RTOL)
        want = j_est.estimate_vector(jnp.asarray(vec), jnp.asarray(w), jm)
        got = estimate_vector(torch.as_tensor(vec), torch.as_tensor(w), tm)
        for g, x in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=RTOL, atol=1e-6)
    # filter axes: each filter its own estimate
    got = estimate_scalar(torch.as_tensor(np.stack([v, v + 1])), torch.as_tensor(np.stack([w, w])))
    np.testing.assert_allclose(got[0].numpy()[1] - got[0].numpy()[0], 1.0, rtol=1e-5)


def test_uniform_box_se2_from_reference_draws():
    key = jax.random.PRNGKey(4)
    lo, hi = np.float32([0.5, -1.0]), np.float32([5.9, 2.0])
    want = j_box_se2(key, 500, jnp.asarray(lo), jnp.asarray(hi))
    k_xy, k_th = jax.random.split(key)
    u = torch.as_tensor(np.asarray(jax.random.uniform(k_xy, (500, 2), jnp.float32)))
    u_th = torch.as_tensor(np.asarray(jax.random.uniform(k_th, (500,), jnp.float32)))
    got = uniform_box_se2_from_draws(u, u_th, lo, hi)
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(want.xy), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.rot.z.numpy(), np.asarray(want.rot.z), rtol=0, atol=1e-6)
    drawn = sample_uniform_box_se2(torch.Generator().manual_seed(0), 1000, lo, hi, lead=(2,))
    assert drawn.xy.shape == (2, 1000, 2)
    assert (drawn.xy >= torch.as_tensor(lo)).all() and (drawn.xy < torch.as_tensor(hi)).all()
