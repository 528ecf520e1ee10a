"""The θ sort of ``sorted_slots`` filters on the CPU
(``filters/amcl.py:sort_slots``): every call here takes the plain path,
``se2_sort_key`` and ``tree_sort_by``, as it did before kernel S1
(``ops/cuda_sort.py``) and without loading it; the kernel wrapper's
dispatch rule and input checks, which need no card.  The cases and the
float64 z-scores are the ones the card tests (``tests/test_torch_sort_cuda.py``)
hold S1 to.

The module imports neither JAX nor the JAX package: the card tests import
its cases.
"""

import math

import numpy as np
import pytest
import torch

from beluga_tpu_torch.core.particles import ParticleSet, tree_sort_by
from beluga_tpu_torch.filters import amcl
from beluga_tpu_torch.lie import SE2, SE3, SO2
from beluga_tpu_torch.ops import _build, cuda_sort

STRAY_Z = 3.5  # filters/amcl.py:se2_sort_key


def sort_case(lead, n, seed, device="cpu"):
    """SE2 states ``[*lead, n]``, log-weights and active counts from the
    seed: strays in x (slots 0-5), y (6-8) and heading (9-11), runs of
    equal headings (20-23 as 30-33; 40-47), a ``-0.0`` heading (slot 50,
    ``+0.0`` in 51) and a ragged live prefix (every filter at least 64
    live slots short of ``n`` but the last, which is full)."""
    rng = np.random.default_rng(seed)
    b = math.prod(lead)
    x = rng.normal(rng.uniform(-20.0, 20.0, (b, 1)), 0.4, (b, n))
    y = rng.normal(rng.uniform(-20.0, 20.0, (b, 1)), 0.3, (b, n))
    th = rng.normal(rng.uniform(-math.pi, math.pi, (b, 1)), 0.3, (b, n))
    x[:, :6] += rng.choice([-4.0, 4.0], (b, 6))
    y[:, 6:9] += 3.0
    th[:, 9:12] += math.pi
    th[:, 20:24] = th[:, 30:34]
    th[:, 40:48] = th[:, 40:41]
    c, s = np.cos(th), np.sin(th)
    c[:, 50:52], s[:, 50], s[:, 51] = 1.0, -0.0, 0.0
    active = rng.integers(max(1, n // 2), n - 63, b) if n > 64 else np.full(b, n)
    active[-1] = n
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    states = SE2(f32(np.stack([x, y], -1)).reshape(*lead, n, 2),
                 SO2(f32(np.stack([c, s], -1)).reshape(*lead, n, 2)))
    log_w = f32(rng.normal(0.0, 1.0, (b, n))).reshape(*lead, n)
    return states, log_w, torch.as_tensor(active, dtype=torch.int32, device=device).reshape(lead)


def z_scores_float64(states: SE2):
    """``se2_sort_key``'s three z-scores, ``f64[..., N, 3]``, in float64 on
    the float32 states."""
    x, y = states.x.double(), states.y.double()
    c, s = states.rot.cos.double(), states.rot.sin.double()

    def centred(v):
        return v - v.mean(-1, keepdim=True)

    def sd(v):
        return v.std(-1, correction=0, keepdim=True) + 1e-6

    rc = torch.hypot(centred(c), centred(s))
    return torch.stack([centred(x).abs() / sd(x), centred(y).abs() / sd(y),
                        centred(rc) / sd(rc)], -1)


def plain_sort(models, particles, mask=None):
    """``sort_slots`` as it was before S1: the key, ``inf`` off the mask,
    one stable sort of the states and log-weights."""
    key_fn = models.sort_key or amcl.se2_sort_key
    keys = torch.where(particles.mask if mask is None else mask, key_fn(particles.state),
                       torch.inf)
    return tree_sort_by(keys, (particles.state, particles.log_weight))


MODELS = amcl.AmclModels(None, None, None, None, None)


@pytest.mark.parametrize("lead,n,how", [
    ((3,), 400, "default"), ((), 2000, "default"), ((2,), 4100, "default"),
    ((3,), 400, "custom_key"), ((3,), 400, "mask"), ((2,), 64, "default")])
def test_sort_slots_on_the_cpu_runs_the_plain_path(monkeypatch, lead, n, how):
    """On CPU tensors ``sort_slots`` (and ``DENSE.sort_slots``) give the
    plain path's bits, with the default key, a custom key and past 4096
    slots, as ``plain_sort_slots`` does with a mask of its own, and never
    load the kernel."""

    def refuse(name):
        raise AssertionError(f"the CPU path loaded csrc/{name}.cu")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(cuda_sort._sort, "_fn", None)
    states, log_w, active = sort_case(lead, n, seed=n + len(lead))
    particles = ParticleSet(states, log_w, active)
    models, mask = MODELS, None
    if how == "custom_key":
        models = MODELS._replace(sort_key=lambda st: -st.x)
    if how == "mask":  # the sharded update's: its own live slots
        mask = torch.arange(n) % 3 != 0
    before = cuda_sort.launches
    if mask is None:
        got = amcl.sort_slots(models, particles)
    else:
        got = amcl.plain_sort_slots(models, particles, mask)
    want_states, want_w = plain_sort(models, particles, mask)
    assert torch.equal(got.state.xy, want_states.xy)
    assert torch.equal(got.state.rot.z, want_states.rot.z)
    assert torch.equal(got.log_weight, want_w) and got.active is active
    if mask is None:
        dense = amcl.DENSE.sort_slots(models, particles)
        assert torch.equal(dense.state.xy, got.state.xy)
        assert torch.equal(dense.log_weight, got.log_weight)
    assert cuda_sort.launches == before
    # dead slots keep their order at the end; strays pool after the live keys
    dead = torch.arange(n) >= active[..., None]
    if mask is None:
        assert torch.equal(got.state.xy[dead], states.xy[dead])
    if how == "default":
        z = z_scores_float64(states)
        stray = (z > STRAY_Z).any(-1) & ~dead
        assert 0 < int(stray.sum()) < n * math.prod(lead) // 8


def spec(shape, strides=None, dtype=torch.float32, device=torch.device("cuda", 0)):
    if strides is None:
        strides = torch.empty(shape).stride() if shape else ()
    return (tuple(shape), tuple(strides), dtype, device)


def test_kernel_input_checks():
    """The wrapper's checks, on the inputs' shapes, strides, dtypes and
    devices alone (no card needed): float32 SE2 states and log-weights,
    int32 counts, 1 to 4096 slots a filter in dense rows, filter axes of
    one stride, one device; a clear error for each refusal."""
    layout = cuda_sort._layout.__wrapped__
    b, n = 4, 10
    xy, z, w, act = spec((b, n, 2)), spec((b, n, 2)), spec((b, n)), spec((b,), dtype=torch.int32)
    assert layout(xy, z, w, act) == ((b,), n, b, 2 * n, 2 * n, n, 1)
    # tree_scatter's result: rows of n + 1 slots cut to n
    cut = spec((b, n, 2), (2 * (n + 1), 2, 1))
    assert layout(cut, cut, w, act)[3:5] == (2 * (n + 1), 2 * (n + 1))
    # the node (no filter axis), two filter axes, a full tile of 4096
    assert layout(spec((n, 2)), spec((n, 2)), spec((n,)), spec((), dtype=torch.int32))[:3] == (
        (), n, 1)
    assert layout(spec((2, 3, n, 2)), spec((2, 3, n, 2)), spec((2, 3, n)),
                  spec((2, 3), dtype=torch.int32))[2] == 6
    m = cuda_sort.MAX_SLOTS
    assert layout(spec((b, m, 2)), spec((b, m, 2)), spec((b, m)), act)[1] == m
    for bad, match in (
            (dict(xy=spec((b, n, 2), dtype=torch.float64)), "float32"),
            (dict(w=spec((b, n), dtype=torch.float64)), "log-weights must be"),
            (dict(xy=spec((b, n, 2), (2 * n, 4, 1))), "contiguous"),  # every other slot
            (dict(z=spec((b, n, 2), (2 * n, 1, n))), "contiguous"),  # (cos, sin) apart
            (dict(w=spec((b, n), (n, 2))), "contiguous"),
            (dict(xy=spec((b, n, 2), device=torch.device("cpu"))), "CUDA"),
            (dict(z=spec((b, n, 2), device=torch.device("cuda", 1))), "is on"),
            (dict(w=spec((b, n - 1))), "log-weights must be"),
            (dict(active=spec((b,), dtype=torch.int64)), "active must be"),
            (dict(xy=spec((b, m + 1, 2)), z=spec((b, m + 1, 2)), w=spec((b, m + 1))),
             "slots a filter"),
            (dict(xy=spec((b, 0, 2)), z=spec((b, 0, 2)), w=spec((b, 0))), "slots a filter")):
        args = dict(xy=xy, z=z, w=w, active=act) | bad
        with pytest.raises(ValueError, match=match):
            layout(args["xy"], args["z"], args["w"], args["active"])
    with pytest.raises(ValueError, match="one stride"):
        layout(spec((2, 2, n, 2), (8 * n, 2 * n, 2, 1)), spec((2, 2, n, 2)), spec((2, 2, n)),
               spec((2, 2), dtype=torch.int32))


@pytest.mark.parametrize("what", ["cpu", "se3", "float64", "past_4096", "no_slots"])
def test_dispatch_rule_refuses_what_s1_does_not_take(what):
    """``takes`` asks the device, the group, the dtype and the slot count
    alone: never CPU tensors, SE3 or float64 states, more than 4096 slots
    or none; and the entry refuses CPU tensors with a clear error."""
    states, log_w, active = sort_case((2,), 64, seed=3)
    refused = {
        "cpu": states,
        "se3": SE3.identity((2, 64)),
        "float64": SE2(states.xy.double(), SO2(states.rot.z.double())),
        "past_4096": SE2.identity((2, cuda_sort.MAX_SLOTS + 1)),
        "no_slots": SE2.identity((2, 0)),
    }[what]
    assert not cuda_sort.takes(refused)
    if what == "cpu":
        with pytest.raises(ValueError, match="CUDA"):
            cuda_sort.sort_slots_se2(states, log_w, active)


def test_dispatch_rule_refuses_a_device_it_does_not_know():
    """States on a device that is neither the card nor the CPU raise in
    ``takes`` (``ops/_build.py:on_card``), before any layout is asked."""
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_sort.takes(SE2.identity((2, 64), device="meta"))
