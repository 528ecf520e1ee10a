"""The states entry of kernels B1 and B4 (``fused_reweight_states``: the
particle states and the field's ``world_to_field``, composed in the
kernel) and the likelihood-field models that call it, held against the
JAX package on the CPU.  On CPU tensors the entry runs its plain version:
``lie.py``'s composition, then the plain B1 or B4.

Inputs are made with numpy from fixed seeds: a 96x96 map at 5 cm with an
unknown patch (nav2-default field), a cloud spread over and beyond the
map (endpoints off it) and converged clouds, 23-beam scans with masked
beams; one filter ``[N]`` and fleets of 3 filters ``[3, N]``, each filter
with its own scan (the reference runs filter by filter).  Tolerances:

* cells: the port's composition of the reference's states equals the
  reference's ``world_to_field @ states`` bit for bit, and so does every
  cell ``floor(x / res)`` (XLA may contract ``SE2``'s products into FMAs,
  as test_torch_field.py's module docstring says of ``origin.inverse()``;
  its CPU backend does not here, as test_torch_field.py found for the
  cells);
* B1 against the reference's XLA code-table path and against
  ``fused_reweight(interpret=True)`` on the reference's transform: atol
  2e-5, the beam sum's order (as test_torch_field.py);
* B1-log against the reference's float-table log weights: atol 2e-5, and
  against ``fused_reweight(interpret=True, log_space=True)``: atol 1e-4,
  the reference's own bound (as test_torch_prob.py);
* B4 and B4-log against the reference's per-beam-window fast path on
  converged clouds, where it reads the same bf16 entries: rtol 1e-5; B4
  against the exact weights within 5e-3 relative, B4-log within
  ``Σ_b |log pz_b| · 2⁻⁸`` (bf16 keeps 8 significant bits, as
  test_torch_prob.py);
* the entry's plain version against the transform entry's on the same
  composition: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beluga_tpu.filters.builders import _make_field_codes as j_make_field_codes
from beluga_tpu.lie import SE2 as JSE2
from beluga_tpu.maps.occupancy import OCCUPIED_VALUE
from beluga_tpu.maps.occupancy import make_grid as j_make_grid
from beluga_tpu.models.sensor import likelihood_field as JLF
from beluga_tpu.ops.pallas_reweight import build_values3 as j_build_values3
from beluga_tpu.ops.pallas_reweight import fused_reweight as j_fused_reweight
from beluga_tpu_torch import convert
from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.models.sensor import likelihood_field as PLF
from beluga_tpu_torch.ops import cuda_reweight as b1

torch.set_num_threads(1)

BATCH = 3


def small_map():
    data = np.zeros((96, 96), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = OCCUPIED_VALUE
    data[40:44, 60:66] = OCCUPIED_VALUE
    data[20:23, 30:50] = OCCUPIED_VALUE
    data[10:14, 10:12] = -1
    return data


@pytest.fixture(scope="module")
def case():
    """Both packages' nav2-default field, code table and bf16 tables."""
    params = JLF.LikelihoodFieldParams()
    jgrid = j_make_grid(small_map(), 0.05)
    jfield = JLF.make_likelihood_field(params, jgrid)
    jcodes, jbook = j_make_field_codes(jfield, params, jgrid)
    codes, book = convert.field_codes(jax.device_get((jcodes, jbook)))
    return dict(jfield=jfield, jcodes=jcodes, jbook=jbook,
                jv3={log: j_build_values3(jcodes, jbook, log_space=log) for log in (False, True)},
                field=convert.field(jax.device_get(jfield)), codes=codes, book=book,
                v3={log: b1.build_values3(codes, book, log_space=log) for log in (False, True)})


def clouds(spread, lead, n, seed):
    """``x, y, theta`` float32 ``[*lead, n]``: spread over and beyond the
    4.8 m map, or converged about a pose of each filter."""
    rng = np.random.default_rng(seed)
    if spread == "diverged":
        xyt = (rng.uniform(-1.0, 5.8, (*lead, n)), rng.uniform(-1.0, 5.8, (*lead, n)),
               rng.uniform(-3.1, 3.1, (*lead, n)))
    else:
        cx = rng.uniform(1.5, 3.3, (*lead, 1))
        cy = rng.uniform(1.5, 3.3, (*lead, 1))
        xyt = (rng.normal(cx, 0.02, (*lead, n)), rng.normal(cy, 0.02, (*lead, n)),
               rng.normal(0.4, 0.01, (*lead, n)))
    return [np.asarray(v, np.float32) for v in xyt]


def scans(lead, b=23, seed=2):
    """Per filter, ``b`` endpoints within 1.9 m and ~10% masked beams
    (tests/test_gather2d.py:372-378)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(-2.0, 2.0, b)
    rr = rng.uniform(0.2, 1.9, (*lead, b))
    pts = np.stack([rr * np.cos(ang), rr * np.sin(ang)], -1).astype(np.float32)
    return pts, rng.random((*lead, b)) < 0.9


def reference(case, xyt, pts, mask, log_space, values3):
    """The reference's weights, filter by filter: ``(XLA path, Pallas kernel
    in interpret mode on the reference's transform, transform x y cos sin
    [*lead, 4, n], states)``, the states as the port's ``SE2`` (the
    reference's bits).  The XLA path reads the float table in log space and
    the code table otherwise; with ``values3`` the Pallas kernel takes its
    per-beam-window fast path."""
    jfield = case["jfield"]
    lead = xyt[0].shape[:-1]
    xla, pallas, tfs, xys, rots = [], [], [], [], []
    for f in np.ndindex(*lead):
        jst = JSE2.from_xytheta(*(jnp.asarray(v[f]) for v in xyt))
        jpts, jmask = jnp.asarray(pts[f]), jnp.asarray(mask[f])
        if log_space:
            xla.append(JLF.likelihood_field_prob_weights(jfield, jst, jpts, jmask,
                                                         lookup_mode="gather"))
        else:
            xla.append(JLF.likelihood_field_weights_codebook(
                jfield, (case["jcodes"], case["jbook"]), jst, jpts, jmask))
        jtf = jfield.world_to_field @ jst
        pallas.append(j_fused_reweight(
            case["jcodes"], case["jbook"], jtf.x, jtf.y, jtf.rot.cos, jtf.rot.sin, jpts, jmask,
            jfield.resolution, jfield.unknown_prob, interpret=True,
            values3=case["jv3"][log_space] if values3 else None, log_space=log_space))
        tfs.append(np.stack([np.asarray(v) for v in (jtf.x, jtf.y, jtf.rot.cos, jtf.rot.sin)]))
        xys.append(np.asarray(jst.xy))
        rots.append(np.asarray(jst.rot.z))
    shape = (*lead, -1)
    states = SE2(torch.as_tensor(np.stack(xys).reshape(*lead, -1, 2)),
                 SO2(torch.as_tensor(np.stack(rots).reshape(*lead, -1, 2))))
    return (np.stack([np.asarray(v) for v in xla]).reshape(shape),
            np.stack([np.asarray(v) for v in pallas]).reshape(shape),
            np.stack(tfs).reshape(*lead, 4, -1), states)


@pytest.mark.parametrize("lead", [(), (BATCH,)], ids=["filter", "fleet"])
@pytest.mark.parametrize("table", ["codes", "values3"])
@pytest.mark.parametrize("log_space", [False, True], ids=["cube", "log"])
def test_states_entry_matches_reference(case, log_space, table, lead):
    field = case["field"]
    values3 = case["v3"][log_space] if table == "values3" else None
    # the fast path is held on converged clouds, the exact path on a spread one
    xyt = clouds("converged" if values3 is not None else "diverged", lead, 150, seed=13)
    pts, mask = scans(lead)
    mask[(0,) * len(lead)][[1, 2]] = False  # masked beams in every case
    xla, pallas, jtf, states = reference(case, xyt, pts, mask, log_space, values3 is not None)
    rest = (torch.as_tensor(pts), torch.as_tensor(mask), field.resolution, field.unknown_prob)
    got = b1.fused_reweight_states(case["codes"], case["book"], field.world_to_field, states,
                                   *rest, values3=values3, log_space=log_space)
    assert got.shape == (*lead, 150) and bool(torch.isfinite(got).all())

    # the plain composition then the transform entry: bit-equal
    tf = field.world_to_field @ states
    particles = [v.contiguous() for v in (tf.x, tf.y, tf.rot.cos, tf.rot.sin)]
    assert torch.equal(got, b1.fused_reweight(case["codes"], case["book"], *particles, *rest,
                                              values3=values3, log_space=log_space))

    # the same transform bits as the reference's, so the same cells
    same = (np.stack([p.numpy() for p in particles], axis=-2) == jtf).all(axis=-2)
    fx, fy = b1.endpoint_cells(*particles, rest[0], field.resolution)
    jfx, jfy = b1.endpoint_cells(*(torch.as_tensor(np.ascontiguousarray(v))
                                   for v in np.moveaxis(jtf, -2, 0)), rest[0], field.resolution)
    assert same.all(), f"{int((~same).sum())} transforms differ"
    assert torch.equal(fx, jfx) and torch.equal(fy, jfy)

    if values3 is None:
        np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=1e-4 if log_space else 2e-5)
        inside = (fx >= 0) & (fx < 96) & (fy >= 0) & (fy < 96)
        assert bool(inside.any()) and not bool(inside.all())  # on and off the map
        return
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=0)
    exact = b1.fused_reweight_states(case["codes"], case["book"], field.world_to_field, states,
                                     *rest, log_space=log_space).numpy()
    np.testing.assert_allclose(exact, xla, rtol=0, atol=2e-5)
    if log_space:
        pz, m = PLF._field_lookup(field, states, *rest[:2])
        bound = torch.sum(torch.where(m, torch.log(pz).abs(), 0.0), dim=-1).numpy()
        assert (np.abs(got.numpy() - exact) <= bound * 2.0**-8 * (1 + 2.0**-7) + 1e-5).all()
    else:
        assert float(np.max(np.abs(got.numpy() - exact) / exact)) < 5e-3


def test_models_score_through_the_states_entry(case, monkeypatch):
    """The code-table models call the states entry once a scoring, with
    the states as they lie, and never the transform entry."""
    calls = {"states": 0, "transform": 0}
    states_entry, transform_entry = b1.fused_reweight_states, b1.fused_reweight

    def counted(key, fn):
        def inner(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return inner

    monkeypatch.setattr(b1, "fused_reweight_states", counted("states", states_entry))
    monkeypatch.setattr(b1, "fused_reweight", counted("transform", transform_entry))
    field, cb = case["field"], (case["codes"], case["book"])
    xyt = clouds("diverged", (BATCH,), 40, seed=3)
    states = SE2.from_xytheta(*map(torch.as_tensor, xyt))
    pts, mask = (torch.as_tensor(a) for a in scans((BATCH,)))
    tf = field.world_to_field @ states
    particles = [v.contiguous() for v in (tf.x, tf.y, tf.rot.cos, tf.rot.sin)]
    rest = (pts, mask, field.resolution, field.unknown_prob)
    for log_space in (False, True):
        for values3 in (None, case["v3"][log_space]):
            if log_space:
                got = PLF.likelihood_field_prob_weights(field, states, pts, mask, codes_book=cb,
                                                        values3=values3)
            else:
                got = PLF.likelihood_field_weights_codebook(field, cb, states, pts, mask,
                                                            values3=values3)
            want = (b1.fused_reweight_reference(*cb, *particles, *rest, log_space=log_space)
                    if values3 is None else
                    b1.fused_reweight_values3_reference(values3, *particles, *rest,
                                                        log_space=log_space))
            assert torch.equal(got, want)
    assert calls == {"states": 4, "transform": 0}


def test_states_entry_rejects_bad_inputs_and_caches_its_checks(case):
    field, cb = case["field"], (case["codes"], case["book"])
    xyt = clouds("diverged", (), 16, seed=1)
    states = SE2.from_xytheta(*map(torch.as_tensor, xyt))
    pts, mask = (torch.as_tensor(a) for a in scans(()))
    rest = (pts, mask, field.resolution, field.unknown_prob)
    w2f = field.world_to_field
    b1._plan.cache_clear()
    first = b1.fused_reweight_states(*cb, w2f, states, *rest)
    assert torch.equal(b1.fused_reweight_states(*cb, w2f, states, *rest), first)
    info = b1._plan.cache_info()
    assert (info.hits, info.misses) == (1, 1)
    wide = torch.cat([states.xy, states.xy], dim=-1)
    with pytest.raises(ValueError, match="contiguous"):
        b1.fused_reweight_states(*cb, w2f, SE2(wide[..., ::2], states.rot), *rest)
    with pytest.raises(ValueError, match="xy"):
        b1.fused_reweight_states(*cb, w2f, SE2(states.xy[:, :1].contiguous(), states.rot),
                                 *rest)
    with pytest.raises(ValueError, match="rot"):
        b1.fused_reweight_states(*cb, w2f, SE2(states.xy, SO2(states.rot.z[:8].contiguous())),
                                 *rest)
    with pytest.raises(ValueError, match="world_to_field"):
        b1.fused_reweight_states(*cb, SE2(w2f.xy[None], w2f.rot), states, *rest)
    with pytest.raises(ValueError, match="points"):
        b1.fused_reweight_states(*cb, w2f, states, pts[None].contiguous(), *rest[1:])
    with pytest.raises(ValueError, match="values3"):
        b1.fused_reweight_states(*cb, w2f, states, *rest, values3=case["v3"][False].float())
