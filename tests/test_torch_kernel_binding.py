"""The binding between the ``ops/`` wrappers and ``csrc/``
(``beluga_tpu_torch/ops/_build.py``): a declared C entry binds only at its
first call, checks the library constants its wrapper plans for, and every
wrapper sends a tensor's device through one rule (CUDA to the kernel, CPU
to the plain version, any other refused).  None of it needs a card: the
entries bind to stand-in libraries.  A refused launch is
``tests/test_torch_resample_plan.py:test_a_refused_launch_raises``.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from beluga_tpu_torch.lie import SE2, SO2
from beluga_tpu_torch.ops import (
    _build,
    cuda_beam,
    cuda_beam_lut,
    cuda_codebook,
    cuda_estimate,
    cuda_fused_step,
    cuda_ndt,
    cuda_pool_take,
    cuda_resample,
    cuda_reweight,
    cuda_scan_lut,
    cuda_winlut,
    raycast,
)

torch.set_num_threads(1)


def test_an_entry_binds_at_its_first_call_and_not_before(monkeypatch):
    argtypes = [ctypes.c_void_p, ctypes.c_int]
    entry = _build.Entry("stand_in", "beluga_stand_in", argtypes, "stand-in launch")
    assert not entry.bound and "stand_in" not in _build._loaded
    calls = []
    lib = SimpleNamespace(beluga_stand_in=lambda *args: calls.append(args) or 0)
    monkeypatch.setitem(_build._loaded, "stand_in", lib)
    assert not entry.bound and not calls  # a library loaded by another entry binds nothing
    entry(None, 3)
    assert entry.bound and calls == [(None, 3)] and entry.bind() is lib.beluga_stand_in
    assert lib.beluga_stand_in.argtypes == argtypes
    assert lib.beluga_stand_in.restype is ctypes.c_int


@pytest.mark.parametrize("entry,constant,value", [
    (cuda_resample._cdf, "beluga_cdf_tile", cuda_resample.TILE),
    (cuda_resample._take_tile, "beluga_cdf_tile", cuda_resample.TILE),
    (cuda_estimate._estimate, "beluga_estimate_threads", cuda_estimate.THREADS),
], ids=["cdf", "take_tile", "estimate"])
def test_an_entry_checks_the_constants_its_wrapper_plans_for(monkeypatch, entry, constant,
                                                             value):
    """The library's constant is read when the entry binds: the value the
    wrapper plans for binds, another refuses, and the entry stays unbound."""
    monkeypatch.setattr(entry, "_fn", None)
    for got in (2 * value, value):
        lib = SimpleNamespace(**{entry.symbol: lambda *args: 0, constant: lambda: got})
        monkeypatch.setitem(_build._loaded, entry.library, lib)
        if got != value:
            with pytest.raises(RuntimeError, match=rf"{constant}\(\) is {got}, the wrapper "
                                                   rf"plans for {value}"):
                entry.bind()
            assert not entry.bound
        else:
            assert entry.bind() is getattr(lib, entry.symbol)


@pytest.mark.parametrize("device,kernel", [("cpu", False), ("cuda", True), ("cuda:1", True)])
def test_cuda_goes_to_the_kernel_and_cpu_to_the_plain_version(device, kernel):
    assert _build.on_card(torch.device(device)) is kernel


def _meta(*shapes_dtypes):
    return [torch.empty(shape, dtype=dtype, device="meta") for shape, dtype in shapes_dtypes]


F32, I32, I64, U8, BOOL, BF16 = (torch.float32, torch.int32, torch.int64, torch.uint8,
                                 torch.bool, torch.bfloat16)


def _states(*lead):
    xy, z = _meta(((*lead, 2), F32), ((*lead, 2), F32))
    return SE2(xy, SO2(z))


def _grid():
    """What the R1 wrappers read of an ``OccupancyGrid`` before the rule."""
    return SimpleNamespace(data=_meta(((8, 8), U8))[0], resolution=0.1)


def _lut():
    """What the states entry reads of a ``WindowedScanLut`` before the rule."""
    x0, y0, theta0, values_t = _meta(((), I64), ((), I64), ((), F32), ((4, 6, 6), BF16))
    return SimpleNamespace(world_to_field=_states(), x0=x0, y0=y0, theta0=theta0,
                           values_t=values_t, scale=None)


MIX = (8.0, 0.5, 0.05, 0.05, 0.4, 0.2, 0.1)
WRAPPERS = {
    "sphere_trace_beam_weights": lambda: cuda_beam.sphere_trace_beam_weights(
        *_meta(((8, 8), U8), ((4,), F32), ((4,), F32), ((4,), F32), ((4,), F32),
               ((3, 2), F32), ((3,), F32), ((3,), BOOL)), 0.05, MIX),
    "device_window_origins": lambda: cuda_beam_lut.device_window_origins(
        *_meta(((2, 5), I32), ((2, 5), I32)), 128, 40),
    "beam_lut_windowed": lambda: cuda_beam_lut.beam_lut_windowed(
        *_meta(((128, 40, 4), BF16), ((2, 5), F32), ((2, 5), I32), ((2, 5), I32),
               ((2, 3), F32), ((2, 3), F32), ((2, 3), BOOL)), 8.0, MIX),
    "codebook_lookup": lambda: cuda_codebook.codebook_lookup(
        *_meta(((4, 4), U8), ((3,), F32), ((5,), I32), ((5,), I32))),
    "fused_propagate_winlut": lambda: cuda_fused_step.fused_propagate_winlut(
        *_meta(((4,), F32), ((4,), F32), ((4,), F32), ((3, 4), F32), ((8, 4, 4), BF16),
               ((cuda_fused_step.NUM_SCALARS,), F32))),
    "ndt_probe": lambda: cuda_ndt.ndt_probe(
        *_meta(((4,), I64), ((4, 6), F32)), 2, *_meta(((5,), I64))),
    "ndt_weights": lambda: cuda_ndt.ndt_weights(
        *_meta(((4,), I64), ((4, 6), F32)), 2, 1.0,
        *_meta(((3, 2, 2), F32), ((3, 2), F32), ((5, 2), F32), ((5, 2, 2), F32), ((5,), BOOL)),
        np.zeros((1, 2), np.int32)),
    "pool_take": lambda: cuda_pool_take.pool_take(*_meta(((6, 2), F32), ((5,), I32))),
    "monotone_cdf": lambda: cuda_resample.monotone_cdf(*_meta(((2, 8), F32))),
    "running_sum": lambda: cuda_resample.running_sum(*_meta(((8,), F32))),
    "search_take": lambda: cuda_resample.search_take(
        *_meta(((8,), F32), ((3,), F32), ((2, 8), F32))),
    "resample_take": lambda: cuda_resample.resample_take(
        *_meta(((8,), F32), ((3,), F32), ((2, 8), F32))),
    "fused_reweight": lambda: cuda_reweight.fused_reweight(
        *_meta(((4, 4), U8), ((3,), F32), ((5,), F32), ((5,), F32), ((5,), F32), ((5,), F32),
               ((3, 2), F32), ((3,), BOOL)), 0.05, 0.1),
    "fused_reweight_states": lambda: cuda_reweight.fused_reweight_states(
        *_meta(((4, 4), U8), ((3,), F32)), _states(), _states(5),
        *_meta(((3, 2), F32), ((3,), BOOL)), 0.05, 0.1),
    "correlate": lambda: cuda_scan_lut.correlate(
        *_meta(((8, 8), F32), ((2, 3, 2), I32), ((2, 3, 3), F32))),
    "scan_lut_correlate": lambda: cuda_scan_lut.scan_lut_correlate(
        *_meta(((8, 8), F32), ((3, 2), F32), ((3,), BOOL)), 0.05, 4),
    "winlut_lookup": lambda: cuda_winlut.winlut_lookup(
        *_meta(((4, 6, 6), BF16), ((5,), F32), ((5,), F32), ((5,), F32)), 0.0),
    "winlut_lookup_states": lambda: cuda_winlut.winlut_lookup_states(_lut(), _states(5), 0.0),
    "winlut_coverage_states": lambda: cuda_winlut.winlut_coverage_states(
        SimpleNamespace(world_to_field=_states()), _states(5), *_meta(((), F32), ((), F32),
                                                                       ((), F32))),
    "cast_rays": lambda: raycast.cast_rays(_grid(), *_meta(((5, 2), F32), ((5, 2), F32)), 1.0),
    "exact_beam_weights": lambda: raycast.exact_beam_weights(
        _grid(), _states(5), *_meta(((3, 2), F32), ((3,), BOOL)),
        cuda_beam.mixture(0.5, 0.05, 0.05, 0.4, 0.2, 0.1, 8.0), 8.0),
}


@pytest.mark.parametrize("call", WRAPPERS.values(), ids=WRAPPERS.keys())
def test_a_wrapper_refuses_an_unsupported_device(call):
    """Inputs that pass every other check, on a device that is neither
    CUDA nor CPU: refused by the rule, before any kernel library loads."""
    loaded = set(_build._loaded)
    with pytest.raises(ValueError, match="unsupported device meta"):
        call()
    assert set(_build._loaded) == loaded
