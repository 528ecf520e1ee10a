"""The host side of kernel B2's CDF and one-tile entries
(``beluga_tpu_torch/ops/cuda_resample.py``): which entry ``resample_take``
takes, how the CDF kernel's launch is planned (tiles, grid, the wait and
the scratch) for a card of a given SM count, the scratch kept between
calls, and the errors the wrapper raises for what a kernel refuses.  None
of it needs a card; the kernels themselves are held by
``tests/test_torch_cuda.py`` on one.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from beluga_tpu_torch.ops import _build
from beluga_tpu_torch.ops import cuda_pool_take as b3
from beluga_tpu_torch.ops import cuda_resample as b2

torch.set_num_threads(1)

TILE = b2.TILE


def test_tile_is_the_kernels():
    """The wrapper plans for csrc/resample.cu's tile of 512 threads x 8
    weights (checked against the library when it loads)."""
    assert TILE == 4096


@pytest.mark.parametrize("n,one", [(1, True), (2000, True), (TILE, True), (TILE + 1, False),
                                   (10001, False), (2097152, False)])
def test_resample_take_takes_the_one_tile_entry_up_to_a_tile(n, one):
    assert b2.one_launch_take(n) is one


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
@pytest.mark.parametrize("n", [TILE, TILE + 1])
def test_resample_take_on_the_cpu_is_the_plain_version_on_either_side_of_a_tile(lead, n):
    """On CPU tensors both routes are the plain whole function, for one
    filter or several, and no kernel counter moves."""
    rng = np.random.default_rng(n + len(lead))
    w = torch.as_tensor(rng.random((*lead, n)).astype(np.float32) ** 4)
    w[..., n // 3 : n // 2] = 0.0
    pos = torch.as_tensor(np.sort(rng.random((*lead, 97)), axis=-1).astype(np.float32))
    pos[..., -3:] = 1.5
    values = torch.as_tensor(rng.standard_normal((*lead, 4, n)).astype(np.float32))
    counts = (b2.launches, b2.tile_launches, b2.cdf_launches, b2.sum_launches)
    got = b2.resample_take(w, pos, values)
    assert (b2.launches, b2.tile_launches, b2.cdf_launches, b2.sum_launches) == counts
    assert torch.equal(got, b2.resample_take_reference(w, pos, values))
    assert not got[..., -3:, :].any()


@pytest.mark.parametrize("n,filters,sms,per_sm,want", [
    # one tile: a block a filter, no wait, no scratch
    (1, 1, 132, 4, (1, 1, False, ())),
    (2001, 1, 132, 4, (1, 1, False, ())),
    (TILE, 64, 132, 4, (1, 64, False, ())),
    # past one tile: every (filter, tile) its block while the card holds them
    (TILE + 1, 1, 132, 4, (2, 2, True, (1, 6))),
    (TILE + 1, 64, 132, 4, (2, 128, True, (64, 6))),
    (10001, 1, 132, 4, (3, 3, True, (1, 8))),
    (262145, 1, 132, 4, (65, 65, True, (1, 132))),
    (2097152, 1, 132, 4, (512, 512, True, (1, 1026))),
    # past the co-resident grid: as many blocks as the card holds, each looping
    (2097152, 1, 132, 3, (512, 396, True, (1, 1026))),
    (8193, 300, 132, 4, (3, 528, True, (300, 8))),
    (262144, 64, 132, 4, (64, 528, True, (64, 130))),
    (TILE + 1, 64, 16, 2, (2, 32, True, (64, 6))),
])
def test_cdf_plan(n, filters, sms, per_sm, want):
    """The grid a filter a block at one tile; past it every (filter, tile)
    item a block while the card holds them all at once, else the card's
    co-resident blocks, each looping over items (grid < items)."""
    plan = b2.cdf_plan(n, filters, sms, per_sm)
    assert (plan.tiles, plan.grid, plan.wait, plan.scratch) == want
    assert plan.grid <= plan.tiles * filters
    if plan.wait:
        assert plan.grid == min(plan.tiles * filters, sms * per_sm)


@pytest.mark.parametrize("sms,per_sm", [(132, 0), (0, 4)])
def test_cdf_plan_refuses_a_card_that_holds_no_waiting_block(sms, per_sm):
    """A grid whose blocks wait for each other must fit the card at once;
    a filter of one tile waits for nothing and needs no such room."""
    with pytest.raises(RuntimeError, match="no grid can wait for itself"):
        b2.cdf_plan(TILE + 1, 1, sms, per_sm)
    assert b2.cdf_plan(TILE, 1, sms, per_sm).grid == 1


def test_scratch_is_kept_between_calls_and_one_set_a_stream(monkeypatch):
    """The flags' words: made zero once for a (card, stream, tiles), kept
    for later calls (no call resets them), reused by fewer filters, made
    anew (zero) for more, and never shared between two streams."""
    monkeypatch.setattr(b2, "_words", {})
    dev = torch.device("cpu")
    plan = b2.cdf_plan(TILE + 1, 4, 132, 4)
    words = b2._scratch(dev, 7, plan)
    assert words.dtype == torch.int64 and tuple(words.shape) == plan.scratch == (4, 6)
    assert not words.any()
    words[0, 0] = 5  # an epoch a launch left
    assert b2._scratch(dev, 7, plan) is words
    assert b2._scratch(dev, 7, b2.cdf_plan(TILE + 1, 2, 132, 4)) is words
    other = b2._scratch(dev, 8, plan)
    assert other is not words and not other.any()
    more = b2._scratch(dev, 7, b2.cdf_plan(TILE + 1, 9, 132, 4))
    assert tuple(more.shape) == (9, 6) and not more.any()
    assert b2._scratch(dev, 7, plan) is more
    longer = b2._scratch(dev, 7, b2.cdf_plan(3 * TILE, 4, 132, 4))
    assert tuple(longer.shape) == (4, 8) and longer is not more


@pytest.mark.parametrize("err", [0, 1, 720])
@pytest.mark.parametrize("entry", [b2._cdf, b3._take], ids=["resample", "pool_take"])
def test_a_refused_launch_raises(monkeypatch, entry, err):
    """A nonzero cudaError from a C entry (a cooperative grid the card
    cannot hold: 720; a grid the kernel does not take: 1) raises, naming
    the call; 0 does not.  The entry binds to a stand-in library whose
    entry returns ``err``."""
    calls = []

    def c_entry(*args):
        calls.append(args)
        return err

    lib = SimpleNamespace(**{entry.symbol: c_entry}, beluga_cdf_tile=lambda: TILE)
    monkeypatch.setitem(_build._loaded, entry.library, lib)
    monkeypatch.setattr(entry, "_fn", None)
    if err == 0:
        entry(1, 2)
    else:
        with pytest.raises(RuntimeError, match=f"^{entry.what} failed: cudaError {err}$"):
            entry(1, 2)
    assert calls == [(1, 2)]


@pytest.mark.parametrize("bad,match", [
    (lambda: b2.monotone_cdf(torch.ones(3, TILE + 1, dtype=torch.float64)), "float32"),
    (lambda: b2.running_sum(torch.ones(2, 2 * TILE)[:, ::2]), "contiguous"),
    (lambda: b2.running_sum(torch.ones(b2.MAX_FILTERS + 1, 2)), "at most"),
    (lambda: b2.monotone_cdf(torch.ones(4, 0)), "N > 0"),
    (lambda: b2.resample_take(torch.ones(2, TILE), torch.zeros(3, 5), torch.zeros(2, 4, TILE)),
     "filter axes"),
])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(bad, match):
    """The checks the CDF and one-tile entries share on both devices."""
    with pytest.raises(ValueError, match=match):
        bad()
