"""Kernels B1-B11 (with B1-log, B4-log and B6-int8, and B1 and B4 through
their states entry) and R1 of the PyTorch port on the card, against their
plain versions on the same card tensors,
and fleet, mega, beam, prob-model, shared-scan, NDT and VDB updates on the
card; the node's pinned staging, its pipelined mode and the replay on the
card; the sharded mega filter, fleet and checkpoint over NCCL at world
size 1; and the running sums and segment sums that must repeat bit for
bit (the sorted positions, ``search_indices``, ``sharded_cdf``, the NDT
measurement cells), each also within its stated bound of its plain
version.
Every test here needs an NVIDIA GPU and skips without one.  The module
imports neither JAX nor the JAX package, so on a machine with the card it
runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

BEAMS = 60


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def arena_inputs(n, dev, seed=0, batch=None):
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid

    data = synthetic.tracking_arena(384, 0.05)
    xs, ys, yaws = synthetic.circle_trajectory(1)
    pts, mask = synthetic.simulate_scans(data, 0.05, xs, ys, yaws, BEAMS)
    _, ctx = make_likelihood_field_filter(make_grid(data, 0.05, device=dev),
                                          AmclNodeConfig().likelihood_field_params(),
                                          device=dev)
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    xyt = rng.normal([xs[0], ys[0], yaws[0]], [1.0, 1.0, 0.5], (*lead, n, 3)).astype(np.float32)
    xyt[..., : n // 10, :2] = rng.uniform(-2, 21, (*lead, n // 10, 2))  # some off the map
    states = SE2.from_xytheta(xyt[..., 0], xyt[..., 1], xyt[..., 2], device=dev)
    tf = ctx["field"].world_to_field @ states
    codes, book = ctx["field_codes"]
    points = torch.as_tensor(pts[0]).to(dev).expand(*lead, BEAMS, 2).contiguous()
    beams = torch.as_tensor(mask[0]).to(dev).expand(*lead, BEAMS).contiguous()
    return (codes, book, tf.x.contiguous(), tf.y.contiguous(), tf.rot.cos.contiguous(),
            tf.rot.sin.contiguous(), points, beams, ctx["field"].resolution,
            ctx["field"].unknown_prob), states


def one_beam(mask):
    """The mask with only its first unmasked beam on: cells must be exact."""
    one = torch.zeros_like(mask)
    one[..., int(torch.nonzero(mask.reshape(-1, mask.shape[-1])[0])[0])] = True
    return one


@pytest.mark.parametrize("n,batch", [(2000, None), (65537, None), (4096, 64), (1000, 3)])
def test_b1_kernel_matches_plain_version(dev, n, batch):
    from beluga_tpu_torch.ops import cuda_reweight as b1

    args, _ = arena_inputs(n, dev, batch=batch)
    before = b1.launches
    single = (*args[:7], one_beam(args[7]), *args[8:])
    assert torch.equal(b1.fused_reweight(*single), b1.fused_reweight_reference(*single))
    got, want = b1.fused_reweight(*args), b1.fused_reweight_reference(*args)
    torch.cuda.synchronize()
    assert b1.launches == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)  # the beam-sum order


@pytest.mark.parametrize("n,batch", [(4096, 64), (262144, None), (777, 5)])
def test_b4_kernel_matches_plain_version(dev, n, batch):
    from beluga_tpu_torch.ops import cuda_reweight as b1

    args, _ = arena_inputs(n, dev, seed=1, batch=batch)
    v3 = b1.build_values3(args[0], args[1])
    before = b1.values3_launches, b1.launches

    def both(mask):
        kernel = b1.fused_reweight(*args[:7], mask, *args[8:], values3=v3)
        plain = b1.fused_reweight_values3_reference(v3, *args[2:7], mask, *args[8:])
        return kernel, plain

    got1, want1 = both(one_beam(args[7]))
    assert torch.equal(got1, want1)  # same cells, same bf16 entries
    got, want = both(args[7])
    torch.cuda.synchronize()
    assert (b1.values3_launches, b1.launches) == (before[0] + 2, before[1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    exact = b1.fused_reweight(*args)
    assert float(((got - exact).abs() / exact).max()) < 5e-3


@pytest.mark.parametrize("n,m,lead,d", [(2000, 2000, (), 4), (5000, 3001, (), 4),
                                        (262144, 262144, (), 4), (4096, 4096, (64,), 4),
                                        (300, 500, (2, 3), 3)])
def test_b2_kernel_matches_plain_version(dev, n, m, lead, d):
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops.resample import sorted_multinomial_positions, systematic_positions

    gen = torch.Generator(device=dev).manual_seed(n)
    w = torch.rand((*lead, n), generator=gen, device=dev)
    w[..., n // 4 : n // 3] = 0.0
    if lead:
        w[(0,) * len(lead)] *= 1e-6  # filters of very different total weight
    values = torch.randn((*lead, d, n), generator=gen, device=dev)
    cdf = b2.monotone_cdf(w)
    for pos in (sorted_multinomial_positions(gen, m, lead), systematic_positions(gen, m, lead)):
        pos[..., -7:] = 1.5
        got = b2.search_take(cdf, pos, values)
        want = b2.search_take_reference(cdf, pos, values)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not got[..., -7:, :].any()


CDF_ULP = 64 * 2.0**-24  # the CDF kernel's bound against a float64 prefix sum, N <= 2^21


def cdf_weights(dev, lead, n, seed):
    """Gamma weights with a block of zero-weight slots, scattered zeros, a
    dead first slot and, for fleets, an all-zero filter last."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand((*lead, n), generator=gen, device=dev) ** 4
    w[..., n // 5 : n // 5 + n // 7] = 0.0
    w[torch.rand(w.shape, generator=gen, device=dev) < 0.1] = 0.0
    w[..., 0] = 0.0
    if lead:
        w.view(-1, n)[-1] = 0.0
    return w


@pytest.mark.parametrize("lead,n", [((), 2000), ((64,), 4096), ((), 262144), ((), 2097152),
                                    ((3,), 4099), ((2,), 8193), ((), 1)])
def test_b2_cdf_kernel_monotone_exact_intervals_and_ulp_bound(dev, lead, n):
    """The CDF kernel: monotone, each zero-weight slot's entry equal to the
    one before it (0 before the first live slot; an all-zero filter all 0),
    the last live slot's entry exactly 1, and every entry within CDF_ULP of
    a float64 prefix sum divided by its total; one launch a call, two calls
    bit-equal."""
    from beluga_tpu_torch.ops import cuda_resample as b2

    w = cdf_weights(dev, lead, n, n)
    before = b2.cdf_launches
    cdf = b2.monotone_cdf(w)
    torch.cuda.synchronize()
    assert b2.cdf_launches == before + 1
    assert torch.equal(cdf, b2.monotone_cdf(w))  # one association, every call
    assert cdf.shape == w.shape and torch.isfinite(cdf).all()
    assert (cdf[..., 1:] >= cdf[..., :-1]).all()
    prev = torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1]], dim=-1)
    dead = w == 0
    assert torch.equal(cdf[dead], prev[dead])
    exact = torch.cumsum(w.double(), dim=-1)
    exact = exact / torch.clamp_min(exact[..., -1:], 1e-38)
    assert float((cdf.double() - exact).abs().max()) <= CDF_ULP
    flat_w, flat_c = w.reshape(-1, n), cdf.reshape(-1, n)
    for f in range(flat_w.shape[0]):
        live = torch.nonzero(flat_w[f] > 0).flatten()
        if live.numel():
            assert float(flat_c[f, live[-1]]) == 1.0
        else:
            assert not flat_c[f].any()


@pytest.mark.parametrize("lead,n,strategy", [((), 2000, "sorted"), ((64,), 4096, "sorted"),
                                             ((), 262144, "systematic"),
                                             ((), 2097152, "systematic"),
                                             ((), 262144, "uniform"), ((3,), 4099, "uniform")])
def test_b2_whole_function_is_cdf_kernel_then_search(dev, lead, n, strategy):
    """``resample_take`` from the weights on the card: one CDF build and one
    search (one launch of the one-tile entry up to a tile a filter), donors
    bit-equal to ``search_take`` on the kernel's own CDF and
    to its plain version there, no donor with zero weight, padding at 1.5
    and the all-zero filter zero rows, and rows apart from the plain whole
    function only where a position lies between the two CDFs' values of
    one entry.  Uniform positions take the kernel's global-memory search."""
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops.resample import (
        multinomial_positions,
        sorted_multinomial_positions,
        systematic_positions,
    )

    w = cdf_weights(dev, lead, n, n + 1)
    gen = torch.Generator(device=dev).manual_seed(n)
    draw = {"sorted": sorted_multinomial_positions, "systematic": systematic_positions,
            "uniform": multinomial_positions}[strategy]
    pos = draw(gen, n, lead).contiguous()
    pos[..., -5:] = 1.5
    values = torch.randn((*lead, 4, n), generator=gen, device=dev)
    counts = b2.cdf_launches, b2.launches, b2.tile_launches
    got = b2.resample_take(w, pos, values)
    torch.cuda.synchronize()
    # at one tile a filter the one-tile entry, else the CDF kernel and the search
    one = int(n <= b2.TILE)
    assert (b2.cdf_launches, b2.launches, b2.tile_launches) == (
        counts[0] + 1 - one, counts[1] + 1 - one, counts[2] + one)
    cdf = b2.monotone_cdf(w)
    assert torch.equal(got, b2.search_take(cdf, pos, values))
    assert torch.equal(got, b2.search_take_reference(cdf, pos, values))
    idx = torch.searchsorted(cdf, pos, right=True)
    found = idx < n
    chosen = torch.take_along_dim(w, torch.clamp_max(idx, n - 1), dim=-1)
    assert (chosen[found] > 0).all()
    assert not got[..., -5:, :].any()
    if lead:
        assert not got.reshape(-1, n, 4)[-1].any()
    # the plain CDF once: torch.cumsum's multi-block scan on the card need
    # not associate alike from one call to the next
    plain_cdf = b2.monotone_cdf_reference(w)
    moved = (torch.searchsorted(plain_cdf, pos, right=True) != idx)
    differs = (got != b2.search_take_reference(plain_cdf, pos, values)).any(-1)
    assert torch.equal(differs, moved)


def kernels_per_call(fn, calls=4):
    """Kernels on the card a call of ``fn`` runs, from ``torch.profiler``
    (memory copies and sets left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels) / calls


def assert_cdf_contract(w, cdf):
    """Monotone, each zero-weight slot's entry the one before it (0 before
    the first live slot), the last live slot's entry exactly 1, an
    all-zero filter all 0, every entry within CDF_ULP of float64."""
    n = w.shape[-1]
    assert cdf.shape == w.shape and torch.isfinite(cdf).all()
    assert (cdf[..., 1:] >= cdf[..., :-1]).all()
    prev = torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1]], dim=-1)
    dead = w == 0
    assert torch.equal(cdf[dead], prev[dead])
    exact = torch.cumsum(w.double(), dim=-1)
    exact = exact / torch.clamp_min(exact[..., -1:], 1e-38)
    assert float((cdf.double() - exact).abs().max()) <= CDF_ULP
    flat_w, flat_c = w.reshape(-1, n), cdf.reshape(-1, n)
    live_any = (flat_w > 0).any(-1)
    last = n - 1 - torch.argmax(torch.flip(flat_w > 0, [-1]).to(torch.int8), dim=-1)
    at_last = torch.take_along_dim(flat_c, last[:, None], dim=-1)[:, 0]
    assert bool((at_last[live_any] == 1.0).all())
    assert not flat_c[~live_any].any()


@pytest.mark.parametrize("lead,n", [((), 1), ((), 7), ((), 4095), ((), 4096), ((), 4097),
                                    ((), 8193), ((), 10001), ((), 262145), ((), 2097152),
                                    ((64,), 4097), ((300,), 8193)])
def test_b2_cdf_and_running_sum_are_one_launch_at_every_length(dev, lead, n):
    """The CDF kernel, normalized (``monotone_cdf``) and not
    (``running_sum``), is one kernel a call at every length: one tile, a
    few, the large and mega filters' 262145 and 2^21, the fleet's 64 x 4097
    and 300 filters x 3 tiles, past what the card holds at once (its blocks
    loop over tiles).  Two calls bit-equal; the CDF's contract
    (``assert_cdf_contract``, an all-zero filter all 0 where there are
    several); the running sum monotone, each zero weight's entry the one
    before, within CDF_ULP of its float64 total, and the CDF its own
    division by its last entry, bit for bit."""
    from beluga_tpu_torch.ops import cuda_resample as b2

    w = cdf_weights(dev, lead, n, n + 7)
    before = b2.cdf_launches, b2.sum_launches
    cdf, m = b2.monotone_cdf(w), b2.running_sum(w)
    torch.cuda.synchronize()
    assert (b2.cdf_launches, b2.sum_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(cdf, b2.monotone_cdf(w)) and torch.equal(m, b2.running_sum(w))
    assert_cdf_contract(w, cdf)
    prev = torch.cat([torch.zeros_like(m[..., :1]), m[..., :-1]], dim=-1)
    assert (m[..., 1:] >= m[..., :-1]).all() and torch.equal(m[w == 0], prev[w == 0])
    exact = torch.cumsum(w.double(), dim=-1)
    total = torch.clamp_min(exact[..., -1:], 1e-38)
    assert float(((m.double() - exact) / total).abs().max()) <= CDF_ULP
    assert torch.equal(cdf, m / torch.clamp_min(m[..., -1:], 1e-38))
    assert kernels_per_call(lambda: b2.monotone_cdf(w)) == 1.0
    assert kernels_per_call(lambda: b2.running_sum(w)) == 1.0
    plan = b2.cdf_plan(n, math.prod(lead), *b2._card(dev.index or 0))
    if (lead, n) == ((300,), 8193):
        assert plan.grid < plan.tiles * 300  # the blocks looped over tiles


@pytest.mark.parametrize("lead,n", [((), 2000), ((64,), 4096)])
@pytest.mark.parametrize("kind", ["sorted", "systematic", "padded"])
def test_b2_one_tile_entry_is_the_cdf_and_the_search_in_one_launch(dev, lead, n, kind):
    """Up to a tile a filter, ``resample_take`` is one launch of the
    one-tile entry, its donors bit-equal to ``search_take`` on
    ``monotone_cdf``'s CDF of the same weights: sorted multinomial and
    systematic positions with padding at 1.5, and padding alone (no
    donor); no CDF kernel and no search kernel run, an all-zero filter
    gives zero rows."""
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops.resample import sorted_multinomial_positions, systematic_positions

    w = cdf_weights(dev, lead, n, n + 3)
    gen = torch.Generator(device=dev).manual_seed(n + 3)
    values = torch.randn((*lead, 4, n), generator=gen, device=dev)
    if kind == "padded":
        pos = torch.full((*lead, n), 1.5, device=dev)
    else:
        draw = sorted_multinomial_positions if kind == "sorted" else systematic_positions
        pos = draw(gen, n, lead).contiguous()
        pos[..., -9:] = 1.5
    counts = b2.tile_launches, b2.launches, b2.cdf_launches
    got = b2.resample_take(w, pos, values)
    torch.cuda.synchronize()
    assert (b2.tile_launches, b2.launches, b2.cdf_launches) == (counts[0] + 1, *counts[1:])
    assert torch.equal(got, b2.search_take(b2.monotone_cdf(w), pos, values))
    assert not got[..., -9:, :].any()
    if lead:
        assert not got.reshape(-1, n, 4)[-1].any()
    assert kernels_per_call(lambda: b2.resample_take(w, pos, values)) == 1.0


def test_b2_cdf_kernel_refuses_a_grid_it_cannot_hold(dev):
    """A cooperative grid larger than the card holds at once, or than the
    filter's tiles, is refused by the C entry and raised by the wrapper's
    check; the plan's grid runs."""
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops._build import stream_ptr

    n = 2097152
    w = torch.rand(n, device=dev)
    out = torch.empty_like(w)
    sms, per_sm = b2._card(dev.index or 0)
    plan = b2.cdf_plan(n, 1, sms, per_sm)
    words = b2._scratch(dev, stream_ptr(dev), plan)
    with pytest.raises(RuntimeError, match="CDF kernel launch failed: cudaError"):
        b2._cdf(w.data_ptr(), n, 1, words.data_ptr(), 1, out.data_ptr(), plan.tiles + 1,
                stream_ptr(dev))
    b2._cdf(w.data_ptr(), n, 1, words.data_ptr(), 1, out.data_ptr(), plan.grid, stream_ptr(dev))
    torch.cuda.synchronize()
    assert torch.equal(out, b2.monotone_cdf(w))
    many = cdf_weights(dev, (300,), 8193, 5)  # 900 tiles, more than the card holds at once
    plan = b2.cdf_plan(8193, 300, sms, per_sm)
    assert plan.grid < plan.tiles * 300
    # every item a block of its own: refused, not run
    with pytest.raises(RuntimeError, match="cudaError"):
        b2._cdf(many.data_ptr(), 8193, 300, b2._scratch(dev, stream_ptr(dev), plan).data_ptr(), 1,
                torch.empty_like(many).data_ptr(), plan.tiles * 300, stream_ptr(dev))


@pytest.mark.parametrize("lead,p,c,n", [((64,), 512, 2, 4096), ((), 4096, 2, 262144),
                                        ((3,), 100, 3, 999), ((2,), 64, 8, 1000)])
def test_b3_kernel_matches_plain_version(dev, lead, p, c, n):
    from beluga_tpu_torch.ops import cuda_pool_take as b3

    gen = torch.Generator(device=dev).manual_seed(p)
    pool = torch.randn((*lead, p, c), generator=gen, device=dev)
    idx = torch.randint(-5, p + 5, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
    before = b3.launches
    got, want = b3.pool_take(pool, idx), b3.pool_take_reference(pool, idx)
    torch.cuda.synchronize()
    assert b3.launches == before + 1
    assert torch.equal(got, want)
    assert not got[(idx < 0) | (idx >= p)].any()


@pytest.mark.parametrize("lead,p,n", [((64,), 512, 4096), ((), 4096, 262144), ((), 512, 4096),
                                      ((3,), 100, 999), ((2,), 7, 1001)])
def test_b3_draw_matches_plain_version(dev, lead, p, n):
    """B3's draw entry against its plain version (``free_xy[cand]``, the row
    take, ``SO2.exp``): translations bit-equal, zero rows where ``idx`` is
    out of range, and cos and sin bit-equal (``sincosf`` against
    ``torch.cos`` and ``torch.sin``, which are ``cosf`` and ``sinf``); at
    the fleet's, the large filter's and the mega filter's shapes and at
    ragged sizes (a partial block, a pool of 7)."""
    from beluga_tpu_torch.ops import cuda_pool_take as b3

    gen = torch.Generator(device=dev).manual_seed(p + n)
    rows = 5000
    free = torch.randn((rows, 2), generator=gen, device=dev) * 10
    cand = torch.randint(0, rows, (*lead, p), generator=gen, device=dev)
    idx = torch.randint(-5, p + 5, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
    theta = (torch.rand((*lead, n), generator=gen, device=dev) * 2 - 1) * math.pi
    before = (b3.launches, b3.draw_launches)
    got = b3.pooled_free_cells(free, cand, idx, theta)
    want = b3.pooled_free_cells_reference(free, cand, idx, theta)
    torch.cuda.synchronize()
    assert (b3.launches, b3.draw_launches) == (before[0], before[1] + 1)
    assert got.xy.shape == got.rot.z.shape == (*lead, n, 2)
    assert torch.equal(got.xy, want.xy)
    assert not got.xy[(idx < 0) | (idx >= p)].any()
    assert torch.equal(got.rot.z, want.rot.z)


def test_b3_draw_reads_no_cand_outside_free_xy(dev):
    """A ``cand`` outside the rows of ``free_xy`` is never read: the slots
    that take such a pool entry get a zero translation (the others their
    row), the launch faults nowhere."""
    from beluga_tpu_torch.ops import cuda_pool_take as b3

    gen = torch.Generator(device=dev).manual_seed(5)
    rows, p, n = 100, 64, 4096
    free = torch.randn((rows, 2), generator=gen, device=dev) + 3.0  # no zero row
    cand = torch.randint(0, rows, (p,), generator=gen, device=dev)
    cand[:4] = torch.tensor([-1, rows, 10**12, -(10**12)], device=dev)
    idx = torch.randint(0, p, (n,), generator=gen, device=dev, dtype=torch.int32)
    idx[:8] = torch.tensor([0, 1, 2, 3, 4, 5, -1, p], device=dev, dtype=torch.int32)
    theta = torch.rand(n, generator=gen, device=dev)
    got = b3.pooled_free_cells(free, cand, idx, theta)
    torch.cuda.synchronize()
    inside = (cand >= 0) & (cand < rows)
    taken = (idx >= 0) & (idx < p)
    rows_of = free[torch.where(inside, cand, 0)][torch.where(taken, idx, 0).long()]
    want = torch.where((taken & inside[torch.where(taken, idx, 0).long()])[:, None], rows_of, 0.0)
    assert torch.equal(got.xy, want)
    assert not got.xy[:4].any() and got.xy[4:6].all() and not got.xy[6:8].any()


@pytest.mark.parametrize("entry", ["rows", "draw"])
def test_b3_unaligned_rows_take_the_scalar_path(dev, entry):
    """B3's one kernel takes its vector loads only where both base pointers
    are 16-byte aligned: a pool (or ``free_xy``) that starts 8 bytes into
    its storage goes through the scalar path, with the same result."""
    from beluga_tpu_torch.ops import cuda_pool_take as b3

    gen = torch.Generator(device=dev).manual_seed(11)
    p, n = 300, 5000
    idx = torch.randint(-5, p + 5, (n,), generator=gen, device=dev, dtype=torch.int32)
    if entry == "rows":
        pool = torch.randn((p + 1, 2), generator=gen, device=dev)[1:]
        assert pool.is_contiguous() and pool.data_ptr() % 16 == 8
        assert torch.equal(b3.pool_take(pool, idx), b3.pool_take_reference(pool, idx))
        return
    free = torch.randn((1001, 2), generator=gen, device=dev)[1:]
    assert free.is_contiguous() and free.data_ptr() % 16 == 8
    cand = torch.randint(0, 1000, (p,), generator=gen, device=dev)
    theta = torch.rand(n, generator=gen, device=dev)
    got = b3.pooled_free_cells(free, cand, idx, theta)
    want = b3.pooled_free_cells_reference(free, cand, idx, theta)
    assert torch.equal(got.xy, want.xy) and torch.equal(got.rot.z, want.rot.z)


def aten_ops(fn) -> set:
    """The names of the ``aten::`` operators that ``fn()`` runs (CPU-side
    profiler events, which do not depend on the card's tracing)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.name.startswith("aten::")}


ALLOCATIONS = {"aten::empty", "aten::empty_like", "aten::empty_strided"}


def test_pooled_draw_and_windowed_gate_one_launch_each(dev):
    """One pooled draw (``core/random.py``) is one launch of B3's draw entry
    and no other operator: no index, cos, sin or stack, and the row entry
    never; the windowed filter's gate (``windowed_coverage_tiled_from_center``)
    is one launch of B6's coverage entry and no other operator (no
    coordinates, no host-to-device copy); the states lookup one launch."""
    from beluga_tpu_torch.core.random import uniform_free_cells_pooled_from_draws
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import (
        windowed_coverage_tiled_from_center,
        windowed_scan_lut_weights,
    )
    from beluga_tpu_torch.ops import cuda_pool_take as b3
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    gen = torch.Generator(device=dev).manual_seed(0)
    free = torch.randn((3000, 2), generator=gen, device=dev)
    cand = torch.randint(0, 3000, (64, 512), generator=gen, device=dev)
    idx = torch.randint(0, 512, (64, 4096), generator=gen, device=dev, dtype=torch.int32)
    theta = torch.rand((64, 4096), generator=gen, device=dev)
    before = (b3.launches, b3.draw_launches)
    ops = aten_ops(lambda: uniform_free_cells_pooled_from_draws(cand, idx, theta, free))
    assert ops <= ALLOCATIONS, ops
    assert (b3.launches, b3.draw_launches) == (before[0], before[1] + 2)

    cfg = workloads.WINDOWED_FILTER
    w, states, lut = window_case(dev, 65536, cfg, workloads.windowed)
    st = w.state.particles.state
    centre = (torch.mean(st.x), torch.mean(st.y),
              torch.atan2(torch.mean(st.rot.sin), torch.mean(st.rot.cos)))
    geo = {k: cfg[k] for k in ("k_bins", "win", "dth", "max_point_radius")}
    before = (b6.launches, b6.states_launches, b6.coverage_launches)
    ops = aten_ops(lambda: windowed_coverage_tiled_from_center(
        w.ctx["field"], states, *centre, tile=cfg["tile"], tblk=cfg["tblk"], **geo))
    assert ops <= ALLOCATIONS, ops
    ops = aten_ops(lambda: windowed_scan_lut_weights(lut, states, cfg["tile"], cfg["tblk"]))
    assert ops <= ALLOCATIONS, ops
    assert (b6.launches, b6.states_launches, b6.coverage_launches) == (
        before[0], before[1] + 2, before[2] + 2)


def test_fleet_on_card(dev):
    """The fleet entry points with their default device: four filters in
    codebook16 mode with theta-sorted slots and pooled recovery, one
    update, launching B4, B2 and B3's draw entry once each, B1 and B3's row
    entry never."""
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_fleet_state
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.ops import cuda_pool_take, cuda_resample, cuda_reweight
    from beluga_tpu_torch.parallel.fleet import make_fleet_update

    data = synthetic.tracking_arena(384, 0.05)
    xs, ys, yaws = synthetic.circle_trajectory(1)
    pts, mask = synthetic.simulate_scans(data, 0.05, xs, ys, yaws, BEAMS)
    models, ctx = make_likelihood_field_filter(make_grid(data, 0.05), lookup_mode="codebook16",
                                               recovery_candidates=256)
    params = AmclParams(max_particles=4096, min_particles=4096, sorted_slots=True)
    state = init_fleet_state(0, 4, host_pose(xs[0], ys[0], yaws[0]),
                             np.diag([0.25, 0.25, 0.068]), params)
    assert state.particles.log_weight.is_cuda and state.particles.log_weight.shape == (4, 4096)
    counts = (cuda_reweight.launches, cuda_reweight.values3_launches, cuda_resample.tile_launches,
              cuda_pool_take.draw_launches, cuda_pool_take.launches)
    states_launches = cuda_reweight.states_launches
    state, est = make_fleet_update(params, models)(
        ctx, state, SE2.from_xytheta(np.full(4, xs[0]), np.full(4, ys[0]), np.full(4, yaws[0]),
                                     device="cpu"),
        torch.as_tensor(pts[0]).to(dev).expand(4, BEAMS, 2).contiguous(),
        torch.as_tensor(mask[0]).to(dev).expand(4, BEAMS).contiguous())
    assert est.valid.all() and torch.isfinite(est.pose.xy).all()
    assert (cuda_reweight.launches, cuda_reweight.values3_launches, cuda_resample.tile_launches,
            cuda_pool_take.draw_launches, cuda_pool_take.launches) == (
        counts[0], counts[1] + 1, counts[2] + 1, counts[3] + 1, counts[4])
    assert cuda_reweight.states_launches == states_launches + 1


def test_node_on_card(dev):
    """The node's entry points with their default device: a scan, the
    motion gate, global localization, the particle cloud and a map swap."""
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.ops import cuda_resample, cuda_reweight

    data = np.zeros((80, 80), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 100
    data[30:40, 30:40] = 100
    node = AmclNode(AmclNodeConfig(max_particles=300, min_particles=50, set_initial_pose=True,
                                   initial_pose_x=2.0, initial_pose_y=2.0))
    node.set_map(make_grid(data, 0.1))
    assert node._state.particles.log_weight.is_cuda
    b1, b2 = cuda_reweight.launches, cuda_resample.tile_launches
    b1_states = cuda_reweight.states_launches
    pts = np.random.default_rng(0).uniform(0.5, 2.0, (30, 2)).astype(np.float32)
    res = node.handle_scan((0.0, 0.0, 0.0), pts)
    assert res.valid and np.isfinite(res.pose).all()
    assert (cuda_reweight.launches, cuda_resample.tile_launches) == (b1 + 1, b2 + 1)
    assert cuda_reweight.states_launches == b1_states + 1
    assert not node.handle_scan((0.01, 0.0, 0.0), pts).valid
    node.global_localization()
    xyt, w = node.particle_cloud()
    assert len(xyt) == 300 and xyt[:, 0].std() > 1.0 and np.isfinite(w).all()
    node.request_nomotion_update()
    assert node.handle_scan((0.01, 0.0, 0.0), pts).valid
    node.set_map(make_grid(data, 0.1))
    xyt, _ = node.particle_cloud()
    assert abs(np.mean(xyt[:, 0]) - node.last_known_estimate[0][0]) < 0.5


def window_case(dev, n, cfg, workload, stray_every=20):
    """A workload's θ-sorted cloud with strays and its window LUT, built
    on the card."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import build_windowed_scan_lut

    w = workload(1, dev, n)
    st = w.state.particles.state
    xy = st.xy.clone()
    xy[::stray_every] += 5.0
    ct = torch.atan2(torch.mean(st.rot.sin), torch.mean(st.rot.cos))
    geo = {k: cfg[k] for k in ("k_bins", "win", "dth", "max_point_radius")}
    lut = build_windowed_scan_lut(w.ctx["field"], w.points[0], w.mask[0], torch.mean(st.x),
                                  torch.mean(st.y), ct, padded_cubed=w.ctx["field_pad3"],
                                  dft=w.ctx["winlut_dft"], **geo)
    return w, SE2(xy, st.rot), lut


@pytest.mark.parametrize("n,tile,tblk", [(262144, 512, 16), (5000, 128, 8), (3000, 2048, 16)])
def test_b6_kernel_matches_plain_version(dev, n, tile, tblk):
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import windowed_coords
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    _, states, lut = window_case(dev, n, workloads.WINDOWED_FILTER, workloads.windowed)
    xi, yi, t = (v.contiguous() for v in windowed_coords(lut, states))
    before = b6.launches
    got = b6.winlut_lookup(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk)
    want = b6.winlut_lookup_reference(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk)
    torch.cuda.synchronize()
    assert b6.launches == before + 1
    assert torch.equal(got == lut.miss, want == lut.miss)
    assert 0 < int((got == lut.miss).sum()) < n
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,tile,tblk,table", [
    (2097152, 4096, 20, "mega"), (2097152 - 1000, 4096, 20, "mega"), (777, 128, 20, "mega"),
    (2097152, 4096, 8, "mega"), (100000, 3000, 20, "mega"), (50000, 8192, 12, "mega"),
    (262144 + 300, 4096, 16, "windowed"), (5000, 512, 16, "windowed")])
def test_b5_kernel_matches_plain_version(dev, n, tile, tblk, table):
    """B5 against its plain version: the mega's 160 KB table in shared
    memory, the windowed filter's 2 MB table through L2, a slab shallower
    than K, N not a multiple of the tile, tiles that are not a multiple of
    the block (3000) and eight slots a thread (8192)."""
    from beluga_tpu_torch.filters.amcl import host_pose
    from beluga_tpu_torch.filters.builders import fused_step_scalars
    from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams
    from beluga_tpu_torch.ops import cuda_fused_step as b5
    from beluga_tpu_torch.tools import workloads

    cfg, make = {"mega": (workloads.MEGA_FILTER, workloads.mega),
                 "windowed": (workloads.WINDOWED_FILTER, workloads.windowed)}[table]
    w, states, lut = window_case(dev, max(n, 4096), cfg, make)
    assert (lut.values_t.numel() * 2 <= 225 * 1024) == (table == "mega")
    s = w.scans
    scalars = fused_step_scalars(lut, DifferentialDriveParams(), host_pose(0.3, 0.1, 0.2),
                                 host_pose(s.xs[0], s.ys[0], s.yaws[0]), dev)
    z = torch.randn((3, n), generator=torch.Generator(device=dev).manual_seed(n), device=dev)
    args = (*(v[:n].contiguous() for v in (states.x, states.y, states.theta)), z,
            lut.values_t, scalars)
    before = b5.launches
    got = b5.fused_propagate_winlut(*args, tile=tile, tblk=tblk)
    want = b5.fused_propagate_winlut_reference(*args, tile=tile, tblk=tblk)
    torch.cuda.synchronize()
    assert b5.launches == before + 1
    for g, x in zip(got[:4], want[:4]):
        torch.testing.assert_close(g, x, rtol=0, atol=1e-5)
    miss = torch.log(lut.miss)
    both = (got[4] != miss) & (want[4] != miss)
    assert 0 < int(both.sum()) < n
    assert int(((got[4] == miss) != (want[4] == miss)).sum()) <= n // 10000
    torch.testing.assert_close(got[4][both], want[4][both], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="tile"):
        b5.fused_propagate_winlut(*args, tile=b5.MAX_TILE + 1, tblk=tblk)


def test_mega_update_on_card(dev):
    """The fused mega filter on the card: one forced update of 65536
    particles launches B5 once and B6 never."""
    from beluga_tpu_torch.filters.amcl import host_pose, update
    from beluga_tpu_torch.ops import cuda_fused_step, cuda_winlut
    from beluga_tpu_torch.tools import workloads

    w = workloads.mega(2, dev, 65536)
    assert w.state.particles.log_weight.is_cuda
    counts = (cuda_fused_step.launches, cuda_winlut.launches)
    state, est = update(w.params, w.models, w.ctx, w.state, host_pose(w.scans.xs[0],
                        w.scans.ys[0], w.scans.yaws[0]), w.points[0], w.mask[0], sort_now=True)
    assert est.valid and torch.isfinite(est.pose.xy).all()
    assert (cuda_fused_step.launches, cuda_winlut.launches) == (counts[0] + 1, counts[1])


# -- slice 4: the beam model (R1, B8, B7) ------------------------------------------


def beam_arena(dev, n, seed, batch=None, beams=BEAMS):
    """The arena's grid and first scan of ``beams`` beams, and ``n``
    particles about its first pose (``[batch, n]`` for a fleet)."""
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid

    data = synthetic.tracking_arena(384, 0.05)
    xs, ys, yaws = synthetic.circle_trajectory(1)
    pts, mask = synthetic.simulate_scans(data, 0.05, xs, ys, yaws, beams)
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    xyt = rng.normal([xs[0], ys[0], yaws[0]], [0.5, 0.5, 0.3], (*lead, n, 3)).astype(np.float32)
    xyt[..., ::25, :2] += 4.0  # some far off
    states = SE2.from_xytheta(xyt[..., 0], xyt[..., 1], xyt[..., 2], device=dev)
    points = torch.as_tensor(pts[0]).to(dev)
    px, py = points[:, 0], points[:, 1]
    z = torch.sqrt(px * px + py * py)
    return (make_grid(data, 0.05, device=dev), states, points, z,
            torch.as_tensor(mask[0]).to(dev))


@pytest.mark.parametrize("variant", ["standard", "supercover"])
@pytest.mark.parametrize("max_range", [100.0, 4.0])
def test_r1_kernel_matches_plain_version(dev, variant, max_range):
    from beluga_tpu_torch.ops import raycast as r1

    grid, states, points, z, _ = beam_arena(dev, 3000, 0)
    bearing = points / torch.clamp_min(z, 1e-12)[:, None]
    c, s = states.rot.cos[:, None], states.rot.sin[:, None]
    dirs = torch.stack([c * bearing[None, :, 0] - s * bearing[None, :, 1],
                        s * bearing[None, :, 0] + c * bearing[None, :, 1]], -1)
    src = states.xy[:, None, :].expand(dirs.shape).contiguous()
    src[:7] = -1.0  # sources off the grid
    before = r1.launches
    got = r1.cast_rays(grid, src, dirs, max_range, variant=variant)
    want = r1.cast_rays_reference(grid.free_mask, src, dirs, max_range, grid.resolution,
                                  r1.num_steps(max_range, grid.resolution), variant)
    torch.cuda.synchronize()
    assert r1.launches == before + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert 0 < int(got[1].sum()) < got[1].numel()


def test_r1_range_lut_build_matches_plain_version(dev):
    from beluga_tpu_torch.models.sensor.beam_lut import build_range_lut
    from beluga_tpu_torch.ops import raycast as r1

    grid, *_ = beam_arena(dev, 1, 0)
    before = r1.launches
    lut = build_range_lut(grid, 4.0, 32)
    torch.cuda.synchronize()
    assert r1.launches == before + 1
    cpu = build_range_lut(grid.to("cpu"), 4.0, 32)
    assert torch.equal(lut.ranges.cpu(), cpu.ranges)


def r1_map(dev, which):
    """A grid for R1's two branches: the arena (an 18 KB bit plane, staged
    in shared memory), the long-range 1024² map at 0.1 m (128 KB, staged)
    or a 2048² map of the same kind (512 KB, read through L2); and poses
    about a point of it."""
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.maps.occupancy import make_grid

    if which == "arena":
        xs, ys, yaws = synthetic.circle_trajectory(1)
        return make_grid(synthetic.tracking_arena(384, 0.05), 0.05, device=dev), (xs[0], ys[0])
    cells = 1024 if which == "long_range" else 2048
    xs, ys, _ = synthetic.arc_trajectory(1, cells, 0.1)
    return make_grid(synthetic.long_range_world(cells), 0.1, device=dev), (xs[0], ys[0])


def r1_states(dev, center, n, seed, batch=None):
    from beluga_tpu_torch.lie import SE2

    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    xyt = rng.normal([*center, 0.0], [0.5, 0.5, 3.0], (*lead, n, 3)).astype(np.float32)
    xyt[..., ::25, :2] += 8.0  # some far off, some off the map
    xyt[..., 1::50, :2] = -1.0
    return SE2.from_xytheta(xyt[..., 0], xyt[..., 1], xyt[..., 2], device=dev)


def r1_scan(dev, nb, seed, masked=(3,)):
    rng = np.random.default_rng(seed)
    ang = np.linspace(-np.pi, np.pi, nb, endpoint=False)
    r = rng.uniform(0.3, 12.0, nb)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    mask = np.ones(nb, bool)
    mask[[m for m in masked if m < nb]] = False
    return torch.as_tensor(pts).to(dev), torch.as_tensor(mask).to(dev)


@pytest.mark.parametrize("variant", ["standard", "supercover"])
@pytest.mark.parametrize("which,max_range", [("arena", 100.0), ("long_range", 60.0),
                                             ("l2", 60.0)])
def test_r1_ray_entry_bit_equal_in_shared_memory_and_through_l2(dev, variant, which,
                                                                  max_range):
    """The ray entry with its plane staged in shared memory (the arena,
    the 1024² map) and read through L2 (the 2048² map): bit-equal."""
    from beluga_tpu_torch.ops import raycast as r1

    grid, center = r1_map(dev, which)
    states = r1_states(dev, center, 1500, 1)
    points, _ = r1_scan(dev, BEAMS, 2)
    bearing = points / torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    c, s = states.rot.cos[:, None], states.rot.sin[:, None]
    dirs = torch.stack([c * bearing[None, :, 0] - s * bearing[None, :, 1],
                        s * bearing[None, :, 0] + c * bearing[None, :, 1]], -1)
    src = states.xy[:, None, :]
    got = r1.cast_rays(grid, src, dirs, max_range, variant=variant)
    want = r1.cast_rays_reference(grid.free_mask, *torch.broadcast_tensors(src, dirs), max_range,
                                  grid.resolution, r1.num_steps(max_range, grid.resolution),
                                  variant)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert 0 < int(got[1].sum()) < got[1].numel()


def test_r1_ray_entry_reads_broadcast_inputs_through_strides(dev):
    """Sources ``[1, H, W, 2]`` against directions ``[K, 1, 1, 2]`` (the
    range-LUT build), a transposed view, and six broadcast axes (more than
    the kernel's four: copied first): each equal to the same rays made
    contiguous."""
    from beluga_tpu_torch.ops import raycast as r1

    grid, _ = r1_map(dev, "arena")
    res = grid.resolution
    xs = (torch.arange(96, dtype=torch.float32, device=dev) + 0.5) * res * 4
    src = torch.stack([xs[None, :].expand(80, 96), xs[:80, None].expand(80, 96)], -1)[None]
    th = torch.arange(16, dtype=torch.float32, device=dev) * (2.0 * math.pi / 16)
    dirs = torch.stack([torch.cos(th), torch.sin(th)], -1)[:, None, None, :]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    six = (torch.rand(2, 3, 2, 3, 2, 3, 2, generator=gen, device=dev) * 15.0).permute(
        1, 0, 3, 2, 5, 4, 6)  # six axes whose strides do not merge
    cases = [(src, dirs), (src.transpose(1, 2), dirs), (six, dirs[:2, 0, 0])]
    for s_in, d_in in cases:
        got = r1.cast_rays(grid, s_in, d_in, 4.0)
        flat = [t.contiguous() for t in torch.broadcast_tensors(s_in, d_in)]
        want = r1.cast_rays(grid, *flat, 4.0)
        torch.cuda.synchronize()
        assert got[0].shape == flat[0].shape[:-1]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("variant", ["standard", "supercover"])
@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("which", ["arena", "l2"])
def test_r1_exact_entry_matches_plain_version(dev, variant, log_space, which):
    """The exact beam-weights entry against its plain version: every
    weight within rtol 1e-5 (log: abs 1e-5), two launches bit-equal, with
    a masked beam and a masked NaN beam; plane in shared memory (the
    arena) and through L2 (the 2048² map)."""
    from beluga_tpu_torch.models.sensor.beam import BeamModelParams, exact_mixture
    from beluga_tpu_torch.ops import raycast as r1

    grid, center = r1_map(dev, which)
    states = r1_states(dev, center, 2000, 3)
    points, mask = r1_scan(dev, BEAMS, 4, masked=(3, 7))
    points[7] = float("nan")
    bmr = 100.0 if which == "arena" else 60.0
    args = (grid, states, points, mask, exact_mixture(BeamModelParams(beam_max_range=bmr)),
            bmr, variant, log_space)
    before = r1.exact_launches
    got, again = r1.exact_beam_weights(*args), r1.exact_beam_weights(*args)
    want = r1.exact_beam_weights_reference(*args)
    torch.cuda.synchronize()
    assert r1.exact_launches == before + 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
    if log_space:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    assert float(want.std()) > 0


@pytest.mark.parametrize("batch,n,nb", [(3, 777, BEAMS), (None, 300, 1000), (None, 5, 1),
                                        (2, 100, 33)])
def test_r1_exact_entry_fleets_wide_scans_and_masks(dev, batch, n, nb):
    """Fleets (a scan for each filter), a scan of 1000 beams (one
    particle a block, beams in several rounds), one beam, and a filter
    whose beams are all masked (weight 0, log 1e-30's), against the plain
    version."""
    from beluga_tpu_torch.models.sensor.beam import BeamModelParams, exact_mixture
    from beluga_tpu_torch.ops import raycast as r1

    grid, center = r1_map(dev, "arena")
    states = r1_states(dev, center, n, 5, batch)
    lead = () if batch is None else (batch,)
    scans = [r1_scan(dev, nb, 6 + f) for f in range(batch or 1)]
    points = torch.stack([p for p, _ in scans]).reshape(*lead, nb, 2)
    mask = torch.stack([m for _, m in scans]).reshape(*lead, nb)
    if batch:
        mask[-1] = False
    mix = exact_mixture(BeamModelParams(beam_max_range=100.0))
    for log_space in (False, True):
        args = (grid, states, points, mask, mix, 100.0, "standard", log_space)
        got = r1.exact_beam_weights(*args)
        want = r1.exact_beam_weights_reference(*args)
        torch.cuda.synchronize()
        assert got.shape == (*lead, n)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 if log_space else 0)
    if batch:
        assert torch.equal(got[-1], torch.full_like(got[-1], math.log(1e-30)))


def test_r1_exact_grid_plane_follows_a_map_swap(dev):
    """``update_map_ctx`` gives the ctx a new grid, and the exact filter's
    weights follow it: the new grid packs its own plane."""
    from beluga_tpu_torch.filters.builders import make_beam_filter, update_map_ctx
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.ops import raycast as r1

    grid, center = r1_map(dev, "arena")
    models, ctx = make_beam_filter(grid, device=dev)
    states = r1_states(dev, center, 500, 7)
    points, mask = r1_scan(dev, BEAMS, 8)
    before = models.log_weight(ctx, states, points, mask)
    data = grid.data.cpu().numpy().copy()
    data[100:300, 100:300] = 100
    other = make_grid(data, grid.resolution, device=dev)
    swapped = update_map_ctx(ctx, other, AmclNodeConfig().likelihood_field_params())
    after = models.log_weight(swapped, states, points, mask)
    fresh = models.log_weight(make_beam_filter(other, device=dev)[1], states, points, mask)
    torch.cuda.synchronize()
    assert r1.free_plane(swapped["grid"]) is not r1.free_plane(ctx["grid"])
    assert torch.equal(after, fresh) and not torch.equal(after, before)


def test_beam_node_exact_weights_one_launch_per_update(dev):
    """The beam node on its default path: each update's weights are one
    launch of R1's exact entry, and the ray entry is never launched."""
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.ops import raycast
    from beluga_tpu_torch.tools import workloads

    s = workloads.arena_scans(6)
    node = AmclNode(workloads.node_config(s, laser_model_type="beam", beam_fast_path="exact"),
                    seed=0, device=dev)
    node.set_map(make_grid(s.data, workloads.RES, device=dev))
    before = (raycast.launches, raycast.exact_launches)
    valid = sum(node.handle_scan((s.xs[t], s.ys[t], s.yaws[t]), s.points[t],
                                 s.mask[t]).valid for t in range(6))
    torch.cuda.synchronize()
    assert valid >= 5
    assert (raycast.launches - before[0], raycast.exact_launches - before[1]) == (0, valid)


@pytest.mark.parametrize("n,batch,max_range,nb", [
    (2000, None, 100.0, BEAMS), (2048, None, 60.0, BEAMS), (777, 3, 8.0, BEAMS),
    (500, 2, 100.0, 361), (300, None, 8.0, 1000)])
def test_b8_kernel_matches_plain_version(dev, n, batch, max_range, nb):
    """B8 bit-equal to its plain version, at scans of 60 beams, of 361 (no
    multiple of 32) and of 1000 (more than a block's tile of 256)."""
    from beluga_tpu_torch.filters.builders import sphere_trace_steps
    from beluga_tpu_torch.ops import cuda_beam as b8

    grid, states, points, z, mask = beam_arena(dev, n, 1, batch, beams=nb)
    lead = states.x.shape[:-1]
    bearing = (points / torch.clamp_min(z, 1e-12)[:, None]).expand(*lead, nb, 2).contiguous()
    ranges = z.expand(*lead, nb).contiguous()
    beams = mask.expand(*lead, nb).contiguous()
    pv = (max_range, 0.5, 0.05, 0.05, 0.5, 0.2, 0.1)
    args = (b8.make_distance_cells(grid.free_mask),
            *(v.contiguous() for v in (states.x, states.y, states.rot.cos, states.rot.sin)),
            bearing, ranges, beams, grid.resolution, pv)
    steps = sphere_trace_steps(max_range, grid.resolution)
    before = b8.launches
    got = b8.sphere_trace_beam_weights(*args, march_steps=steps)
    want = b8.sphere_trace_reference(*args, march_steps=steps)
    torch.cuda.synchronize()
    assert b8.launches == before + 1
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_b8_masked_nan_beam_on_card(dev):
    from beluga_tpu_torch.ops import cuda_beam as b8

    grid, states, points, z, mask = beam_arena(dev, 500, 2)
    bearing = (points / torch.clamp_min(z, 1e-12)[:, None]).contiguous()
    first = int(torch.nonzero(mask)[0])
    mask, bearing, z = mask.clone(), bearing.clone(), z.clone()
    mask[first] = False
    poses = [v.contiguous() for v in (states.x, states.y, states.rot.cos, states.rot.sin)]
    dist = b8.make_distance_cells(grid.free_mask)
    pv = (100.0, 0.5, 0.05, 0.05, 0.5, 0.2, 0.1)
    clean = b8.sphere_trace_beam_weights(dist, *poses, bearing, z, mask, 0.05, pv, 89)
    bearing[first], z[first] = float("nan"), float("nan")
    got = b8.sphere_trace_beam_weights(dist, *poses, bearing, z, mask, 0.05, pv, 89)
    assert torch.isfinite(got).all() and torch.equal(got, clean)


def beam_lut_case(dev, batch, n, k, seed=3, beams=BEAMS):
    """B7's arguments at the arena: ``batch`` filters of ``n`` particles,
    the 256 slots of the first tile's second block moved 4 m off the
    cloud (a block of nothing but the cloud's strays).  A scan of more
    than BEAMS beams has every beam but each seventh unmasked, the misses
    at range 0 included, so that the kernel stages many chunks of them.
    Every third heading is shifted by 2 pi and every third by -5 pi, so
    that theta + beta takes each branch of the kernel's mod 2 pi."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.models.sensor.beam_lut import build_range_lut, lut_cells
    from beluga_tpu_torch.ops import cuda_beam_lut as b7

    grid, states, points, z, mask = beam_arena(dev, n, seed, batch, beams=beams)
    if beams > BEAMS:
        mask = torch.ones_like(mask)
        mask[::7] = False
    if n > 3840:
        xy = states.xy.clone()
        xy[..., 3840:4096, :] += 4.0
        states = SE2(xy, states.rot)
    lut = build_range_lut(grid, 4.0, k)
    table = b7.build_lut_bf16(lut.ranges)
    local, xi, yi = lut_cells(lut, states)
    # headings that wrap once or twice: theta + beta beyond 2 pi and 4 pi
    theta = local.theta.clone()
    theta[..., 1::3] += 2.0 * math.pi
    theta[..., 2::3] -= 5.0 * math.pi
    beta = torch.atan2(points[:, 1], points[:, 0])
    lead = (batch, beams)
    mix = (0.5, 0.05, 0.05, 0.05, 0.2, 0.1, 4.0)
    return (table, theta.contiguous(), xi, yi, z.expand(lead).contiguous(),
            beta.expand(lead).contiguous(), mask.expand(lead).contiguous(), lut.max_range, mix)


@pytest.mark.parametrize("batch,n,k,beams", [(64, 4096, 128, BEAMS), (3, 5000, 32, BEAMS),
                                             (1, 777, 16, BEAMS), (1, 2000, 128, BEAMS),
                                             (2, 3000, 32, 361), (1, 2000, 128, 1000)])
def test_b7_kernel_matches_plain_version(dev, batch, n, k, beams):
    """B7 bit-equal to its plain version at the fleet's 64 x 4096, a ragged
    last tile (5000: its second block empty), one short tile and the beam
    node's 2000 particles, and at scans of 361 and 1000 beams, most of
    them unmasked (several chunks of staged beams, each particle's sum
    carried across them); two launches bit-equal; one call is two
    launches, the origins and the weights."""
    from beluga_tpu_torch.ops import cuda_beam_lut as b7

    args = beam_lut_case(dev, batch, n, k, beams=beams)
    before = b7.launches, b7.origins_launches
    got, want = b7.beam_lut_windowed(*args), b7.beam_lut_windowed_reference(*args)
    again = b7.beam_lut_windowed(*args)
    torch.cuda.synchronize()
    assert (b7.launches, b7.origins_launches) == (before[0] + 2, before[1] + 2)
    assert torch.isfinite(got).all() and torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.parametrize("batch,n", [(64, 4096), (3, 5000), (1, 777), (1, 2000), (2, 3840),
                                     (2, 8192 + 3841)])
def test_b7_origins_kernel_matches_window_origins(dev, batch, n):
    """The origins kernel equals window_origins exactly: a block of strays
    (slots 3840-4095 4 m off), ragged last tiles (an empty second block at
    5000 and 3840, one slot of it at 12033), cells clipped at the map's
    edge."""
    from beluga_tpu_torch.ops import cuda_beam_lut as b7

    table, _, xi, yi, *_ = beam_lut_case(dev, batch, n, 16, seed=4)
    hq, wq, _ = table.shape
    before = b7.origins_launches
    got = b7.device_window_origins(xi, yi, hq, wq)
    want = b7.window_origins(xi, yi, hq, wq)
    torch.cuda.synchronize()
    assert b7.origins_launches == before + 1
    assert got.shape == want.shape and torch.equal(got, want)
    if n > 3840:
        assert not torch.equal(got[:, 0, 0], got[:, 0, 1])  # the strays' block moved


def test_b7_masked_nan_beam_on_card(dev):
    """A masked beam whose range and bearing are NaN leaves every weight
    finite and equal to the weights without it."""
    from beluga_tpu_torch.ops import cuda_beam_lut as b7

    args = list(beam_lut_case(dev, 2, 3000, 32))
    z, beta, mask = (args[i].clone() for i in (4, 5, 6))
    first = int(torch.nonzero(mask[0])[0])
    mask[:, first] = False
    clean = b7.beam_lut_windowed(*args[:4], z, beta, mask, *args[7:])
    z[:, first], beta[:, first] = float("nan"), float("nan")
    got = b7.beam_lut_windowed(*args[:4], z, beta, mask, *args[7:])
    want = b7.beam_lut_windowed_reference(*args[:4], z, beta, mask, *args[7:])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, clean) and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["exact", "lut", "sphere_trace", "windowed"])
def test_beam_node_on_card(dev, mode):
    """The beam node with its default device in each beam_fast_path: a scan
    runs each mode's kernel."""
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.ops import cuda_beam, cuda_beam_lut, raycast

    data = np.zeros((80, 80), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 100
    data[30:40, 30:40] = 100
    node = AmclNode(AmclNodeConfig(max_particles=300, min_particles=50, set_initial_pose=True,
                                   initial_pose_x=2.0, initial_pose_y=2.0,
                                   laser_model_type="beam", laser_max_range=8.0,
                                   beam_fast_path=mode))
    node.set_map(make_grid(data, 0.1))
    assert node._state.particles.log_weight.is_cuda
    before = (raycast.launches, cuda_beam.launches, cuda_beam_lut.launches)
    before_exact = raycast.exact_launches
    pts = np.random.default_rng(0).uniform(0.5, 2.0, (30, 2)).astype(np.float32)
    res = node.handle_scan((0.0, 0.0, 0.0), pts)
    assert res.valid and np.isfinite(res.pose).all()
    after = (raycast.launches, cuda_beam.launches, cuda_beam_lut.launches)
    want = {"exact": (0, 0, 0), "lut": (0, 0, 0), "sphere_trace": (0, 1, 0),
            "windowed": (0, 0, 1)}[mode]
    assert tuple(a - b for a, b in zip(after, before)) == want
    # the exact path's weights: one launch of R1's exact entry
    assert raycast.exact_launches - before_exact == (mode == "exact")


# -- slice 5: B9, B1-log, B4-log, B6-int8 ---------------------------------------------


def scan_lut_case(dev, downsample):
    """The arena's padded pz³ field at the shared-scan filter's geometry
    (4 m, (8, 128) alignment), and its first scan."""
    from beluga_tpu_torch.filters.builders import make_shared_scan_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.models.sensor.likelihood_field_lut import scan_lut_padded

    data = synthetic.tracking_arena(384, 0.05)
    xs, ys, yaws = synthetic.circle_trajectory(1)
    pts, mask = synthetic.simulate_scans(data, 0.05, xs, ys, yaws, BEAMS)
    _, ctx, _ = make_shared_scan_filter(make_grid(data, 0.05, device=dev), device=dev)
    field = ctx["field"]
    padded, pad = scan_lut_padded(field, 4.0, "pallas", downsample)
    mask[0, 3] = False  # a masked beam
    return (padded, torch.as_tensor(pts[0]).to(dev), torch.as_tensor(mask[0]).to(dev),
            field.resolution * downsample, pad)


@pytest.mark.parametrize("sampling,downsample,k", [("nearest", 2, 128), ("bilinear", 1, 128),
                                                   ("bilinear", 2, 7), ("nearest", 1, 33),
                                                   ("nearest", 2, 1), ("bilinear", 2, 1)])
def test_b9_kernel_matches_plain_version(dev, sampling, downsample, k):
    """B9 from the reference's tables and from the scan (the prologue
    path, the main path's) bit-equal to the plain version, with the
    window's halo the field's pad, as large as fits, and 0 (every beam
    through L2); two launches bit-equal."""
    from beluga_tpu_torch.ops import cuda_scan_lut as b9

    padded, pts, mask, res, pad = scan_lut_case(dev, downsample)
    shifts, weights = b9.scan_lut_tables(pts, mask, res, k, *padded.shape, sampling)
    want = b9.correlate_reference(padded, shifts, weights, sampling)
    before = b9.launches
    got = b9.correlate(padded, shifts, weights, sampling, halo=pad)
    points = [b9.scan_lut_correlate(padded, pts, mask, res, k, sampling, halo=h)
              for h in (pad, None, 0, pad)]
    torch.cuda.synchronize()
    assert b9.launches == before + 5
    assert got.shape == (k, *padded.shape) and torch.isfinite(got).all()
    assert torch.equal(got, want)
    for p in points:
        assert torch.equal(p, want)


@pytest.mark.parametrize("nb", [45, 200])
@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
@pytest.mark.parametrize("hp,wp,k,halo", [(280, 384, 128, 42), (101, 77, 33, 10),
                                          (17, 40, 1, 3), (50, 300, 9, None)])
def test_b9_kernel_any_shift(dev, sampling, hp, wp, k, halo, nb):
    """Tables with shifts drawn anywhere in [0, Hp) x [0, Wp), most of them
    outside the window (read through L2), on fields whose dims are no
    multiple of the 32 x 96 tile, with 45 beams or 200 (about 140 live a
    bin: more than a staged batch's 64 slots): bit-equal to the plain
    version, and the same with a halo as large as fits; two launches
    bit-equal."""
    from beluga_tpu_torch.ops import cuda_scan_lut as b9

    gen = torch.Generator(device=dev).manual_seed(hp + k + nb)
    padded = torch.rand((hp, wp), generator=gen, device=dev)
    shifts = torch.stack([torch.randint(0, hp, (k, nb), generator=gen, device=dev),
                          torch.randint(0, wp, (k, nb), generator=gen, device=dev)], -1)
    shifts = shifts.to(torch.int32).contiguous()
    weights = torch.rand((k, nb, 3), generator=gen, device=dev)
    weights[..., 0] *= torch.rand((k, nb), generator=gen, device=dev) < 0.7
    if sampling == "nearest":
        weights[..., 1:] = 0.0
    want = b9.correlate_reference(padded, shifts, weights, sampling)
    got = b9.correlate(padded, shifts, weights, sampling, halo=halo)
    again = b9.correlate(padded, shifts, weights, sampling, halo=halo)
    wide = b9.correlate(padded, shifts, weights, sampling)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want) and torch.equal(wide, want)


@pytest.mark.parametrize("sampling", ["nearest", "bilinear"])
def test_b9_kernel_leaves_out_masked_beams(dev, sampling):
    """The kernel stages only the (bin, beam) pairs with m != 0: masks that
    differ by bin, over more beams than a warp has lanes, give the plain
    version's sums bit for bit, and a bin with every beam masked is 0."""
    from beluga_tpu_torch.ops import cuda_scan_lut as b9

    padded, pts, mask, res, _ = scan_lut_case(dev, 2)
    k = 9
    shifts, weights = b9.scan_lut_tables(pts, mask, res, k, *padded.shape, sampling)
    gen = torch.Generator(device=dev).manual_seed(5)
    keep = torch.rand(weights.shape[:2], generator=gen, device=dev) < 0.6
    keep[0] = False
    weights[..., 0] *= keep
    got = b9.correlate(padded, shifts, weights, sampling)
    want = b9.correlate_reference(padded, shifts, weights, sampling)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not bool(got[0].any()) and bool(got[1:].any())


@pytest.mark.parametrize("n,batch", [(2000, None), (4096, 64), (777, 5)])
def test_b1_log_kernel_matches_plain_version(dev, n, batch):
    from beluga_tpu_torch.ops import cuda_reweight as b1

    args, _ = arena_inputs(n, dev, seed=2, batch=batch)
    before = b1.log_launches, b1.launches
    single = (*args[:7], one_beam(args[7]), *args[8:])
    assert torch.equal(b1.fused_reweight(*single, log_space=True),
                       b1.fused_reweight_reference(*single, log_space=True))
    got = b1.fused_reweight(*args, log_space=True)
    want = b1.fused_reweight_reference(*args, log_space=True)
    torch.cuda.synchronize()
    assert (b1.log_launches, b1.launches) == (before[0] + 2, before[1])
    assert bool((got < 0).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)  # the beam-sum order


@pytest.mark.parametrize("n,batch", [(4096, 64), (262144, None)])
def test_b4_log_kernel_matches_plain_version(dev, n, batch):
    from beluga_tpu_torch.ops import cuda_reweight as b1

    args, _ = arena_inputs(n, dev, seed=3, batch=batch)
    v3 = b1.build_values3(args[0], args[1], log_space=True)
    before = b1.values3_log_launches, b1.values3_launches

    def both(mask):
        kernel = b1.fused_reweight(*args[:7], mask, *args[8:], values3=v3, log_space=True)
        plain = b1.fused_reweight_values3_reference(v3, *args[2:7], mask, *args[8:],
                                                    log_space=True)
        return kernel, plain

    got1, want1 = both(one_beam(args[7]))
    assert torch.equal(got1, want1)
    got, want = both(args[7])
    torch.cuda.synchronize()
    assert (b1.values3_log_launches, b1.values3_launches) == (before[0] + 2, before[1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    exact = b1.fused_reweight(*args, log_space=True)
    assert float((got - exact).abs().max()) < float(exact.abs().max()) * 2.0**-7


def states_case(dev, n, batch=None, nb=BEAMS, seed=0, codes_book=None):
    """The states entry's inputs: the arena's field (its code table, or
    ``codes_book``), states spread over the table and 10% beyond each edge
    (some endpoints off the map), and per filter ``nb`` beams within 3.5 m,
    80% unmasked (beam 0 always)."""
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid

    _, ctx = make_likelihood_field_filter(
        make_grid(synthetic.tracking_arena(384, 0.05), 0.05, device=dev),
        AmclNodeConfig().likelihood_field_params(), device=dev)
    field = ctx["field"]
    codes, book = codes_book or ctx["field_codes"]
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    h, w = codes.shape
    x = rng.uniform(-0.1, 1.1, (*lead, n)) * w * field.resolution
    y = rng.uniform(-0.1, 1.1, (*lead, n)) * h * field.resolution
    th = rng.uniform(-np.pi, np.pi, (*lead, n))
    states = SE2.from_xytheta(*(v.astype(np.float32) for v in (x, y, th)), device=dev)
    ang, r = rng.uniform(-np.pi, np.pi, (*lead, nb)), rng.uniform(0.1, 3.5, (*lead, nb))
    points = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    mask = rng.random((*lead, nb)) < 0.8
    mask[..., 0] = True
    return (codes, book, field, states, torch.as_tensor(points, device=dev),
            torch.as_tensor(mask, device=dev))


def states_both(case, mask, values3, log_space):
    """The states entry and its plain version on ``case`` with ``mask``."""
    from beluga_tpu_torch.ops import cuda_reweight as b1

    codes, book, field, states, points, _ = case
    args = (codes, book, field.world_to_field, states, points, mask, field.resolution,
            field.unknown_prob)
    return (b1.fused_reweight_states(*args, values3=values3, log_space=log_space),
            b1.fused_reweight_states_reference(*args, values3=values3, log_space=log_space))


MODES = [("codes", False), ("codes", True), ("values3", False), ("values3", True)]


# (n, filters, beams): on 132 SMs with 60 beams the lanes a particle are 16
# below 16896 particles, then 8, 4 and 2, and 1 from 135168; 5 beams allow
# 2, one beam 1
@pytest.mark.parametrize("table,log_space", MODES)
@pytest.mark.parametrize("n,batch,nb", [(1, None, BEAMS), (2000, None, BEAMS), (3, None, 200),
                                        (2000, None, 5), (2000, None, 1), (1000, 3, BEAMS),
                                        (4096, 64, BEAMS), (20000, None, BEAMS),
                                        (65537, None, BEAMS), (100000, None, BEAMS),
                                        (262144, None, BEAMS), (300000, None, BEAMS)])
def test_b1_b4_states_entry_matches_plain_version(dev, n, batch, nb, table, log_space):
    """The states entry (the transform composed in the kernel) against its
    plain version (lie.py's composition, then the plain kernel): one beam
    bit-equal, the full sum within rtol 1e-5 (atol 1e-5 in log space), two
    launches bit-equal, and bit-equal to the transform entry on the plain
    composition (the same cells, lanes and sums)."""
    from beluga_tpu_torch.ops import cuda_reweight as b1

    case = states_case(dev, n, batch, nb, seed=n + nb)
    codes, book, field, states, points, mask = case
    v3 = b1.build_values3(codes, book, log_space) if table == "values3" else None
    before = b1.states_launches
    got1, want1 = states_both(case, one_beam(mask), v3, log_space)
    assert torch.equal(got1, want1)
    got, want = states_both(case, mask, v3, log_space)
    again, _ = states_both(case, mask, v3, log_space)
    torch.cuda.synchronize()
    assert b1.states_launches == before + 3
    assert got.shape == states.x.shape and torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 if log_space else 0.0)
    tf = field.world_to_field @ states
    via = b1.fused_reweight(codes, book, tf.x.contiguous(), tf.y.contiguous(),
                            tf.rot.cos.contiguous(), tf.rot.sin.contiguous(), points, mask,
                            field.resolution, field.unknown_prob, values3=v3,
                            log_space=log_space)
    assert torch.equal(got, via)


@pytest.mark.parametrize("table", ["codes", "values3"])
@pytest.mark.parametrize("n", [2000, 300000])  # 8 blocks, and more than the card holds at once
def test_b1_b4_cells_on_and_beside_cell_edges(dev, table, n):
    """Endpoints on cell edges (x = k * res in float32) and one and two
    ulps to either side, zeros and tiny negatives, on a table whose
    neighbouring cells read different values: each single-beam weight
    equal to the plain version's, through both entries."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.ops import cuda_reweight as b1

    rng = np.random.default_rng(n)
    res, unknown = 0.05, 0.5
    codes = torch.as_tensor(rng.integers(0, 200, (384, 384), dtype=np.uint8), device=dev)
    book = torch.as_tensor(rng.uniform(0.05, 1.0, 200).astype(np.float32), device=dev)
    v3 = b1.build_values3(codes, book) if table == "values3" else None
    edges = (np.arange(-3, 388, dtype=np.float32) * np.float32(res)).astype(np.float32)
    near = np.concatenate([edges, *(np.nextafter(edges, np.float32(s * np.inf)) for s in (-1, 1)),
                           *(np.nextafter(np.nextafter(edges, np.float32(s * np.inf)),
                                          np.float32(s * np.inf)) for s in (-1, 1)),
                           np.array([0.0, -0.0, -1e-45, 1e-45, -1e-30, -1e-7], np.float32)])
    x, y = rng.choice(near, n), rng.choice(near, n)
    states = SE2.from_xytheta(x, y, np.zeros(n, np.float32), device=dev)
    world_to_field = SE2.identity(device=dev)
    points = torch.zeros((1, 2), device=dev)  # the endpoint is the state's (x, y)
    mask = torch.ones(1, dtype=torch.bool, device=dev)
    args = (codes, book, world_to_field, states, points, mask, res, unknown)
    got = b1.fused_reweight_states(*args, values3=v3)
    want = b1.fused_reweight_states_reference(*args, values3=v3)
    tf = world_to_field @ states
    particles = [t.contiguous() for t in (tf.x, tf.y, tf.rot.cos, tf.rot.sin)]
    via = b1.fused_reweight(codes, book, *particles, points, mask, res, unknown, values3=v3)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(via, want)
    fx, _ = b1.endpoint_cells(*particles, points, res)
    assert 0 < int((fx == 384).sum()) and 0 < int((fx == -1).sum())  # both map edges met


@pytest.mark.parametrize("table,log_space", MODES)
def test_b1_b4_states_entry_all_or_no_beams_masked_and_off_map(dev, table, log_space):
    """Every beam masked (the base alone), none masked, and a particle of
    each filter whose every endpoint lies off the map (the off-map value on
    every beam)."""
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.ops import cuda_reweight as b1

    codes, book, field, states, points, mask = states_case(dev, 3000, 2, BEAMS, seed=5)
    xy = states.xy.clone()
    xy[:, 7] = torch.tensor([-100.0, 250.0], device=dev)
    case = (codes, book, field, SE2(xy, SO2(states.rot.z)), points, mask)
    v3 = b1.build_values3(codes, book, log_space) if table == "values3" else None
    base = 0.0 if log_space else 1.0
    none, want_none = states_both(case, torch.zeros_like(mask), v3, log_space)
    every, want_every = states_both(case, torch.ones_like(mask), v3, log_space)
    torch.cuda.synchronize()
    assert torch.equal(none, want_none) and bool((none == base).all())
    torch.testing.assert_close(every, want_every, rtol=1e-5, atol=1e-5 if log_space else 0.0)
    u = torch.tensor(field.unknown_prob, device=dev)
    off = torch.log(u) if log_space else u * u * u
    torch.testing.assert_close(every[:, 7], (base + BEAMS * off).expand(2), rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("log_space", [False, True])
def test_b1_states_entry_large_code_table(dev, log_space):
    """A 512 x 512 code table (256 KB, more than an SM's L1 holds beside
    the block's shared memory) at 300000 particles, with codes beyond the
    codebook."""
    from beluga_tpu_torch.ops import cuda_reweight as b1

    rng = np.random.default_rng(11)
    codes = torch.as_tensor(rng.integers(0, 256, (512, 512), dtype=np.uint8), device=dev)
    book = torch.as_tensor(rng.uniform(0.05, 1.0, 230).astype(np.float32), device=dev)
    case = states_case(dev, 300000, nb=BEAMS, seed=11, codes_book=(codes, book))
    got1, want1 = states_both(case, one_beam(case[5]), None, log_space)
    got, want = states_both(case, case[5], None, log_space)
    torch.cuda.synchronize()
    assert torch.equal(got1, want1)
    if log_space:  # codes >= 230 read 0: log 0 = -inf in both
        assert bool(torch.isinf(got).any()) and torch.equal(torch.isinf(got), torch.isinf(want))
        finite = torch.isfinite(want)
        torch.testing.assert_close(got[finite], want[finite], rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("n,tile,tblk", [(262144, 512, 16), (5000, 128, 8)])
def test_b6_int8_kernel_matches_plain_version(dev, n, tile, tblk):
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import (
        build_windowed_scan_lut,
        windowed_coords,
    )
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    w, states, lut = window_case(dev, n, workloads.WINDOWED_FILTER, workloads.windowed)
    st = w.state.particles.state
    geo = {k: workloads.WINDOWED_FILTER[k] for k in ("k_bins", "win", "dth", "max_point_radius")}
    lut = build_windowed_scan_lut(w.ctx["field"], w.points[0], w.mask[0], torch.mean(st.x),
                                  torch.mean(st.y), torch.atan2(torch.mean(st.rot.sin),
                                                                torch.mean(st.rot.cos)),
                                  table_dtype="int8", padded_cubed=w.ctx["field_pad3"],
                                  dft=w.ctx["winlut_dft"], **geo)
    assert lut.values_t.dtype == torch.int8 and lut.scale.is_cuda
    xi, yi, t = (v.contiguous() for v in windowed_coords(lut, states))
    before = b6.int8_launches, b6.launches
    got = b6.winlut_lookup(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk, scale=lut.scale)
    want = b6.winlut_lookup_reference(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk,
                                      scale=lut.scale)
    torch.cuda.synchronize()
    assert (b6.int8_launches, b6.launches) == (before[0] + 1, before[1])
    assert 0 < int((got == lut.miss).sum()) < n
    assert torch.equal(got, want)


def int8_window_case(dev, n, stray_every=20):
    """``window_case`` of the windowed filter with an int8 table."""
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import build_windowed_scan_lut
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.WINDOWED_FILTER
    w, states, _ = window_case(dev, n, cfg, workloads.windowed, stray_every)
    st = w.state.particles.state
    geo = {k: cfg[k] for k in ("k_bins", "win", "dth", "max_point_radius")}
    lut = build_windowed_scan_lut(w.ctx["field"], w.points[0], w.mask[0], torch.mean(st.x),
                                  torch.mean(st.y), torch.atan2(torch.mean(st.rot.sin),
                                                                torch.mean(st.rot.cos)),
                                  table_dtype="int8", padded_cubed=w.ctx["field_pad3"],
                                  dft=w.ctx["winlut_dft"], **geo)
    return w, states, lut


@pytest.mark.parametrize("n,tile,tblk,dtype", [
    (262144, 512, 16, "bf16"), (5000, 128, 8, "bf16"), (3000, 2048, 16, "bf16"),
    (20000, 8192, 16, "bf16"), (262144, 512, 16, "int8"), (5001, 128, 8, "int8")])
def test_b6_states_matches_plain_version(dev, n, tile, tblk, dtype):
    """B6's states entry against its plain version (the coordinate chain,
    then the lookup): an equal miss set, bf16 within rtol 1e-6 and int8
    bit-equal; and bit-equal to the coordinates entry at the plain chain's
    coordinates (the kernel's chain is the plain one, bit for bit)."""
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import windowed_coords
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    if dtype == "int8":
        _, states, lut = int8_window_case(dev, n)
    else:
        _, states, lut = window_case(dev, n, workloads.WINDOWED_FILTER, workloads.windowed)
    states = SE2(states.xy.contiguous(), SO2(states.rot.z.contiguous()))
    before = (b6.launches, b6.int8_launches, b6.states_launches, b6.int8_states_launches)
    got = b6.winlut_lookup_states(lut, states, lut.miss, 1.0, tile, tblk)
    want = b6.winlut_lookup_states_reference(lut, states, lut.miss, 1.0, tile, tblk)
    torch.cuda.synchronize()
    int8 = dtype == "int8"
    assert (b6.launches, b6.int8_launches, b6.states_launches, b6.int8_states_launches) == (
        before[0], before[1], before[2] + (not int8), before[3] + int8)
    assert torch.equal(got == lut.miss, want == lut.miss)
    assert 0 < int((got == lut.miss).sum()) < n
    if int8:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    xi, yi, t = (v.contiguous() for v in windowed_coords(lut, states))
    old = b6.winlut_lookup(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk, scale=lut.scale)
    assert torch.equal(got, old)


@pytest.mark.parametrize("n,tile,tblk,stray_every,shift", [
    (262144, 512, 16, 20, 0.0), (5000, 128, 8, 7, 0.0), (3001, 64, 16, 3, 0.0),
    (100000, 4096, 16, 50, 0.0), (4096, 512, 16, 20, -30.0), (4096, 512, 16, 20, 1.3)])
def test_b6_coverage_matches_plain_version(dev, n, tile, tblk, stray_every, shift):
    """B6's coverage entry equals its plain version (the window origin about
    the cloud's centre, shifted by ``shift`` m so that the origin clamps at
    the map's edge, the coordinates, the slab rule, the share), twice in a
    row (its scratch is left zero)."""
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import field_window
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.WINDOWED_FILTER
    w, states, _ = window_case(dev, n, cfg, workloads.windowed, stray_every)
    st = w.state.particles.state
    centre = (torch.mean(st.x) + shift, torch.mean(st.y) - shift,
              torch.atan2(torch.mean(st.rot.sin), torch.mean(st.rot.cos)))
    geo = field_window(w.ctx["field"], cfg["k_bins"], cfg["win"], cfg["dth"],
                       cfg["max_point_radius"])
    before = b6.coverage_launches
    got = b6.winlut_coverage_states(geo, states, *centre, tile, tblk)
    again = b6.winlut_coverage_states(geo, states, *centre, tile, tblk)
    want = b6.winlut_coverage_states_reference(geo, states, *centre, tile, tblk)
    torch.cuda.synchronize()
    assert b6.coverage_launches == before + 2
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, want) and torch.equal(again, want)
    if shift == 0.0:
        assert 0.5 < float(got) < 1.0


def test_b6_coverage_on_two_streams(dev):
    """B6's coverage entry keeps its count a (device, stream): gates queued
    on a side stream and on the default stream, each behind a spin so that
    they overlap on the card, each equal the plain version."""
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import field_window
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.WINDOWED_FILTER
    w, states, _ = window_case(dev, 65536, cfg, workloads.windowed, 20)
    st = w.state.particles.state
    centre = (torch.mean(st.x), torch.mean(st.y),
              torch.atan2(torch.mean(st.rot.sin), torch.mean(st.rot.cos)))
    geo = field_window(w.ctx["field"], cfg["k_bins"], cfg["win"], cfg["dth"],
                       cfg["max_point_radius"])
    want = b6.winlut_coverage_states_reference(geo, states, *centre, 512, 16)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for _ in range(4):
        with torch.cuda.stream(side):
            torch.cuda._sleep(1_000_000)
            outs.append(b6.winlut_coverage_states(geo, states, *centre, 512, 16))
        outs.append(b6.winlut_coverage_states(geo, states, *centre, 512, 16))
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got, want)


def test_windowed_update_on_card(dev):
    """One forced update of the windowed filter: its gate is one launch of
    B6's coverage entry; a gate that passes scores through the states entry
    (the coordinates entry never), B1 scores the exact tail."""
    from beluga_tpu_torch.filters.amcl import host_pose, update
    from beluga_tpu_torch.ops import cuda_reweight, cuda_winlut
    from beluga_tpu_torch.tools import workloads

    w = workloads.windowed(2, dev, 65536)
    before = (cuda_winlut.coverage_launches, cuda_winlut.states_launches, cuda_winlut.launches,
              cuda_reweight.launches)
    state, est = update(w.params, w.models, w.ctx, w.state._replace(force_update=True),
                        host_pose(w.scans.xs[0], w.scans.ys[0], w.scans.yaws[0]), w.points[0],
                        w.mask[0])
    assert est.valid and torch.isfinite(est.pose.xy).all()
    assert (cuda_winlut.coverage_launches, cuda_winlut.states_launches, cuda_winlut.launches,
            cuda_reweight.launches) == (before[0] + 1, before[1] + 1, before[2], before[3] + 1)


def test_prob_node_on_card(dev):
    """The prob node with its default device: a scan launches B1-log and not
    the cube B1."""
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.ops import cuda_reweight as b1

    data = np.zeros((80, 80), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 100
    data[30:40, 30:40] = 100
    node = AmclNode(AmclNodeConfig(max_particles=300, min_particles=50, set_initial_pose=True,
                                   initial_pose_x=2.0, initial_pose_y=2.0,
                                   laser_model_type="likelihood_field_prob"))
    node.set_map(make_grid(data, 0.1))
    before = b1.log_launches, b1.launches
    pts = np.random.default_rng(0).uniform(0.5, 2.0, (30, 2)).astype(np.float32)
    assert node.handle_scan((0.0, 0.0, 0.0), pts).valid
    assert (b1.log_launches, b1.launches) == (before[0] + 1, before[1])


def test_shared_scan_update_on_card(dev):
    """The shared-scan filter on the card: ``prepare`` launches B9 once and
    the update launches no reweight kernel."""
    from beluga_tpu_torch.filters.amcl import AmclParams, host_pose, init_state, update
    from beluga_tpu_torch.filters.builders import make_shared_scan_filter
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.core.random import sample_normal_se2
    from beluga_tpu_torch.ops import cuda_reweight as b1
    from beluga_tpu_torch.ops import cuda_scan_lut as b9

    data = np.zeros((96, 96), np.int8)
    data[0, :] = data[-1, :] = data[:, 0] = data[:, -1] = 100
    data[30:40, 50:60] = 100
    models, ctx, prepare = make_shared_scan_filter(
        make_grid(data, 0.05), n_theta=64, max_point_radius=2.5,
        lut_build_kwargs=dict(sampling="nearest", downsample=2))
    params = AmclParams(max_particles=4096, min_particles=1024, resampling="systematic")
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(gen, sample_normal_se2(gen, 4096, host_pose(2.4, 2.4, 0.3),
                                              np.eye(3) * 0.05), params)
    pts = torch.as_tensor(np.random.default_rng(1).uniform(-2, 2, (40, 2)),
                          dtype=torch.float32, device=dev)
    mask = torch.ones(40, dtype=torch.bool, device=dev)
    before = b9.launches, b1.launches, b1.values3_launches
    sctx = prepare(ctx, pts, mask)
    state, est = update(params, models, sctx, state, host_pose(0.0, 0.0, 0.0), pts, mask)
    assert est.valid and torch.isfinite(est.pose.xy).all()
    assert (b9.launches, b1.launches, b1.values3_launches) == (before[0] + 1, *before[1:])


# -- slice 6: the NDT probe (B10) and the 3D code-table lookup (B11) ----------


def random_ndt_map(d, m, dev, seed=0):
    """``m`` distinct random cells about the origin (2D keys on both sides
    of 2^31), random means and covariances."""
    from beluga_tpu_torch.maps.ndt import make_ndt_map

    rng = np.random.default_rng(seed)
    span = max(int(m ** (1 / d)) + 2, 4)
    cells = np.unique(rng.integers(-span, span, (2 * m, d)), axis=0)[:m]
    means = rng.normal(0, 1, (len(cells), d))
    covs = np.broadcast_to(np.eye(d) * 0.1, (len(cells), d, d))
    return make_ndt_map(cells, means, covs, 0.5, device=dev), cells


@pytest.mark.parametrize("d,m,shape", [(2, 287, (64, 64, 60, 9)), (3, 996, (512, 300, 7)),
                                       (2, 20000, (100000,)), (2, 0, (1000,)), (3, 7, (5, 7))])
def test_b10_kernel_matches_plain_version(dev, d, m, shape):
    """B10 bit-equal to its plain version: keys on both sides of 2^31 (2D),
    tables that fit shared memory and one that does not (20000 keys), an
    empty map, hits and misses."""
    from beluga_tpu_torch.maps.ndt import encode_cells
    from beluga_tpu_torch.ops import cuda_ndt as b10

    if m:
        ndt_map, cells = random_ndt_map(d, m, dev)
    else:
        from beluga_tpu_torch.maps.ndt import make_ndt_map

        ndt_map = make_ndt_map(np.zeros((0, d)), np.zeros((0, d)), np.zeros((0, d, d)), 0.5,
                               device=dev)
        cells = np.zeros((1, d), np.int64)
    rng = np.random.default_rng(1)
    # half the queries on a map cell, half moved by a stencil offset
    moved = rng.integers(-1, 2, (*shape, d)) * (rng.random(shape) < 0.5)[..., None]
    q = cells[rng.integers(0, len(cells), shape)] + moved
    queries = encode_cells(torch.as_tensor(q, device=dev))
    if d == 2 and m:
        keys = ndt_map.keys.cpu().numpy()
        assert (keys >= 2**31).any() and (keys < 2**31).any()
    before = b10.launches
    got = b10.ndt_probe(ndt_map.keys, ndt_map.values, ndt_map.num_cells, queries)
    want = b10.ndt_probe_reference(ndt_map.keys, ndt_map.values, ndt_map.num_cells, queries)
    torch.cuda.synchronize()
    assert b10.launches == before + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    if m:
        assert bool(got[1].any()) and not bool(got[1].all())


@pytest.mark.parametrize("volume", ["bench", "floor"])
def test_b11_kernel_matches_plain_version(dev, volume):
    """B11 bit-equal to its plain version on the bench volume (49 x 1029
    codes, in shared memory) and a 200 x 200 x 50 floor (2 MB, read from
    global memory), queries outside the table on every side, and a short
    codebook (codes beyond it read 0)."""
    from beluga_tpu_torch.maps.voxel import make_distance_codes, make_distance_grid
    from beluga_tpu_torch.ops import cuda_codebook as b11

    rng = np.random.default_rng(2)
    dims = (21, 49, 49) if volume == "bench" else (50, 200, 200)
    occ = rng.random(dims) < 0.01
    grid = make_distance_grid(occ, 0.2, max_distance=2.0, device=dev)
    codes, book = make_distance_codes(grid, 0.2, 2.0)
    h, w = codes.shape
    yi = torch.as_tensor(rng.integers(-3, h + 3, 300000), dtype=torch.int32, device=dev)
    xi = torch.as_tensor(rng.integers(-3, w + 3, 300000), dtype=torch.int32, device=dev)
    before = b11.launches
    for bk in (book, book[:7].contiguous()):
        got = b11.codebook_lookup(codes, bk, yi, xi)
        want = b11.codebook_lookup_reference(codes, bk, yi, xi)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert b11.launches == before + 2


def ndt_weights_case(d, rows, batch, minl, dev, seed=3, n=1500, c=200, layout="dense"):
    """The fused NDT kernel's arguments, and the map's cell index: a map of
    ``rows`` cells (its means inside them), measurement cells made from map
    means seen from a pose (60% live, NaN in the masked ones) and ``n``
    poses about it, one filter or ``batch``.  ``layout`` "sparse" adds 16
    map cells 300 cells away on every axis, so that the map's box is past
    the index's budget; "alias" moves every other pose by the key's period
    along x (65536 cells in 2D, 1024 in 3D), so that its probes find the
    map's cells through the key's wrap, and widens the map's covariances
    so that such a hit weighs."""
    from beluga_tpu_torch.lie import SE2, SE3, SO3
    from beluga_tpu_torch.maps.ndt import make_ndt_map
    from beluga_tpu_torch.models.sensor.ndt import KERNEL_2D, KERNEL_3D, pose_matrices

    rng = np.random.default_rng(seed)
    span = int(np.ceil((3 * rows) ** (1 / d) / 2)) + 1
    cells = np.unique(rng.integers(-span, span, (4 * rows, d)), axis=0)
    cells = cells[rng.permutation(len(cells))[:rows]]
    means = (cells + rng.uniform(0.2, 0.8, cells.shape)) * 0.5
    a = rng.normal(0, 0.1, (len(cells), d, d))
    map_covs = a @ a.transpose(0, 2, 1) + 0.01 * np.eye(d)
    if layout == "sparse":
        far = np.unique(rng.integers(0, 4, (16, d)), axis=0) + 300
        cells = np.concatenate([cells, far])
        means = np.concatenate([means, (far + 0.5) * 0.5])
        map_covs = np.concatenate([map_covs, np.broadcast_to(0.01 * np.eye(d), (len(far), d, d))])
    if layout == "alias":
        map_covs = map_covs + (1e9 if d == 2 else 1e6) * np.eye(d)
    ndt_map = make_ndt_map(cells, means, map_covs, 0.5, device=dev)
    lead = () if batch is None else (batch,)
    yaw, origin = rng.uniform(-np.pi, np.pi), rng.uniform(-1.0, 1.0, d)
    rz = np.eye(d)
    rz[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    mu = means[rng.integers(0, rows, (*lead, c))]
    local = (mu - origin) @ rz + rng.normal(0, 0.05, mu.shape)
    b = rng.normal(0, 0.08, (*lead, c, d, d))
    mcov = b @ np.swapaxes(b, -1, -2) + 1e-3 * np.eye(d)
    cmask = rng.uniform(size=(*lead, c)) < 0.6
    local[~cmask], mcov[~cmask] = np.nan, np.nan
    xy = origin[:2] + rng.normal(0, 0.2, (*lead, n, 2))
    if layout == "alias":
        xy[..., 1::2, 0] += (1 << (16 if d == 2 else 10)) * 0.5
    yaws = yaw + rng.normal(0, 0.05, (*lead, n))

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    if d == 2:
        states = SE2.from_xytheta(f32(xy[..., 0]), f32(xy[..., 1]), f32(yaws))
    else:
        z = origin[2] + rng.normal(0, 0.05, (*lead, n, 1))
        tilt = [f32(rng.normal(0, 0.02, (*lead, n))) for _ in range(2)]
        states = SE3(f32(np.concatenate([xy, z], -1)), SO3.from_rpy(*tilt, f32(yaws)))
    rot, trans = pose_matrices(states)
    return (ndt_map.keys, ndt_map.values, ndt_map.num_cells, ndt_map.resolution,
            rot.contiguous(), trans.contiguous(), f32(local), f32(mcov),
            torch.as_tensor(cmask, device=dev), KERNEL_2D if d == 2 else KERNEL_3D, minl,
            1.0, 1.0), ndt_map.index


@pytest.mark.parametrize("minl", [0.0, 1e-3])
@pytest.mark.parametrize("batch", [None, 8])
@pytest.mark.parametrize("rows", ["shared", "global", "sparse", "alias"])
@pytest.mark.parametrize("d,c", [(2, 200), (3, 200), (2, 3000), (3, 2000)])
def test_ndt_weights_kernel_matches_plain_version(dev, d, c, rows, batch, minl):
    """The fused NDT kernel against its plain version on the same card
    tensors: a map whose rows fit shared memory (287 or 996 rows) and one
    too large for it (4000 rows, read through L2), both probed through
    their cell index; a map whose box is past the index's budget (the 287
    or 996 rows and 16 cells far away), probed by the binary search; poses
    whose probes find the map through the key's wrap; one filter and a
    fleet, ``minimum_likelihood`` zero and positive, and 200 measurement
    slots or so many (60% live) that the live cells outgrow the kernel's
    32 KB cell cache and the rest are read through L2.  Every particle's
    weight within rtol 1e-4 (the kernel's sums take another order, its 3D
    inverse the adjugate where the plain version takes LU); two launches
    bit-equal; the search of the sorted keys gives the index's bits."""
    from beluga_tpu_torch.ops import cuda_ndt

    m = {"global": 4000}.get(rows, 287 if d == 2 else 996)
    layout = rows if rows in ("sparse", "alias") else "dense"
    args, index = ndt_weights_case(d, m, batch, minl, dev, c=c, layout=layout)
    assert (index is None) == (rows == "sparse")
    if c > 200:  # live cells beyond the cache in every filter
        cache_cells = 32 * 1024 // (4 * (d + d * d))
        assert int(args[8].sum(-1).min()) > cache_cells
    before = cuda_ndt.weights_launches, cuda_ndt.weights_indexed_launches
    got = cuda_ndt.ndt_weights(*args, index=index)
    again = cuda_ndt.ndt_weights(*args, index=index)
    searched = cuda_ndt.ndt_weights(*args)
    want = cuda_ndt.ndt_weights_reference(*args, particle_chunk=128)
    torch.cuda.synchronize()
    indexed = 0 if index is None else 2
    assert (cuda_ndt.weights_launches, cuda_ndt.weights_indexed_launches) == \
        (before[0] + 3, before[1] + indexed)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert torch.equal(got, again) and torch.equal(got, searched)
    rel = (got - want).abs() / want.abs()
    assert float(rel.max()) <= 1e-4, float(rel.max())
    assert float(want.max()) > 1.5  # cells match the map
    if rows == "alias":  # the moved poses find the map too
        assert float(want[..., 1::2].max()) > 1.1


@pytest.mark.parametrize("reach", ["near", "far"])
@pytest.mark.parametrize("d", [2, 3])
def test_ndt_weights_kernel_with_a_stencil_of_its_own(dev, d, reach):
    """A stencil other than the standard one through the cell index: its
    probes are not unrolled; "far" adds an offset longer than the box, so
    that no cell has its whole stencil inside and every probe is checked
    against the box.  Within rtol 1e-4 of the plain version, and the
    search of the sorted keys gives the same bits."""
    from beluga_tpu_torch.ops import cuda_ndt

    args, index = ndt_weights_case(d, 287 if d == 2 else 996, 4, 1e-3, dev)
    kern = np.array([[0, 0], [1, 0], [-1, 0], [0, 1], [0, -1], [2, 0], [0, -2]]) if d == 2 \
        else np.array([[0, 0, 0], [1, 1, 0], [-1, 0, 1], [0, 2, 0]])
    if reach == "far":
        kern = np.concatenate([kern, [[0] * (d - 1) + [-40]]])
    args = (*args[:9], kern.astype(np.int32), *args[10:])
    assert index is not None and index.size[-1] <= 40  # "far" reaches past the box
    before = cuda_ndt.weights_indexed_launches
    got = cuda_ndt.ndt_weights(*args, index=index)
    searched = cuda_ndt.ndt_weights(*args)
    want = cuda_ndt.ndt_weights_reference(*args, particle_chunk=128)
    torch.cuda.synchronize()
    assert cuda_ndt.weights_indexed_launches == before + 1
    assert torch.equal(got, searched)
    rel = (got - want).abs() / want.abs()
    assert float(rel.max()) <= 1e-4, float(rel.max())
    assert float(want.max()) > 1.5


def test_ndt_nodes_on_card(dev):
    """The 2D and 3D NDT nodes on arena maps of more than 256 rows: the
    fused NDT kernel once per update, through the map's cell index, and
    the standalone probe B10 never."""
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.maps.ndt import make_ndt_map
    from beluga_tpu_torch.ndt_node import NdtAmclNode, NdtAmclNode3D
    from beluga_tpu_torch.ops import cuda_ndt as b10
    from beluga_tpu_torch.tools.make_ndt_map import fit_ndt_cells, grid_to_points

    data = synthetic.tracking_arena(384, 0.05)
    xs, ys, yaws = synthetic.circle_trajectory(3)
    pts, mask = synthetic.simulate_scans(data, 0.05, xs, ys, yaws, 360)
    p2 = grid_to_points(data, 0.05)
    cfg = AmclNodeConfig(set_initial_pose=True, initial_pose_x=float(xs[0]),
                         initial_pose_y=float(ys[0]), initial_pose_yaw=float(yaws[0]))
    node = NdtAmclNode(cfg)
    node.set_map(make_ndt_map(*fit_ndt_cells(p2, 0.4), 0.4))
    before, before_fused, before_indexed = (b10.launches, b10.weights_launches,
                                            b10.weights_indexed_launches)
    for i in range(3):
        r = node.handle_point_cloud((xs[i], ys[i], yaws[i]), pts[i][mask[i]])
        assert r.valid and np.hypot(r.pose[0] - xs[i], r.pose[1] - ys[i]) < 0.9
    assert b10.weights_launches == before_fused + 3  # the fused kernel once per update
    assert b10.weights_indexed_launches == before_indexed + 3  # by the map's cell index
    assert b10.launches == before
    p3 = np.concatenate([np.c_[p2, np.full(len(p2), z)] for z in np.arange(0, 2, 0.1)])
    node3 = NdtAmclNode3D(AmclNodeConfig())
    node3.set_map(make_ndt_map(*fit_ndt_cells(p3, 0.5), 0.5))
    node3.set_initial_pose((xs[0], ys[0], 0.0), (0.0, 0.0, yaws[0]),
                           np.diag([0.05, 0.05, 0.01, 0.001, 0.001, 0.02]))
    cloud = np.concatenate([np.c_[pts[0][mask[0]], np.full(int(mask[0].sum()), z)]
                            for z in (0.5, 1.0, 1.5)]).astype(np.float32)
    before, before_fused, before_indexed = (b10.launches, b10.weights_launches,
                                            b10.weights_indexed_launches)
    r = node3.handle_point_cloud((0, 0, 0, 0, 0, 0), cloud)
    assert r.valid and r.pose.shape == (6,)
    assert b10.weights_launches == before_fused + 1 and b10.launches == before
    assert b10.weights_indexed_launches == before_indexed + 1


def test_vdb_filter_on_card(dev):
    """The VDB filter with its code table: B11 once per update."""
    from beluga_tpu_torch.filters.amcl import update
    from beluga_tpu_torch.lie import SE3
    from beluga_tpu_torch.ops import cuda_codebook as b11
    from beluga_tpu_torch.tools import workloads

    w = workloads.vdb_filter(2, dev, n=8192)
    before = b11.launches
    state = w.state
    for t in range(2):
        state, est = update(w.params, w.models, w.ctx, state._replace(force_update=True),
                            SE3.identity(), w.points, w.mask)
        assert est.valid
    assert b11.launches == before + 2
    err = est.pose.xyz.cpu() - torch.tensor(workloads.VDB_TRUTH[:3], dtype=torch.float32)
    assert float(torch.linalg.vector_norm(err)) < 0.9


# -- the node's host plane: pinned staging, the pipelined mode, the replay ----------


def raw_node(dev, raw, pipelined, tmp_path):
    """The nav2-default node on the arena loaded from PGM and YAML."""
    from beluga_tpu_torch.maps.occupancy import load_pgm_yaml
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.tools import workloads

    node = AmclNode(workloads.node_config(raw.scans), seed=0, device=dev, pipelined=pipelined)
    node.set_map(load_pgm_yaml(workloads.arena_map_yaml(tmp_path), device=dev))
    return node


def drive_raw(node, raw, t0, t1):
    from beluga_tpu_torch.tools import workloads

    s = raw.scans
    return [node.handle_laser_scan((s.xs[t], s.ys[t], s.yaws[t]), raw.ranges[t], raw.angle_min,
                                   raw.angle_increment, workloads.LDS_MIN, workloads.LDS_MAX)
            for t in range(t0, t1)]


def assert_gate(results, raw, offset=0):
    s = raw.scans
    for t, r in enumerate(results, offset):
        if r.valid:
            assert math.hypot(r.pose[0] - s.xs[t], r.pose[1] - s.ys[t]) < 0.9
            d = (r.pose[2] - s.yaws[t] + math.pi) % (2 * math.pi) - math.pi
            assert abs(d) < math.radians(30.0)


def test_pipelined_node_on_card_is_the_synchronous_node_shifted(dev, tmp_path):
    """The pipelined node on the card against the synchronous node on the
    card, 20 raw scans each: the same estimates a scan later (both run the
    same kernels in the same order; none of the update's operations is
    run-to-run non-deterministic at 2000 particles), every valid one
    within the 0.9 m / 30 degree gate; its staging buffers pinned."""
    from beluga_tpu_torch.tools import workloads

    raw = workloads.arena_ranges(20)
    sync_node, pipe_node = (raw_node(dev, raw, p, tmp_path) for p in (False, True))
    sync_res = drive_raw(sync_node, raw, 0, 20)
    pipe_res = drive_raw(pipe_node, raw, 0, 20)
    assert not pipe_res[0].valid
    pipe_res = pipe_res[1:] + [pipe_node.flush()]
    assert pipe_node.flush() is None
    assert sum(r.valid for r in sync_res) >= 19
    assert_gate(sync_res, raw)
    assert_gate(pipe_res, raw)
    for s, p in zip(sync_res, pipe_res):
        assert s.valid == p.valid
        if s.valid:
            np.testing.assert_array_equal(s.pose, p.pose)
            np.testing.assert_array_equal(s.map_to_odom, p.map_to_odom)
    st = pipe_node._staging
    assert all(b.is_pinned() for b in st.inputs + st.outputs)


def test_pinned_staging_buffers_are_written_only_after_their_event(dev, tmp_path, monkeypatch):
    """With the card held behind a spin before each update, so that the
    host runs ahead: every write of a staging slot finds the event of the
    scan that used the slot before complete, and each harvest inside
    ``handle_scan`` returns while the stream is still busy with the scan
    just queued (it waited on the previous scan's event, not on the
    stream); the results stay the synchronous node's a scan later."""
    from beluga_tpu_torch.node import ScanStaging
    from beluga_tpu_torch.tools import workloads

    raw = workloads.arena_ranges(10)
    node = raw_node(dev, raw, True, tmp_path)
    seen, busy, stage, harvest = [], [], ScanStaging.stage, ScanStaging.harvest

    def checked_stage(self, packed):
        slot = self.count % 2
        if self.count >= 2:
            seen.append(self.events[slot].query())
        torch.cuda._sleep(50_000_000)  # hold the card behind this scan's inputs
        return stage(self, packed)

    def checked_harvest(self, slot):
        out = harvest(self, slot)
        assert self.events[slot].query()
        busy.append(not torch.cuda.current_stream().query())
        return out

    monkeypatch.setattr(ScanStaging, "stage", checked_stage)
    monkeypatch.setattr(ScanStaging, "harvest", checked_harvest)
    res = drive_raw(node, raw, 0, 10)
    assert len(seen) == 8 and all(seen)
    assert busy == [True] * 9
    tail = node.flush()
    assert_gate(res[1:] + [tail], raw)
    sync = raw_node(dev, raw, False, tmp_path)
    monkeypatch.setattr(ScanStaging, "stage", stage)
    monkeypatch.setattr(ScanStaging, "harvest", harvest)
    for s, p in zip(drive_raw(sync, raw, 0, 10), res[1:] + [tail]):
        assert s.valid == p.valid
        if s.valid:
            np.testing.assert_array_equal(s.pose, p.pose)


def test_replay_on_device_on_card_is_the_per_scan_loop(dev, tmp_path):
    """``replay_on_device`` on the card against the node's per-scan loop
    from the same state: the same updates and the same estimates."""
    from beluga_tpu_torch.io.replay import replay_on_device
    from beluga_tpu_torch.tools import workloads

    raw = workloads.arena_ranges(16)
    args = (raw.angle_min, raw.angle_increment, workloads.LDS_MIN, workloads.LDS_MAX)
    host = raw_node(dev, raw, False, tmp_path)
    results = drive_raw(host, raw, 0, 16)
    node = raw_node(dev, raw, False, tmp_path)
    prepared = [node.prepare_scan(r, *args) for r in raw.ranges]
    s = raw.scans
    odoms = np.stack([s.xs, s.ys, s.yaws], -1).astype(np.float32)
    _, ests = replay_on_device(node.params, node._models, node._ctx, node._state, odoms,
                               np.stack([p for p, _ in prepared]),
                               np.stack([m for _, m in prepared]))
    np.testing.assert_array_equal(ests.valid, [r.valid for r in results])
    z = ests.pose.rot.z
    xyt = torch.cat([ests.pose.xy, torch.atan2(z[:, 1], z[:, 0])[:, None]], -1).cpu().numpy()
    for t, r in enumerate(results):
        if r.valid:
            np.testing.assert_array_equal(xyt[t].astype(np.float64), r.pose)
    assert_gate(results, raw)


# -- slice 14: residual resampling, the sparse cluster estimate, the winlut fleet ----


@pytest.mark.parametrize("lead,n", [((), 262144), ((64,), 4096), ((3,), 1000)])
def test_residual_on_card_matches_plain_version(dev, lead, n):
    """Residual resampling on the card: two B2 passes a resample; each
    particle at least ``floor(M·w)`` times, none of zero weight; and each
    pass, at the positions of ``residual_positions``, against B2's plain
    version on the same card tensors: the floor copies bit-equal, the
    residual rows equal but where a position lies between the kernel's and
    the plain CDF's values of one entry (the kernel's sums are associated
    in another order)."""
    from beluga_tpu_torch.ops import cuda_resample as b2

    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    w = torch.rand((*lead, n), generator=gen, device=dev) ** 4
    w[..., n // 3 : n // 3 + n // 20] = 0.0
    u = torch.rand((*lead, n + 1), generator=gen, device=dev)
    ident = torch.arange(n, dtype=torch.float32, device=dev).expand(*lead, n).contiguous()
    before = b2.launches, b2.cdf_launches, b2.tile_launches
    got = b2.resample_take_tree_residual(w, ident, u)
    torch.cuda.synchronize()
    one = int(n <= b2.TILE)  # two passes, each one launch up to a tile a filter
    assert (b2.launches, b2.cdf_launches, b2.tile_launches) == (
        before[0] + 2 - 2 * one, before[1] + 2 - 2 * one, before[2] + 2 * one)
    counts, u_det, residual, u_res, det = b2.residual_positions(w, u)
    for i in np.ndindex(lead):
        c = torch.bincount(got[i].long(), minlength=n)
        assert int(c.sum()) == n and bool((c >= counts[i].long()).all())
        assert not c[w[i] == 0].any()
    planes = ident[..., None, :]
    for weights, pos, mine in ((counts, u_det, det), (residual, u_res, ~det)):
        # each CDF made once: torch.cumsum on the card is not run-to-run
        # deterministic past one CUB tile
        k_cdf, p_cdf = b2.monotone_cdf(weights.contiguous()), b2.monotone_cdf_reference(weights)
        kernel = b2.search_take(k_cdf, pos, planes)[..., 0]
        plain = b2.search_take_reference(p_cdf, pos, planes)[..., 0]
        moved = (torch.searchsorted(k_cdf, pos, right=True)
                 != torch.searchsorted(p_cdf, pos, right=True))
        assert torch.equal((kernel != plain) & mine, moved & mine)
        if mine is det:  # integer prefix sums: the floor copies' CDF is exact
            assert not (moved & det).any()


def test_sparse_cluster_on_card(dev):
    """The sparse cluster estimate on the card: two calls give the same bits
    at 262144 particles, and at 4096 it picks the dense form's cluster (the
    mean within 1e-5 of its norm, the covariance within 1e-5 of the second
    moment's scale: both forms take E[x²] - mean² from raw sums)."""
    from beluga_tpu_torch.algorithms.cluster import cluster_based_estimate
    from beluga_tpu_torch.lie import SE2

    rng = np.random.default_rng(0)
    for n in (262144, 4096):
        xyt = np.concatenate([rng.normal([5, 5, 0.3], [0.4, 0.4, 0.2], (n // 2, 3)),
                              rng.normal([7, 6, -1], [0.5, 0.5, 0.3], (n - n // 2, 3))])
        st = SE2.from_xytheta(*(xyt[:, i].astype(np.float32) for i in range(3)), device=dev)
        w = torch.as_tensor(rng.random(n).astype(np.float32), device=dev)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        mask[-n // 10:] = False
        a = cluster_based_estimate(st, w, mask, method="sparse")
        b = cluster_based_estimate(st, w, mask, method="sparse")
        assert torch.equal(a[0].xy, b[0].xy) and torch.equal(a[0].rot.z, b[0].rot.z)
        assert torch.equal(a[1], b[1])
        if n == 4096:  # moments within 1e-5 of their scale, as chip_smoke holds them
            d = cluster_based_estimate(st, w, mask, method="dense")
            scale = float(d[0].xy.abs().max())
            torch.testing.assert_close(a[0].xy, d[0].xy, rtol=0, atol=1e-5 * scale)
            torch.testing.assert_close(a[1], d[1], rtol=0,
                                       atol=1e-5 * (scale**2 + float(d[1].abs().max())))


@pytest.mark.parametrize("batch,n,tile", [(64, 3584, 512), (5, 1000, 128), (1, 65536, 512)])
def test_b6_coverage_per_filter_matches_plain_version(dev, batch, n, tile):
    """B6's coverage entry over a fleet ``[B, N]``: one launch, each
    filter's share equal to its plain version's and to the single-filter
    call on that filter; one filter moved off the window covers less."""
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import field_window
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.WINLUT_FLEET
    w = workloads.winlut_fleet(1, dev, batch=2, n=1024)  # the field and the first pose
    geo = field_window(w.ctx["field"], cfg["k_bins"], cfg["win"], cfg["dth"],
                       cfg["max_point_radius"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(batch)
    xy = (torch.randn((batch, n, 2), generator=gen, device=dev) * 0.3
          + torch.tensor([w.scans.xs[0], w.scans.ys[0]], dtype=torch.float32, device=dev))
    th = torch.sort(torch.randn((batch, n), generator=gen, device=dev) * 0.05
                    + float(w.scans.yaws[0])).values
    if batch > 1:
        xy[0] += 4.0
    states = SE2(xy.contiguous(), SO2.exp(th))
    states = SE2(states.xy, SO2(states.rot.z.contiguous()))
    centre = (torch.mean(xy[..., 0]), torch.mean(xy[..., 1]),
              torch.atan2(torch.mean(states.rot.sin), torch.mean(states.rot.cos)))
    before = b6.coverage_launches
    got = b6.winlut_coverage_states(geo, states, *centre, tile, 16)
    torch.cuda.synchronize()
    assert b6.coverage_launches == before + 1 and got.shape == (batch,)
    want = b6.winlut_coverage_states_reference(geo, states, *centre, tile, 16)
    assert torch.equal(got, want)
    for i in range(batch):
        one = SE2(states.xy[i].contiguous(), SO2(states.rot.z[i].contiguous()))
        assert torch.equal(b6.winlut_coverage_states(geo, one, *centre, tile, 16), got[i])
    if batch > 1:
        assert float(got[0]) < float(got[1:].min())


def test_winlut_fleet_on_card(dev):
    """The winlut fleet on the card: a tight fleet takes the fast branch
    (B6's states entry once, B4 once for the tails), a diverged filter the
    exact one (B4 once, B6's states entry never); the coverage entry once
    an update either way."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.ops import cuda_reweight as b1, cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    w = workloads.winlut_fleet(4, dev, batch=8, n=2048)
    state = w.state
    for t in range(2):
        odoms = workloads.fleet_odometry(w.scans, t, 8)
        before = b6.states_launches, b6.coverage_launches, b1.values3_launches
        state, est = w.step(w.ctx, state._replace(force_update=np.ones(8, bool)), odoms,
                            w.points[t], w.mask[t])
        torch.cuda.synchronize()
        assert (b6.states_launches, b6.coverage_launches, b1.values3_launches) == (
            before[0] + 1, before[1] + 1, before[2] + 1)
        pose = est.pose.as_xytheta().cpu().numpy()
        assert np.hypot(pose[:, 0] - w.scans.xs[t], pose[:, 1] - w.scans.ys[t]).max() < 0.9
    p = state.particles
    moved = SE2(p.state.xy.clone(), p.state.rot)
    moved.xy[0] += 5.0
    state = state._replace(particles=p.replace(state=moved))
    before = b6.states_launches, b6.coverage_launches, b1.values3_launches
    state, est = w.step(w.ctx, state._replace(force_update=np.ones(8, bool)),
                        workloads.fleet_odometry(w.scans, 2, 8), w.points[2], w.mask[2])
    torch.cuda.synchronize()
    assert (b6.states_launches, b6.coverage_launches, b1.values3_launches) == (
        before[0], before[1] + 1, before[2] + 1)


# -- slice 15: the sharded mega filter and fleet over NCCL at world size 1 ---------


@pytest.fixture
def nccl_world(dev, tmp_path):
    """This process as the one rank of an NCCL process group."""
    import torch.distributed as dist

    from beluga_tpu_torch.parallel.multihost import start_process_group

    start_process_group("cuda", 0, 1, f"file://{tmp_path}/store")
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def _tree_equal(a, b) -> bool:
    from beluga_tpu_torch.utils.checkpoint import _leaves

    la, lb = [], []
    _leaves(a, la)
    _leaves(b, lb)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        same = (torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor)
                else np.array_equal(np.asarray(x), np.asarray(y)))
        if not same:
            return False
    return True


def _particles_equal(a, b) -> bool:
    return (torch.equal(a.state.xy, b.state.xy) and torch.equal(a.state.rot.z, b.state.rot.z)
            and torch.equal(a.log_weight, b.log_weight) and torch.equal(a.active, b.active))


def test_mega_sharded_over_nccl_is_the_dense_update(nccl_world):
    """The fused mega filter (65536 particles, pooled recovery) sharded over
    one NCCL rank: three forced updates on the same draws are bit-equal to
    the dense update's, B5 once an update."""
    from torch.distributed.device_mesh import init_device_mesh

    from beluga_tpu_torch.filters.amcl import draw_update, host_pose, update
    from beluga_tpu_torch.ops import cuda_fused_step
    from beluga_tpu_torch.parallel.mega import make_mega_update, shard_draws, shard_mega_state
    from beluga_tpu_torch.tools import workloads

    dev = nccl_world
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("tp",))
    w = workloads.mega(3, dev, 65536)
    mega = make_mega_update(w.params, w.models, mesh)
    sharded, dense = shard_mega_state(mesh, w.state), w.state
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for t in range(3):
        args = (host_pose(w.scans.xs[t], w.scans.ys[t], w.scans.yaws[t]), w.points[t], w.mask[t])
        draws = draw_update(w.params, w.models, w.ctx, dense.particles, gen)
        before = cuda_fused_step.launches
        sharded, sest = mega(w.ctx, sharded._replace(force_update=True), *args,
                             draws=shard_draws(draws, w.params, mesh), sort_now=t == 0)
        assert cuda_fused_step.launches == before + 1
        dense, dest = update(w.params, w.models, w.ctx, dense._replace(force_update=True), *args,
                             draws=draws, sort_now=t == 0)
        assert _particles_equal(sharded.particles, dense.particles)
        assert float(torch.abs(sest.pose.xy - dest.pose.xy).max()) <= 1e-5


def test_fleet_sharded_over_nccl_is_the_dense_fleet(nccl_world):
    """An 8 x 4096 codebook16 fleet placed by ``shard_fleet`` on a (1, 1)
    NCCL mesh, its map by ``replicate``: two updates on the same draws
    bit-equal to the dense fleet's."""
    from torch.distributed.device_mesh import init_device_mesh

    from beluga_tpu_torch.filters.amcl import draw_update, update
    from beluga_tpu_torch.parallel.fleet import make_fleet_update, replicate, shard_fleet
    from beluga_tpu_torch.parallel.mega import shard_draws
    from beluga_tpu_torch.tools import workloads

    dev = nccl_world
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "tp"))
    w = workloads.fleet(2, dev, 8, 4096)
    fleet_update = make_fleet_update(w.params, w.models, mesh)
    sharded, ctx, dense = shard_fleet(mesh, w.state), replicate(mesh, w.ctx), w.state
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    for t in range(2):
        odoms = workloads.fleet_odometry(w.scans, t, 8)
        draws = draw_update(w.params, w.models, w.ctx, dense.particles, gen)
        sharded, sest = fleet_update(ctx, sharded, odoms, w.points[t], w.mask[t],
                                     draws=shard_draws(draws, w.params, mesh))
        dense, dest = update(w.params, w.models, w.ctx, dense, odoms, w.points[t], w.mask[t],
                             draws=draws)
        assert _particles_equal(sharded.particles, dense.particles)
        assert torch.equal(sest.pose.xy, dest.pose.xy)


def test_sharded_checkpoint_on_card(nccl_world, tmp_path):
    """A sharded mega state on the card saved and loaded bit-equal,
    generators included; the next update from either is the same."""
    from torch.distributed.device_mesh import init_device_mesh

    from beluga_tpu_torch.filters.amcl import host_pose
    from beluga_tpu_torch.parallel.mega import make_mega_update, shard_mega_state
    from beluga_tpu_torch.tools import workloads
    from beluga_tpu_torch.utils.checkpoint import load_state_sharded, save_state_sharded

    dev = nccl_world
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("tp",))
    w = workloads.mega(2, dev, 65536)
    mega = make_mega_update(w.params, w.models, mesh)
    args = (host_pose(w.scans.xs[0], w.scans.ys[0], w.scans.yaws[0]), w.points[0], w.mask[0])
    state, _ = mega(w.ctx, shard_mega_state(mesh, w.state), *args, sort_now=True)
    save_state_sharded(str(tmp_path / "ckpt"), state, mesh)
    back = load_state_sharded(str(tmp_path / "ckpt"), shard_mega_state(mesh, w.state), mesh)
    assert back.particles.log_weight.is_cuda
    assert _tree_equal(state, back)
    nxt = (host_pose(w.scans.xs[1], w.scans.ys[1], w.scans.yaws[1]), w.points[1], w.mask[1])
    a, _ = mega(w.ctx, state._replace(force_update=True), *nxt)
    b, _ = mega(w.ctx, back._replace(force_update=True), *nxt)
    assert _tree_equal(a, b)


def test_tree_scatter_on_card_writes_the_last_duplicate(dev):
    """The pooled injection's scatter on the card: of 4096 entries aimed at
    64 slots of 2097152, each slot holds its last entry, as on the CPU."""
    from beluga_tpu_torch.core.particles import tree_scatter

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n, p = 2097152, 4096
    idx = torch.randint(0, 64, (p,), generator=gen, device=dev)
    upd = torch.arange(2 * p, dtype=torch.float32, device=dev).reshape(p, 2)
    got = tree_scatter(torch.zeros(n, 2, device=dev), idx, upd)
    want = torch.zeros(n, 2)
    for j, i in enumerate(idx.tolist()):
        want[i] = upd[j].cpu()
    assert torch.equal(got.cpu(), want)


# -- repeatable running sums and segment sums (the positions, the index-form
# CDFs, the sharded CDF and the NDT cells sum in a fixed order on the card)

POSITION_ULP = CDF_ULP  # positions in [0, 1): the running sum's bound, as B2's CDF


def _spacings_float64(u):
    s = torch.cumsum(-torch.log1p(-u.double()), dim=-1)
    return s


@pytest.mark.parametrize("lead,n", [((), 10002), ((64,), 4097), ((), 262145)])
def test_sorted_multinomial_positions_repeat_on_card(dev, lead, n):
    """Two calls on the same uniforms give equal bits (the running sum is
    B2's CDF kernel, one launch a call), sorted and below 1; within
    POSITION_ULP of the float64 construction and of the plain version on
    the same card tensors (``torch.cumsum``); the largest gaps printed."""
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops.resample import sorted_multinomial_from_uniform

    gen = torch.Generator(device=dev).manual_seed(n)
    u = torch.rand((*lead, n), generator=gen, device=dev)
    u[..., 5] = 0.0  # a zero spacing
    before = b2.sum_launches
    a = sorted_multinomial_from_uniform(u)
    b = sorted_multinomial_from_uniform(u)
    torch.cuda.synchronize()
    assert b2.sum_launches == before + 2
    assert torch.equal(a, b)
    assert (a[..., 1:] >= a[..., :-1]).all() and (a < 1.0).all()
    s = _spacings_float64(u)
    exact = s[..., :-1] / s[..., -1:]
    e = -torch.log1p(-u)
    plain = b2.running_sum_reference(e)
    plain = torch.clamp_max(plain[..., :-1] / plain[..., -1:], 1.0 - 2.0**-24)
    gap64, gap_plain = float((a.double() - exact).abs().max()), float((a - plain).abs().max())
    print(f"sorted multinomial {lead} x {n}: largest gap to float64 {gap64}, "
          f"to the plain version {gap_plain} (bound {POSITION_ULP})")
    assert gap64 <= POSITION_ULP and gap_plain <= POSITION_ULP


@pytest.mark.parametrize("r0", [0, 100000, 262143])
def test_sorted_residual_positions_repeat_on_card(dev, r0):
    """The residual positions at 262145 uniforms: two calls bit-equal, zeros
    below ``r0``, within POSITION_ULP of the float64 construction and of
    the plain version's."""
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops.resample import sorted_residual_from_uniform

    n = 262144
    gen = torch.Generator(device=dev).manual_seed(r0)
    u = torch.rand(n + 1, generator=gen, device=dev)
    r = torch.tensor(float(r0), device=dev)
    before = b2.sum_launches
    a = sorted_residual_from_uniform(u, r)
    b = sorted_residual_from_uniform(u, r)
    torch.cuda.synchronize()
    assert b2.sum_launches == before + 2
    assert torch.equal(a, b)
    assert not a[:r0].any() and (a[r0:][1:] >= a[r0:][:-1]).all() and (a < 1.0).all()
    s = _spacings_float64(u)
    exact = s[: n - r0] / s[n - r0]
    e = -torch.log1p(-u)
    m = b2.running_sum_reference(e)
    plain = torch.clamp_max(m[: n - r0] / m[n - r0], 1.0 - 2.0**-24)
    gap64 = float((a[r0:].double() - exact).abs().max()) if r0 < n else 0.0
    gap_plain = float((a[r0:] - plain).abs().max()) if r0 < n else 0.0
    print(f"residual r0={r0}: largest gap to float64 {gap64}, to the plain version "
          f"{gap_plain} (bound {POSITION_ULP})")
    assert gap64 <= POSITION_ULP and gap_plain <= POSITION_ULP


def test_search_indices_repeat_on_card(dev):
    """``search_indices`` at 262144 weights on B2's CDF kernel: two calls
    bit-equal (one CDF launch each), and the donors of the CPU's plain
    version but where a position lies between the two CDFs' values of one
    entry: each position whose donors differ within the CDFs' largest gap
    of the entry between them (the CPU's float32 cumsum runs in sequence,
    so ~0.2% of the dense systematic positions fall there)."""
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops.resample import search_indices, systematic_positions

    n = 262144
    w = cdf_weights(dev, (), n, 5)
    pos = systematic_positions(torch.Generator(device=dev).manual_seed(5), n)
    before = b2.cdf_launches
    a, b = search_indices(w, pos), search_indices(w, pos)
    torch.cuda.synchronize()
    assert b2.cdf_launches == before + 2
    assert torch.equal(a, b)
    plain = search_indices(w.cpu(), pos.cpu())
    cdf_k = b2.monotone_cdf(w).cpu().double()
    cdf_p = b2.monotone_cdf_reference(w.cpu()).double()
    gap = float((cdf_k - cdf_p).abs().max())
    moved = a.cpu() != plain
    edge = cdf_p[torch.minimum(a.cpu(), plain).long()[moved]]
    print(f"search_indices 262144: share of donors apart from the CPU's plain version "
          f"{float(moved.float().mean())}, the CDFs' largest gap {gap}")
    assert ((pos.cpu().double()[moved] - edge).abs() <= gap).all()
    assert not (w[a.long()] == 0).any()


def test_sharded_cdf_repeats_over_nccl(nccl_world):
    """``sharded_cdf`` at world size 1 over 2097152 weights: two calls
    bit-equal, within CDF_ULP of the float64 CDF."""
    import torch.distributed as dist

    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.parallel.collectives import sharded_cdf

    dev = nccl_world
    w = cdf_weights(dev, (), 2097152, 6)
    before = b2.sum_launches
    (la, oa), (lb, ob) = sharded_cdf(w, dist.group.WORLD), sharded_cdf(w, dist.group.WORLD)
    torch.cuda.synchronize()
    assert b2.sum_launches == before + 2
    assert torch.equal(la, lb) and torch.equal(oa, ob) and float(oa) == 0.0
    exact = torch.cumsum(w.double(), -1)
    gap = float((la.double() - exact / exact[-1]).abs().max())
    print(f"sharded_cdf 2097152: largest gap to float64 {gap} (bound {CDF_ULP})")
    assert gap <= CDF_ULP


def test_ndt_measurement_cells_repeat_on_card(dev):
    """``fit_measurement_cells`` on the NDT-3D node's 3600-point cloud: two
    calls bit-equal; the CPU's result's cell mask, its means within 4e-6
    relative and covariances within 1e-7 absolute (the bounds
    ``tests/test_torch_repeatable.py`` holds against the JAX package); the
    largest gaps printed."""
    from beluga_tpu_torch.models.sensor.ndt import fit_measurement_cells
    from beluga_tpu_torch.tools import workloads

    pts, mask = workloads.ndt_clouds(workloads.ndt_scans(1))
    tp, tm = torch.as_tensor(pts[0]), torch.as_tensor(mask[0])
    a = fit_measurement_cells(tp.to(dev), tm.to(dev), 0.5)
    b = fit_measurement_cells(tp.to(dev), tm.to(dev), 0.5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    cpu = fit_measurement_cells(tp, tm, 0.5)
    live = cpu[2]
    assert torch.equal(a[2].cpu(), live) and int(live.sum()) >= 10
    gap_mean = float(((a[0].cpu() - cpu[0])[live].abs() / cpu[0][live].abs().clamp_min(1e-30))
                     .max())
    gap_cov = float((a[1].cpu() - cpu[1])[live].abs().max())
    print(f"NDT cells: largest relative gap of the means {gap_mean}, of the covariances "
          f"{gap_cov} (absolute), card against CPU")
    assert gap_mean <= 4e-6 and gap_cov <= 1e-7
