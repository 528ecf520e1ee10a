#!/usr/bin/env python3
"""Build and drive the PyTorch + CUDA port (``beluga_tpu_torch``) on one
NVIDIA GPU, and fail unless it is right.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. device: the card's name and power limit;
2. build: every ``beluga_tpu_torch/csrc/*.cu`` with nvcc, one process per
   source, started together;
3. kernels: each kernel's wrapper on card tensors at the shapes the main
   paths give it (the node's 2000 particles x 60 beams, the fleet's 64
   filters x 4096 particles x 60 beams, the large and windowed filters'
   262144, the mega filter's 2097152), held against its plain PyTorch
   version on the same inputs and timed beside it: B1 (exact reweight), B4
   (codebook16 reweight), each through both its entries (the states entry,
   which composes ``world_to_field @ states`` in the kernel and is the main
   paths' call, and the transform entry): one unmasked beam bit-equal, the
   full beam sum within rtol 1e-5, two launches bit-equal and the entries
   bit-equal to each other; B2 (the whole resample take from the weights,
   one launch of its one-tile entry up to 4096 weights a filter and past
   that the CDF kernel then the search, each one launch a call: its CDF
   kernel held exactly where it must be exact and within CDF_ULP of a
   float64 prefix sum, the donors bit-equal to the search on that CDF; the
   CDF build and the search timed apart and beside the old path,
   ``torch.cumsum`` and ``torch.cummax`` before the search, the CDF kernel
   beside ``torch.cumsum``), B3 (pool take:
   the row entry, and the draw entry, the pooled recovery sampler's whole
   draw in one launch, at the fleet's 64 pools of 512 x 4096 draws, the large
   filter's 4096 x 262144 and the mega filter's 512 x 4096, translations and
   headings bit-equal), B6 (windowed LUT lookup, beside ``grid_sample`` as
   the library yardstick: the coordinates entry; the states entry, the
   lookup's coordinates composed in the kernel, bf16 within rtol 1e-6 and
   int8 bit-equal with an equal miss set and bit-equal to the coordinates
   entry at the plain chain's coordinates; the coverage entry, the windowed
   gate in one launch, equal to its plain version, also with its window's
   origin clamped at the map's edge)
   and B5 (fused propagate + lookup, its table in shared memory at the mega
   geometry and through L2 at the windowed filter's). ``ms`` is the time per
   call of calls issued back to back, the wrapper's host cost included;
   ``device_ms`` is the device's own time per call under ``torch.profiler``;
4. node: ``AmclNode`` at nav2 defaults tracks the synthetic arena's circle
   for 50 scans; every valid estimate must lie within 0.9 m / 30 degrees
   of the truth, and B1 and B2 (its one-tile entry) must have been launched;
5. large filter: one 262144-particle filter (systematic resampling, KLD
   down to 65536, pooled recovery) through ``filters.amcl.update`` for 12
   scans, same gate; B1, B2 and B3's draw entry launched, and B2's path calls no
   ``aten::cummax`` (here and in phases 7 and 8);
6. fleet: 64 filters x 4096 particles in codebook16 mode with theta-sorted
   slots and pooled recovery through ``parallel.fleet.make_fleet_update``
   for 40 scans, same gate on every filter; B4, B2 (its one-tile entry) and B3's draw
   entry launched once per update, B1 never;
7. mega: the JAX benchmark's headline filter, 1 x 2097152 particles x 60
   beams through the fused windowed kernel B5 (``bench.py:247-386``), 64
   forced updates with the theta sort on every 8th; every scan within
   0.9 m / 30 degrees and the last 32 within 0.35 m (the benchmark's own
   gate on its last block, ``bench.py:364-377``); B5 launched once per
   update, B1, B4 and B6 never;
8. windowed: the coverage-gated windowed filter, 262144 particles
   (``bench.py:880-900``), 40 forced updates, same 0.9 m / 30 degree gate;
   B6's coverage entry (the gate) once per update, B6's states entry at
   least once, B1 on every update (the exact tail, or the
   fallback); prints how many updates took each branch;
9. beam node: ``AmclNode`` with ``laser_model_type="beam"`` at nav2
   defaults (100 m range) in each ``beam_fast_path`` for 30 scans, same
   gate; R1's exact beam-weights entry once per update in ``exact`` (the
   model's weights in one launch, R1's ray entry never), R1's ray entry once
   (the range-LUT build) in ``lut`` and ``windowed``, B8 on every update in
   ``sphere_trace``, B7 on every update in ``windowed`` (with its
   window-origins kernel), B2 in all four;
10. long range: the JAX package's long-range beam row (1024² map at 0.1 m,
   2048 particles x 60 beams, 60 m, sphere trace), 40 forced updates along
   the arc of ``tests/test_system_long_range.py``; every scan after the 2
   warm-up scans within the gate; B8 once per update;
11. beam fleet: 64 filters x 4096 particles x 60 beams through the
   windowed range LUT (``bench.py:678-720``) for 40 scans, every filter
   within the gate; B7 and its window-origins kernel once per update, B1
   and B4 never, R1 during the build (its time printed);
12. prob node: ``AmclNode`` with nav2's probability model
   (``laser_model_type="likelihood_field_prob"``) at nav2 defaults for 50
   scans, same gate; B1-log on every update, the cube B1 never;
13. shared scan: the shared-scan filter of ``bench.py:916-955``, 262144
   particles, KLD down to 65536, the LUT (128 bins, 4 m, nearest,
   downsample 2) rebuilt before each of 40 forced updates, same gate; B9
   once per update, B1 and B4 (either mode) never; prints ms/update,
   particle-updates/s and the LUT build's share;
14. prob fleet: the fleet in the probability model's codebook16 mode for
   20 scans, every filter within the gate; B4-log once per update;
15. windowed int8: the windowed filter on int8 window tables for 20
   forced updates, same gate; B6-int8's states entry at least once, the
   coverage entry once per update, B1 on every update;
16. NDT node: ``NdtAmclNode`` at nav2 defaults on the 2D NDT map (the
   arena fitted at 0.4 m, 287 rows) for 50 scans of 360 beams at 3.5 m,
   same gate; the fused NDT kernel once per update, B10 never;
17. NDT fleet: ``bench.py:780-837``'s 64 filters x 4096 particles x 60
   points (12 map means x 5 points, so that cells are live), a fixed
   count, 20 forced updates, every filter within the gate at every scan;
   the fused NDT kernel once per update, B10 never;
18. NDT-3D node: ``NdtAmclNode3D`` at nav2 defaults on the 3D NDT map (the
   arena extruded to 2 m, fitted at 0.5 m, 996 rows), each cloud the
   360-beam scan at ten heights (3600 points), 30 scans, the gate on x, y
   and yaw; the fused NDT kernel once per update, B10 never;
19. VDB filter: BASELINE config #4 (``bench.py:722-778``), 131072 SE3
   particles x 80 points with ``voxel_size_hint=0.2``, 20 forced updates,
   each within 0.9 m / 30 degrees of (3, 3, 0, yaw 0.3); B11 once per
   update;
20. raw node: ``AmclNode`` at nav2 defaults on the arena written as a
   map_server map (PGM and YAML, in a temporary directory under ``build/``)
   and read by ``load_pgm_yaml``, fed the raw input of 62 scans of its
   circle: 360-beam LDS-01 ranges through ``handle_laser_scan`` (decimated
   to nav2's 60 beams by ``io/native.py``, whose form, native or numpy, is
   printed), synchronous and then pipelined, and the same returns as 3D
   clouds through ``handle_point_cloud``; per mode 40 scans on the host
   clock (ms an update, median and mean), 16 under the profiler (device
   busy and launches an update; the idle share is 1 - busy / the host
   clock's mean; the card's name and power limit beside them) and 6 with ``torch.cuda.set_sync_debug_mode("warn")``
   listing every line that made the host wait for the card, none of them
   in ``node.py`` in the pipelined mode (its harvest waits on the scan's
   event only); every valid estimate within the gate, B1 and B2 launched,
   and the largest difference of the pipelined estimates from the
   synchronous ones a scan earlier printed;
21. replay: ``tools/record.py`` records 60 steps on that map (R1's ray entry
   once a scan), then ``tools/localize.py`` replays the stream at nav2
   defaults host-driven and scan-driven, from the ``.npz`` and from a
   ``.db3`` bag of it (``io/rosbag.py:write_scan_bag``): the same updates in
   both modes, APE rmse within 0.9 m in each, B1 and B2 launched; the wall
   of each run printed;
22. omni node: ``AmclNode`` at nav2 defaults with
   ``robot_model_type="nav2_amcl::OmniMotionModel"`` (2000 particles) on
   the circle strafed (the robot faces outward) for 50 scans, same gate; B1
   and B2 launched;
23. stationary node: ``robot_model_type="stationary"``, 30 updates forced by
   ``request_nomotion_update`` at the circle's first pose, every one valid
   and within the gate;
24. residual: the large filter (262144, KLD down to 65536) for 12 scans and
   the fleet (64 x 4096, codebook16) for 20 with ``resampling="residual"``,
   every filter within the gate; B2 twice a resample (the large filter's
   CDF kernel as often, the fleet's one-tile entry, the positions' running
   sum once, no ``aten::cummax`` on its path
   or in the residual positions); the last weights resampled once
   more, every particle at least ``floor(M·w)`` times; the last 3 scans with
   ``set_sync_debug_mode("warn")``, no wait in ``ops/resample.py`` or
   ``ops/cuda_resample.py``;
25. sparse estimate: phase 20's raw node (synchronous) with ``max_particles:
   10000``, so that the cluster estimate takes its sparse form: its numbers
   and waits as phase 20's, none in ``algorithms/cluster.py``; the sparse
   form against the dense one at 4096 particles on the card (the same
   cluster, the first and second moments within 1e-5 of their scale) and
   bit-equal on two calls at 262144;
26. winlut fleet: 64 x 4096 through one shared windowed LUT an update
   (``benchmarks/report.py:289-318``: k_bins 64, a 128-cell window, tile
   512), from a tight cloud, for 20 scans, every filter within the gate:
   B6's coverage entry (the gate over the filter axis) once an update, B6's
   states entry and B4 (the tails) once a fast update, B4 once an exact
   one, the fast branch at least once; then filter 0 moved 5 m off, which
   trips the exact branch; the last 3 scans with the waits listed, one line
   of ``filters/builders.py`` among them (the gate's readback);
27. mega sharded: phase 7's mega filter (2097152 x 60) with its particles
   split over one ``torch.distributed`` rank a visible card (NCCL; world
   size 1 on one card, in this process; past it one process a card,
   rank 0 reporting), placed by ``shard_mega_state`` and stepped by
   ``make_mega_update`` for 64 forced updates, the θ sort on every 8th:
   phase 7's gate; B5 once an update, B2 (and its CDF) once a resample,
   B3's draw entry, B1, B4 and B6 never; then 8 updates against the dense
   update on the same ``UpdateDraws``, each from the sharded state
   gathered: at one rank particles, log-weights and the active count
   bit-equal and the estimate within 1e-5 (x, y) and 1e-4 (covariance),
   past it the estimate within 0.05 m (``tests/test_mega.py:187-237``);
   then 16 updates of each in turns (ms an update) and 4 sharded ones
   under ``torch.profiler`` (NCCL's kernels and device ms apart from every
   other kernel's), the peak device memory;
28. fleet sharded: phase 6's fleet placed by ``shard_fleet`` on the ``("dp",
   "tp")`` mesh of the ranks ((1, 1) on one card, ``tp`` 2 on an even
   count), its map by ``replicate``, 20 updates within the gate, B4, B2
   and B3's draw entry once an update, B1 never; then 4 updates against
   the dense fleet on the same draws (bit-equal at one rank, the
   estimates within 2e-4 past it); the sharded mega state through
   ``save_state_sharded`` and ``load_state_sharded``, bit-equal with its
   generators, and the next update from either the same; and ``python -m
   beluga_tpu_torch.parallel.multihost --particles 4096
   --filters-per-device 8`` as a subprocess, its rows parsed, filters/s
   above 0;
29. repeatable: the large residual filter, the sparse node (10000
   particles, multinomial), the multinomial fleet (64 x 4096) and the
   NDT-3D node, each built and run twice from the same generators for 4
   updates: particles (states, log-weights, active counts) and every
   estimate bit-equal between the two runs, the sorted positions' running
   sum (B2's CDF kernel without its division, "B2-sum running_sum")
   launched;
30. examples: ``examples/torch_tutorial_1d.py`` and
   ``examples/torch_fleet_demo.py`` at their defaults and
   ``examples/torch_mega_demo.py`` at 2^21 particles for 16 steps, each
   through its ``main``, which raises when it misses its gate (the
   tutorial's tail below 1.0; every filter and estimate within 0.9 m /
   30 degrees); B2's CDF kernel in the tutorial, B2 and the reweight in
   the fleet demo, B5 once a step and R1 in the mega demo;
and the landmark and bearing models at 2000 SE2 and 2000 SE3 particles x
32 detections x 256 landmarks against the CPU's run of the same inputs,
and one unscented transform on the card.  Phase 3 also holds B6's coverage
entry at the winlut fleet's shape (64 filters x 3584 prefix slots, one
filter out of the window), each filter's share equal to its plain
version's, one launch, under the coverage entry's ``other_shapes``.
Phase 3 also holds B2's CDF kernel without its division (``running_sum``,
the sorted positions' spacings) at the fleet's 64 x 4097, the node's 2001,
the sparse node's 10001 and the large residual filter's 262145 uniforms,
and at the sharded CDF's 2097152 weights: two calls bit-equal, monotone,
within CDF_ULP of the total from float64, the CDF its own division by its
total, one launch a call, timed beside its plain version and
``torch.cumsum``.

Phases 20, 21 and 25 run right after phase 4, while ``torch.profiler`` still
records every launch of a window.

Phase 3 also holds kernels B8 (the node's 2000 x 60 at 100 m, the
long-range 2048 x 60 at 60 m and the node's 2000 particles with a
1000-beam scan), B7 (64 x 4096 x 60, K = 128, θ-sorted slots
with strays) and R1 against their plain versions: R1's ray entry bit-equal
in both Bresenham variants on three maps (the arena: the node's 2000 x 60
rays at 100 m and the LUT build's 128 x 384 x 384 rays at 4 m, their
inputs broadcast as the build passes them, and ``tools/record.py``'s 360 rays at
3.5 m from one broadcast source; the long-range 1024² map, whose
128 KB bit plane a block stages in shared memory: 2048 x 60 rays at 60 m;
a 2048² map, whose 512 KB plane is read through L2: 2000 x 60 at 60 m),
and R1's exact beam-weights entry (the beam model's weights
in one launch) at the beam node's 2000 x 60 at 100 m and on the 2048² map
in both variants and both spaces, each beam's pz³ and the sums within
EXACT_RTOL of its plain version, the bit-equal shares printed, two
launches bit-equal; each R1 shape also prints one call's time alone over
50 calls (min, median, max), and
slice 5's: B9 (nearest at the shared-scan shape, 128 x 280 x 384, and
bilinear at full resolution, 128 x 552 x 640, beside ``conv2d``), B1-log
(2000 x 60 and 64 x 4096 x 60), B4-log (64 x 4096 x 60) and B6-int8
(262144 particles, [64, 128, 128]); and slice 6's: B10 at the NDT fleet's
particle chunk (64 x 512 particles x 60 cells x 9 stencil cells, 287 keys,
P = 6) and the 3D node's (512 x 3600 x 7, 996 keys, P = 12), B11 at the VDB
filter's 131072 x 80 queries on the bench volume (49 x 1029 codes, in
shared memory) and on a 200 x 200 x 50 building floor (2 MB of codes, from
global memory), each equal to its plain version (max abs err 0); and
slice 7's fused NDT kernel (B10 redesigned: the NDT model's whole stencil
likelihood in one launch) at the NDT node's 2000 particles x 360 slots
(2D map), the NDT fleet's 64 x 4096 x 60 slots and the NDT-3D node's 2000
x 3600 slots (3D map), every particle's weight within rtol 1e-4 of its
plain version, two launches bit-equal; each prints its live cells, hit
share and bound; and slice 8's redesigns: B9 from the scan (its tables
built in the kernel's prologue, the main path's call) and from tables, at
both B9 shapes, bit-equal to its plain version and two launches bit-equal,
with ``conv2d``'s device time (its calls queued behind a spin kernel, or
the reason for none); B7 also at the beam node's 2000 x 60 ``windowed``
shape (K = 128 at 100 m), two launches bit-equal, and its window-origins
kernel (B7's first launch of two) equal to ``window_origins`` at both
shapes.

Phases 4 to 28 run the configurations of ``beluga_tpu_torch/tools/workloads.py``;
phases 29 and 30 run after the landmark check, phases 27 and 28 last, and
the process group is gone before the last three lines.

Each path's launch counts are set to 0 just before it runs and read just
after; on every path B2 runs once a resample, one launch: past 4096
weights a filter its CDF kernel ("B2-cdf monotone_cdf") once a search
("B2 resample_take"), up to 4096 its one-tile entry ("B2-tile
resample_take") and no CDF kernel; its running sum ("B2-sum
running_sum") at most once a resample,
every B1, B1-log, B4 and B4-log launch goes through the states entry (no
PyTorch operation composes the transform first), and B3's row entry and
B6's coordinates entries are never launched (the pooled draw and the
windowed lookup and gate go through their new entries).  The line before
the last two is the ``kernels`` JSON; the line
before the last is ``nvidia-smi``'s name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations per unmasked (particle, beam) in kernel B1: 8 for the
# endpoint transform, 2 divisions, 2 for the cube, 1 for the sum; kernel B4
# reads the cube from its table
B1_OPS_PER_BEAM = 13
B4_OPS_PER_BEAM = 11
# B1-log: the transform and divisions (10), a log counted as 10, the sum;
# B4-log reads the log from its table, as B4
B1_LOG_OPS_PER_BEAM = 21
# the states entry composes world_to_field @ state once a particle: 8
# products and 6 sums, counted as 8 (the transform entry's inputs hold it)
SE2_COMPOSE_OPS = 8
# the main paths' entries of kernels B3 and B6, and the entries that no
# main path launches since they came (the counterparts of the reference's
# pallas_pool_take and winlut_lookup)
POOL_DRAW = "B3-draw pooled_free_cells"
# kernel B2's entries: the search on a CDF, the whole function in one
# launch where a filter fits one tile, the CDF kernel, and the CDF kernel
# without its division (the sorted positions' spacings); RESAMPLES, the
# calls of resample_take, is the first two's launches together
B2_SEARCH = "B2 resample_take"
B2_TILE = "B2-tile resample_take"
B2_CDF = "B2-cdf monotone_cdf"
RUNNING_SUM = "B2-sum running_sum"
RESAMPLES = "B2 resamples (search + one-tile)"
B2_TILE_WEIGHTS = 4096  # csrc/resample.cu kTile


def b2_entry(n: int) -> str:
    """The entry of B2 that resample_take launches for filters of n weights."""
    return B2_TILE if n <= B2_TILE_WEIGHTS else B2_SEARCH
WINLUT_STATES = {"bf16": "B6 winlut_lookup_states", "int8": "B6-int8 winlut_lookup_states"}
WINLUT_COVERAGE = "B6-coverage winlut_coverage_states"
OFF_MAIN_PATHS = ("B3 pool_take", "B6 winlut_lookup", "B6-int8 winlut_lookup")
# the launches of B1, B1-log, B4 and B4-log made through the states entry
REWEIGHT_STATES = "B1/B4 states entry"
REWEIGHT_KERNELS = ("B1 fused_reweight", "B1-log fused_reweight", "B4 fused_reweight values3",
                    "B4-log fused_reweight values3")
# kernel E1, the SE2 estimate (no Pallas counterpart: it replaces XLA's
# reductions in beluga_tpu/algorithms/estimation.py:estimate_se2); its bytes,
# 20 a particle in (a log-weight, the (x, y) and (cos, sin) pairs), 4 a
# filter's live count in, 52 a filter's estimate out
ESTIMATE = "E1 estimate_se2"
ESTIMATE_BYTES_PER_PARTICLE, ESTIMATE_BYTES_PER_FILTER = 20, 56
# kernel S1, the theta sort of sorted_slots filters (no Pallas counterpart:
# it replaces XLA's reductions, sort and gathers of beluga_tpu/filters/
# amcl.py:se2_sort_key and beluga_tpu/core/particles.py:tree_sort_by); its
# bytes, 20 a slot in (the (x, y) and (cos, sin) pairs, a log-weight) and 20
# out, 4 a filter's live count in
SORT = "S1 sort_slots_se2"
SORT_BYTES_PER_PARTICLE, SORT_BYTES_PER_FILTER = 40, 4
SORT_THETA_ATOL, SORT_Z_EDGE = 1e-6, 1e-4  # tests/test_torch_sort_cuda.py
# float32 operations per (output cell, unmasked beam) of kernel B9: nearest
# a multiply and an add; bilinear the x lerp (3), two products and two sums
B9_OPS = {"nearest": 2, "bilinear": 7}
# float32 operations per particle of kernel B6: 6 tents of 3, 14 products
# and 7 sums of the trilinear read, the base; kernel B5 adds the motion
# sample, the window affine and the heading bin (~40 with sincos counted
# as 8 each) and the log
B6_OPS_PER_PARTICLE = 40
# float32 operations per particle of B6's coordinate chain (its states and
# coverage entries): the composition (SE2_COMPOSE_OPS), two divisions and
# four sums for the window cell, atan2 and fmod counted as 10 each, and the
# wrap, the division and the sums of the heading bin (5)
B6_CHAIN_OPS = 8 + 6 + 10 + 10 + 5
B5_OPS_PER_PARTICLE = 120
EDGE = 1e-4  # window coordinates this close to an edge may flip validity
# the CDF kernel's bound against a float64 prefix sum over its total, N <= 2^21:
# each float32 sum is associated to a depth of ~30 additions
CDF_ULP = 64 * 2.0**-24

GATE_POS_M = 0.9  # tests/test_system.py:44-45
GATE_YAW_RAD = math.radians(30.0)
NODE_SCANS = 50
LARGE_N, LARGE_MIN, LARGE_SCANS = 262144, 65536, 12
MEGA_N = 2097152  # bench.py:266
FLEET_B, FLEET_N, FLEET_SCANS = 64, 4096, 40  # bench.py:46-49
MEGA_SCANS, MEGA_LAST, MEGA_LAST_GATE_M = 64, 32, 0.35  # bench.py:364-377
WINDOWED_SCANS = 40
BEAM_NODE_SCANS, LONG_RANGE_SCANS, LONG_RANGE_WARMUP, BEAM_FLEET_SCANS = 30, 40, 2, 40
BEAM_NODE_RANGE = 100.0  # nav2's laser_max_range: the beam node's range LUT
SHARED_SCAN_SCANS, PROB_FLEET_SCANS, WINDOWED_INT8_SCANS = 40, 20, 20
NDT_NODE_SCANS, NDT_FLEET_SCANS, NDT3D_SCANS, VDB_SCANS = 50, 20, 30, 20
NDT_CHUNK = 512  # the NDT plain version's particle chunk: B10's check shape
LIBRARY_LIMIT_MS = 1000.0  # a library yardstick slower than this per call is not timed
# float32 operations of the beam mixture, with exp counted as 10: per
# (particle, unmasked beam) two A&S erfs of ~28, eta_hit 6, the Gaussian 17,
# the short term's eta_short and its product 15, the rest 5; per (filter,
# unmasked beam), since it depends on the beam alone, exp(-lam z) and its
# product (11) and the z_rand or z_max tail (1).  Kernel B7 adds the bin and
# the blend (12) a ray, kernel B8 the ray direction (6) and 8 per trace
# step; kernel R1 takes ~10 integer operations per visited cell, and its
# exact entry adds B8's per-ray count (the direction and the mixture), the
# per-beam terms and the pose's composition
MIXTURE_RAY_OPS, MIXTURE_BEAM_OPS = 99, 12
B7_OPS_PER_RAY = MIXTURE_RAY_OPS + 12
B8_OPS_PER_RAY, B8_OPS_PER_STEP = MIXTURE_RAY_OPS + 6, 8
R1_OPS_PER_CELL = 10
# the exact entry against its plain version: pz³ and the sums within rtol
# 1e-5 (the sums' bound, as B1's); the same float32 operations in the same
# order, so bit-equal is the aim and each check prints the bit-equal share
EXACT_RTOL = 1e-5
# operations that the NDT stencil likelihood needs, by dimension: per
# (particle, live cell) the rotated mean (2D 8, 3D 18), the rotated
# covariance (24, 90), the cell (3 a axis) and the clamped sum (2); per
# (particle, live cell, stencil offset) the key (6) and one compare, what
# an exact match needs (the fused kernel's binary search of the sorted
# keys is its own cost, not counted); per hit the error and the total
# covariance (6, 12), the inverse and the quadratic form (19, 56), exp
# counted as 10 and the sum (3); integer operations count as float32 ones
NDT_CELL_OPS = {2: 40, 3: 119}
NDT_PROBE_OPS = 7
NDT_HIT_OPS = {2: 38, 3: 81}
# the fused kernel against its plain version: every particle's weight
# within rtol 1e-4 (the kernel sums the stencil and the cells in its own
# order and in 3D inverts by the adjugate where the plain version takes LU)
NDT_RTOL = 1e-4
# the fused kernel at the NDT node's shape may take no more device time
# than it did with the binary search (PERF.md section 6, row B10-fused)
NDT_NODE_DEVICE_MS = 0.0125
# the benchmark's NDT shape (mclbench's ndt_fleet.track): robots, particles
# a robot, the arena scans they are spread over; the filters held against
# the plain version, and those whose probe hits are counted
NDT_BENCH_ROBOTS, NDT_BENCH_PARTICLES, NDT_BENCH_SCANS = 4096, 4096, 64
NDT_BENCH_CHECKED, NDT_BENCH_HITS = 8, 64
# the fused kernel's launches that found their rows by the map's cell index
NDT_INDEXED = "B10-fused by the cell index"


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean time per call of ``fn`` over ``iters`` calls back to back
    (CUDA events), after a warm-up.  It includes the host's cost of issuing
    each call wherever that exceeds the device's time for it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel")


def device_ms(fn, iters: int) -> float | None:
    """Mean device time per call of ``fn``: the summed durations of the
    kernels and copies it ran under ``torch.profiler``, which leaves the
    host's cost out.  None when the profiler saw no device work, or fewer
    kernels on the card than the host launched: it at times records only
    part of a run's launches (late in this script), and a total over part
    of them reads low, even below the bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    launched = sum(e.name in LAUNCH_CALLS for e in events)
    kernels_seen = sum(not e.name.startswith(("Memcpy", "Memset")) for e in device)
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    return 1e-3 * busy_us / iters if busy_us > 0 and kernels_seen >= launched else None


def queued_device_ms(fn, calls: int, spin_cycles: int = 50_000_000, each: bool = False):
    """Device time per call of ``fn`` without the profiler: ``calls``
    calls queued behind a spin kernel of ``spin_cycles`` clocks (~25 ms),
    so that the card runs them back to back whatever the host's cost of
    issuing them, between two CUDA events.  None when the spin ended
    before the host had queued them.  For calls of a millisecond or more,
    whose gaps on the device are a negligible share.

    With ``each``, every call is queued alone behind a spin of
    ``spin_cycles // 25`` clocks (~1 ms) between two events of its own, for
    calls of microseconds and to see one call's spread: ``{"min",
    "median", "max", "calls"}`` ms over the calls queued in time, None
    when none was."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if each:
        times = []
        for _ in range(calls):
            torch.cuda._sleep(spin_cycles // 25)
            start.record()
            fn()
            end.record()
            queued = not start.query()
            end.synchronize()
            if queued:
                times.append(start.elapsed_time(end))
        times.sort()
        return dict(min=times[0], median=times[len(times) // 2], max=times[-1],
                    calls=len(times)) if times else None
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    queued = not start.query()  # the card is still in the spin
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls if queued else None


def timings(kernel, plain, iters: int, library=None, plain_iters: int | None = None) -> dict:
    """``ms``, ``plain_ms`` and ``library_ms`` (``cuda_ms``) and their
    ``device_ms`` counterparts for a kernel's wrapper, its plain version
    and the library call (None where there is none); ``plain_iters``
    bounds the calls of a slow plain version."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        n = plain_iters if key == "plain_ms" and plain_iters else iters
        out[key] = None if fn is None else cuda_ms(fn, n)
        out[key.replace("ms", "device_ms")] = None if fn is None else device_ms(fn, min(n, 20))
    return out


def launch_device_ms(times: dict, fn, kernel: str, calls: int = 20) -> None:
    """The device time of a wrapper that launches the one kernel ``kernel``
    (its ``__global__`` name) in ``times`` (from ``timings``): the median of
    the durations of its launches that ``torch.profiler`` recorded, and how
    many of ``calls`` it recorded.  Late in this script the profiler records
    only part of a run's launches, so a total over the calls reads low (B6's
    states entry below its bound); a call queued alone behind a spin adds
    ~4 µs of events and launch to a kernel of a few µs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sorted(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and kernel in e.name)
    times["device_ms"] = 1e-3 * us[len(us) // 2] if us else None
    times["device_launches_seen"] = f"{len(us)} of {calls}"


def call_launches(fn, calls: int = 5) -> dict:
    """Kernel launches and memory copies a call of ``fn`` issues: the CUDA
    runtime's launch and ``cudaMemcpy*`` calls that ``torch.profiler`` sees
    on the host (which does not depend on its tracing of the card); a copy
    of a pageable host value syncs the stream."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    return dict(launches=sum(n in LAUNCH_CALLS for n in names) / calls,
                copies=sum(n.startswith("cudaMemcpy") for n in names) / calls)


def model_timings(fn, iters: int) -> dict:
    """``model_ms`` (back to back), ``model_device_ms`` and the launches and
    memory copies a call of the model-level function ``fn`` that a kernel
    entry serves."""
    counts = call_launches(fn)
    return dict(model_ms=cuda_ms(fn, iters), model_device_ms=device_ms(fn, min(iters, 20)),
                model_launches=counts["launches"], model_copies=counts["copies"])


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def yaw_error(a: float, b: float) -> float:
    return abs(math.atan2(math.sin(a - b), math.cos(a - b)))


# -- phase 3: kernels against their plain versions ---------------------------


def workload(n: int, dev, batch: int | None = None):
    """Field code table, particles and one scan of the tracking workload:
    per filter, 90% of the particles in a cloud about the first pose, 10%
    spread over a box larger than the map (some endpoints fall off the
    map).  One filter ``[n]``, or ``batch`` filters ``[batch, n]`` that
    score the same scan, as the fleet does."""
    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.tools.workloads import GRID, RES, arena_scans

    data, xs, ys, yaws, pts, mask = arena_scans(1)
    _, ctx = make_likelihood_field_filter(
        make_grid(data, RES, device=dev),
        AmclNodeConfig().likelihood_field_params(), device=dev,
    )
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(n * (batch or 1))
    near = int(n * 0.9)

    def mix(center, sd, lo, hi):
        return np.concatenate([rng.normal(center, sd, (*lead, near)),
                               rng.uniform(lo, hi, (*lead, n - near))], axis=-1)

    px = mix(xs[0], 0.5, -2, GRID * RES + 2)
    py = mix(ys[0], 0.5, -2, GRID * RES + 2)
    pth = mix(yaws[0], 0.26, -np.pi, np.pi)
    states = SE2.from_xytheta(px.astype(np.float32), py.astype(np.float32),
                              pth.astype(np.float32), device=dev)
    tf = ctx["field"].world_to_field @ states
    points = torch.as_tensor(pts[0]).to(dev)
    beams = torch.as_tensor(mask[0]).to(dev)
    return dict(
        ctx=ctx, lead=lead,
        tf=[t.contiguous() for t in (tf.x, tf.y, tf.rot.cos, tf.rot.sin)],
        states=states,
        points=points.expand(*lead, *points.shape).contiguous(),
        mask=beams.expand(*lead, *beams.shape).contiguous(),
    )


def shape_label(w: dict, n: int) -> str:
    b = w["lead"][0] if w["lead"] else 1
    nb = w["points"].shape[-2]
    return f"{b}x{n}x{nb} ({int(w['mask'][(0,) * len(w['lead'])].sum())} unmasked)"


def single_beam(mask: torch.Tensor) -> torch.Tensor:
    """The mask with only its first unmasked beam left on (every filter
    scores the same scan)."""
    first = int(torch.nonzero(mask.reshape(-1, mask.shape[-1])[0])[0])
    one = torch.zeros_like(mask)
    one[..., first] = True
    return one


def reweight_entries(b1, w: dict, mask, values3=None, log_space: bool = False):
    """The two entries of kernel B1 or B4 (with ``values3``) and their plain
    versions on ``workload``'s inputs with ``mask``: ``(states, states
    plain, transform, transform plain)`` as callables.  The states entry
    (the main paths' call) composes ``world_to_field @ states`` in the
    kernel; the transform entry takes the composed transform."""
    codes, book = w["ctx"]["field_codes"]
    field = w["ctx"]["field"]
    s_args = (codes, book, field.world_to_field, w["states"], w["points"], mask,
              field.resolution, field.unknown_prob)
    t_args = (codes, book, *w["tf"], w["points"], mask, field.resolution, field.unknown_prob)
    kw = dict(values3=values3, log_space=log_space)
    if values3 is None:
        t_plain = lambda: b1.fused_reweight_reference(*t_args, log_space=log_space)  # noqa: E731
    else:
        t_plain = lambda: b1.fused_reweight_values3_reference(  # noqa: E731
            values3, *t_args[2:], log_space=log_space)
    return (lambda: b1.fused_reweight_states(*s_args, **kw),
            lambda: b1.fused_reweight_states_reference(*s_args, **kw),
            lambda: b1.fused_reweight(*t_args, **kw), t_plain)


def check_entries(b1, w: dict, name: str, label: str, values3=None,
                  log_space: bool = False) -> tuple[torch.Tensor, float, dict]:
    """Both entries of one kernel against their plain versions: with one
    unmasked beam bit-equal (every cell exact), the full beam sum within
    rtol 1e-5 (and atol 1e-5 in log space), two launches bit-equal, and the
    two entries bit-equal to each other (the same cells, lanes and sums).
    Returns the states entry's weights, its largest error and the
    transform entry's times."""
    atol = 1e-5 if log_space else 0.0
    for which, mask in (("single beam", single_beam(w["mask"])), ("all beams", w["mask"])):
        s_fn, s_plain, t_fn, t_plain = reweight_entries(b1, w, mask, values3, log_space)
        got, again, via = s_fn(), s_fn(), t_fn()
        want, t_want = s_plain(), t_plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name} {label} {which}: weights not finite")
        check(torch.equal(got, again) and torch.equal(via, t_fn()),
              f"{name} {label} {which}: two launches differ")
        check(torch.equal(got, via), f"{name} {label} {which}: the entries differ")
        if which == "single beam":
            for entry, g, p in (("states", got, want), ("transform", via, t_want)):
                check(torch.equal(g, p),
                      f"{name} {label} single beam, {entry} entry: "
                      f"{int((g != p).sum())} weights differ")
        else:
            for entry, g, p in (("states", got, want), ("transform", via, t_want)):
                check(torch.allclose(g, p, rtol=1e-5, atol=atol),
                      f"{name} {label}, {entry} entry: max err "
                      f"{float((g - p).abs().max()):.3g} > rtol 1e-5")
    iters = w["iters"]
    t_times = timings(t_fn, t_plain, iters)
    tf_entry = {"tf_entry_" + key: value for key, value in t_times.items()
                if not key.startswith("library")}
    return got, float((got - want).abs().max()), tf_entry


def check_reweight(n: int, dev, iters: int, batch: int | None = None,
                   log_space: bool = False) -> tuple[dict, dict]:
    """Kernel B1, or with ``log_space`` B1-log (the probability model's
    ``Σ log pz``), through both entries (``check_entries``); ``ms`` and
    ``device_ms`` are the states entry's, the main paths' call, and
    ``tf_entry_ms`` the transform entry's."""
    from beluga_tpu_torch.ops import cuda_reweight as b1

    w = workload(n, dev, batch)
    w["iters"] = iters
    codes, book = w["ctx"]["field_codes"]
    name = "B1-log" if log_space else "B1"
    label = shape_label(w, n)
    got, err, tf_entry = check_entries(b1, w, name, label, log_space=log_space)
    w["log_weights" if log_space else "b1_weights"] = got
    s_fn, s_plain, _, _ = reweight_entries(b1, w, w["mask"], log_space=log_space)
    times = timings(s_fn, s_plain, iters)
    h, wd = codes.shape
    total, filters = w["states"].x.numel(), batch or 1
    nb = w["points"].shape[-2]
    unmasked = int(w["mask"].sum())  # over every filter
    nbytes = h * wd + 4 * book.numel() + 16 * total + 16 + 9 * nb * filters + 4 * total
    ops = B1_LOG_OPS_PER_BEAM if log_space else B1_OPS_PER_BEAM
    bms, by = bound_ms(nbytes, ops * n * unmasked + SE2_COMPOSE_OPS * total)
    replaces = "beluga_tpu/ops/pallas_reweight.py:390" + (" (log_space=True)" if log_space else "")
    return dict(
        name=f"{name} fused_reweight", route="cuda", source="beluga_tpu_torch/csrc/reweight.cu",
        replaces=replaces, max_abs_err=err, bound_ms=bms, bound_by=by, shape=label, **times,
        **tf_entry,
    ), w


def check_codebook16(n: int, w: dict, iters: int, log_space: bool = False) -> dict:
    """Kernel B4 on ``check_reweight``'s inputs, through both entries
    (``check_entries``), and within 5e-3 of B1's exact weights.  With
    ``log_space``, B4-log on its ``bf16(log pz)`` table against B1-log:
    within 2^-7 of the log-weight's magnitude (bf16 keeps 8 significant
    bits)."""
    from beluga_tpu_torch.ops import cuda_reweight as b1

    codes, book = w["ctx"]["field_codes"]
    v3 = b1.build_values3(codes, book, log_space=log_space)
    name = "B4-log" if log_space else "B4"
    label = shape_label(w, n)
    w["iters"] = iters
    got, err, tf_entry = check_entries(b1, w, name, label, values3=v3, log_space=log_space)
    exact = w["log_weights" if log_space else "b1_weights"]
    rel_b1 = float(((got - exact).abs() / exact.abs()).max())
    limit = 2.0**-7 if log_space else 5e-3
    check(rel_b1 < limit, f"{name} {label}: {rel_b1:.3g} relative to the exact weights")
    s_fn, s_plain, _, _ = reweight_entries(b1, w, w["mask"], v3, log_space)
    times = timings(s_fn, s_plain, iters)
    h, wd = codes.shape
    total, filters = w["states"].x.numel(), (w["lead"][0] if w["lead"] else 1)
    nb = w["points"].shape[-2]
    nbytes = 2 * h * wd + 16 * total + 16 + 9 * nb * filters + 4 * total
    bms, by = bound_ms(nbytes, B4_OPS_PER_BEAM * n * int(w["mask"].sum())
                       + SE2_COMPOSE_OPS * total)
    replaces = "beluga_tpu/ops/pallas_reweight.py:390 (values3=, build_values3:364" + (
        ", log_space=True)" if log_space else ")")
    return dict(
        name=f"{name} fused_reweight values3", route="cuda",
        source="beluga_tpu_torch/csrc/reweight.cu", replaces=replaces,
        max_abs_err=err, rel_to_b1=rel_b1, bound_ms=bms, bound_by=by, shape=label, **times,
        **tf_entry,
    )


def old_monotone_cdf(weights: torch.Tensor) -> torch.Tensor:
    """The port's CDF before the CDF kernel: ``torch.cumsum``, a division by
    the last entry and ``torch.cummax`` (as pallas_resample.py:405-412).
    Timed here beside the kernel; the port no longer runs it."""
    c = torch.cumsum(weights, dim=-1)
    return torch.cummax(c / torch.clamp_min(c[..., -1:], 1e-38), dim=-1).values


def check_cdf(weights: torch.Tensor, label: str) -> tuple[torch.Tensor, float, float]:
    """The CDF kernel on ``weights``: monotone, each zero-weight slot's entry
    equal to the one before it (0 before the first live slot), the last
    live slot's entry exactly 1, all checked exactly; every entry within
    CDF_ULP of the float64 prefix sum over its total.  Returns the CDF, its
    largest distance from float64 and from the plain version's CDF."""
    from beluga_tpu_torch.ops import cuda_resample as b2

    cdf = b2.monotone_cdf(weights)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(cdf).all()), f"B2 CDF {label}: not finite")
    check(bool((cdf[..., 1:] >= cdf[..., :-1]).all()), f"B2 CDF {label}: not monotone")
    prev = torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1]], dim=-1)
    dead = weights == 0
    check(bool(dead.any()) and torch.equal(cdf[dead], prev[dead]),
          f"B2 CDF {label}: {int((cdf[dead] != prev[dead]).sum())} zero-weight intervals "
          f"not empty")
    n = weights.shape[-1]
    last = n - 1 - torch.argmax(torch.flip(weights > 0, [-1]).to(torch.int8), dim=-1)
    at_last = torch.take_along_dim(cdf, last[..., None], dim=-1)[..., 0]
    check(bool((at_last[(weights > 0).any(-1)] == 1.0).all()),
          f"B2 CDF {label}: the last live slot's entry is not 1")
    exact = torch.cumsum(weights.double(), dim=-1)
    exact = exact / torch.clamp_min(exact[..., -1:], 1e-38)
    err64 = float((cdf.double() - exact).abs().max())
    check(err64 <= CDF_ULP, f"B2 CDF {label}: {err64:.3g} from float64 > {CDF_ULP:.3g}")
    err_plain = float((cdf - b2.monotone_cdf_reference(weights)).abs().max())
    return cdf, err64, err_plain


def launches_per_call(fn, what: str, want: int = 1) -> float:
    """Checks that a call of ``fn`` launches exactly ``want`` kernels (the
    launch calls the profiler sees on the host); returns the count."""
    launches = call_launches(fn)["launches"]
    check(launches == want, f"{what}: {launches} kernel launches a call, not {want}")
    return launches


def check_resample(n: int, w: dict, dev, iters: int) -> tuple[dict, dict]:
    """Kernel B2, the whole function from the weights (up to a tile a
    filter the one-tile entry, past it the CDF kernel then the search, one
    launch each): its CDF (held by ``check_cdf``), donors bit-equal to
    ``search_take`` and to its plain version on the kernel's own CDF, no
    zero-weight donor, padding at 1.5 selecting nothing, and rows apart
    from the plain whole function only where a position lies between the
    two CDFs' values of one entry.  Timed as a whole, beside the CDF build
    and the search alone (device) and the old path (``torch.cumsum`` +
    ``torch.cummax``, then the search); the CDF kernel beside
    ``torch.cumsum``.  Returns B2's entry at this N (the one-tile entry's
    or the search's) and the CDF kernel's."""
    from beluga_tpu_torch.ops import cuda_resample as b2
    from beluga_tpu_torch.ops.resample import sorted_multinomial_positions, systematic_positions

    lead = w["lead"]
    weights = w["b1_weights"].clone()
    block = (0,) * len(lead)  # one filter holds a block of zero-weight slots
    weights[block][n // 4 : n // 4 + n // 16] = 0.0
    st = w["states"]
    values = torch.stack([st.x, st.y, st.rot.cos, st.rot.sin], dim=-2).contiguous()  # D = 4
    label = f"{lead} N={n}"
    cdf, cdf_err64, cdf_err_plain = check_cdf(weights, label)
    check(torch.equal(cdf, b2.monotone_cdf(weights)), f"B2 CDF {label}: two calls differ")
    plain_cdf = b2.monotone_cdf_reference(weights)
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    pad = max(n // 32, 1)
    results, moved_rows = [], 0
    for kind, pos in (("sorted multinomial", sorted_multinomial_positions(gen, n, lead)),
                      ("systematic", systematic_positions(gen, n, lead))):
        pos = pos.clone()
        pos[..., -pad:] = 1.5  # padding selects nothing
        got = b2.resample_take(weights, pos, values)
        want = b2.search_take_reference(cdf, pos, values)
        torch.cuda.synchronize()
        check(torch.equal(got, b2.search_take(cdf, pos, values)),
              f"B2 {kind} {label}: the whole function differs from search_take on its CDF")
        check(torch.equal(got, want),
              f"B2 {kind} {label} M={n}: {int((got != want).any(-1).sum())} rows differ")
        idx = torch.searchsorted(cdf, pos, right=True)
        found = idx < n
        chosen = torch.take_along_dim(weights, torch.clamp_max(idx, n - 1), dim=-1)
        check(bool((chosen[found] > 0).all()), "B2 chose a zero-weight slot")
        check(not bool(found[..., -pad:].any()) and bool((got[..., -pad:, :] == 0).all()),
              "B2 padded positions selected a donor")
        # plain_cdf once: torch.cumsum's multi-block scan on the card need not
        # associate alike from one call to the next
        moved = torch.searchsorted(plain_cdf, pos, right=True) != idx
        differs = (got != b2.search_take_reference(plain_cdf, pos, values)).any(-1)
        check(torch.equal(differs, moved),
              f"B2 {kind} {label}: rows differ from the plain version where the CDFs agree")
        moved_rows += int(moved.sum())
        results.append((pos, got, want))
    pos = results[0][0]  # time the main path's positions (sorted multinomial)
    err = max(float((g - x).abs().max()) for _, g, x in results)
    name = b2_entry(n)  # one launch up to a tile a filter, else the CDF's and the search's
    whole_calls = launches_per_call(lambda: b2.resample_take(weights, pos, values),
                                    f"{name} {label}", 1 if name == B2_TILE else 2)
    cdf_calls = launches_per_call(lambda: b2.monotone_cdf(weights), f"{B2_CDF} {label}")
    times = timings(lambda: b2.resample_take(weights, pos, values),
                    lambda: b2.resample_take_reference(weights, pos, values), iters)
    cdf_times = timings(lambda: b2.monotone_cdf(weights),
                        lambda: b2.monotone_cdf_reference(weights), iters,
                        library=lambda: torch.cumsum(weights, dim=-1))
    calls = min(iters, 20)
    filters = lead[0] if lead else 1
    d, m = values.shape[-2], pos.shape[-1]
    nbytes = filters * (4 * n + 4 * m + 4 * d * n + 4 * m * d)
    bms, by = bound_ms(nbytes, filters * (3 * n + m * math.ceil(math.log2(n + 1))))
    cbms, cby = bound_ms(filters * 8 * n, filters * 3 * n)
    shape = f"{filters}x N=M={n} D={d}"
    whole = dict(
        name=name, route="cuda", source="beluga_tpu_torch/csrc/resample.cu",
        replaces="beluga_tpu/ops/pallas_resample.py:369", max_abs_err=err,
        bound_ms=bms, bound_by=by, **times, shape=shape, launches_per_call=whole_calls,
        cdf_device_ms=cdf_times["device_ms"],
        search_device_ms=device_ms(lambda: b2.search_take(cdf, pos, values), calls),
        old_path_ms=cuda_ms(lambda: b2.search_take(old_monotone_cdf(weights), pos, values),
                            iters),
        old_path_device_ms=device_ms(
            lambda: b2.search_take(old_monotone_cdf(weights), pos, values), calls),
        old_cdf_device_ms=device_ms(lambda: old_monotone_cdf(weights), calls),
        rows_moved_from_plain=moved_rows,
    )
    cdf_entry = dict(
        name="B2-cdf monotone_cdf", route="cuda", source="beluga_tpu_torch/csrc/resample.cu",
        replaces="beluga_tpu/ops/pallas_resample.py:405 (resample_take's CDF, before the "
                 "pallas_call at :495)",
        max_abs_err=cdf_err_plain, max_abs_err_float64=cdf_err64, bound_ms=cbms, bound_by=cby,
        **cdf_times, shape=f"{filters}x N={n}", launches_per_call=cdf_calls,
        library_note="torch.cumsum: the running sum alone, without the live maximum and the "
                     "division",
    )
    return whole, cdf_entry


def check_running_sum(lead: tuple, n: int, dev, iters: int) -> dict:
    """B2's CDF kernel without its division (``running_sum``) on the
    spacings of ``n`` uniforms a filter, the sorted positions' running sum:
    two calls bit-equal, monotone, each zero spacing's entry equal to the
    one before it, the last entry the largest, every entry within CDF_ULP
    of the total from a float64 prefix sum, the CDF kernel's entries its
    own division by its last entry (what the sharded CDF divides), one
    launch a call; timed beside its plain version (``torch.cumsum``, then
    ``torch.cummax`` over live slots) and ``torch.cumsum`` alone, the
    library call."""
    from beluga_tpu_torch.ops import cuda_resample as b2

    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    u = torch.rand((*lead, n), generator=gen, device=dev)
    u[..., n // 2] = 0.0  # a zero spacing
    e = -torch.log1p(-u)
    label = f"{lead} N={n}"
    got = b2.running_sum(e)
    torch.cuda.synchronize()
    check(torch.equal(got, b2.running_sum(e)), f"{RUNNING_SUM} {label}: two calls differ")
    check(bool((got[..., 1:] >= got[..., :-1]).all()), f"{RUNNING_SUM} {label}: not monotone")
    check(torch.equal(got[..., n // 2], got[..., n // 2 - 1]),
          f"{RUNNING_SUM} {label}: a zero spacing moved the sum")
    exact = torch.cumsum(e.double(), dim=-1)
    total = exact[..., -1:]
    err64 = float(((got.double() - exact) / total).abs().max())
    check(err64 <= CDF_ULP, f"{RUNNING_SUM} {label}: {err64:.3g} of the total from float64")
    check(torch.equal(b2.monotone_cdf(e), got / torch.clamp_min(got[..., -1:], 1e-38)),
          f"{RUNNING_SUM} {label}: the CDF is not the running sum over its total")
    calls = launches_per_call(lambda: b2.running_sum(e), f"{RUNNING_SUM} {label}")
    plain = b2.running_sum_reference(e)  # once: torch.cumsum differs run to run on the card
    times = timings(lambda: b2.running_sum(e), lambda: b2.running_sum_reference(e), iters,
                    library=lambda: torch.cumsum(e, dim=-1))
    filters = math.prod(lead)
    bms, by = bound_ms(filters * 8 * n, filters * n)
    return dict(
        name=RUNNING_SUM, route="cuda", source="beluga_tpu_torch/csrc/resample.cu",
        replaces="beluga_tpu/ops/resample.py:100 (sorted_multinomial_positions' cumsum, "
                 "XLA; no Pallas)",
        max_abs_err=float((got - plain).abs().max()),
        max_rel_err=float(((got - plain) / plain[..., -1:]).abs().max()),
        max_abs_err_float64=err64, bound_ms=bms, bound_by=by, **times,
        shape=f"{filters}x N={n}", launches_per_call=calls)


def check_pool_take(batch: int | None, p: int, n: int, dev, iters: int) -> dict:
    """Kernel B3 on a pool of ``p`` (x, y) rows: bit-equal to its plain
    version with some indices out of range, timed on in-range indices (the
    sampler's)."""
    from beluga_tpu_torch.ops import cuda_pool_take as b3

    lead = () if batch is None else (batch,)
    gen = torch.Generator(device=dev)
    gen.manual_seed(p + n)
    pool = torch.randn((*lead, p, 2), generator=gen, device=dev)
    wild = torch.randint(-8, p + 8, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
    got, want = b3.pool_take(pool, wild), b3.pool_take_reference(pool, wild)
    torch.cuda.synchronize()
    label = f"[{', '.join(map(str, (*lead, p, 2)))}] x {n}"
    check(torch.equal(got, want), f"B3 {label}: {int((got != want).any(-1).sum())} rows differ")
    outside = (wild < 0) | (wild >= p)
    check(bool(outside.any()) and bool((got[outside] == 0).all()),
          "B3 out-of-range indices did not give zero rows")
    idx = torch.randint(0, p, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
    gather_idx = idx.long()[..., None].expand(*idx.shape, 2).contiguous()
    times = timings(lambda: b3.pool_take(pool, idx), lambda: b3.pool_take_reference(pool, idx),
                    iters, library=lambda: torch.gather(pool, -2, gather_idx))
    filters, c = (batch or 1), 2
    bms, by = bound_ms(filters * (n * (4 + 4 * c) + p * c * 4), 0)
    return dict(
        name="B3 pool_take", route="cuda", source="beluga_tpu_torch/csrc/pool_take.cu",
        replaces="beluga_tpu/ops/pallas_lookup.py:153", max_abs_err=float((got - want).abs().max()),
        bound_ms=bms, bound_by=by, shape=label, **times,
    )


def resample_inputs(n: int, dev) -> dict:
    """Inputs of ``check_resample`` without a reweight: positive random
    weights and a random cloud of ``n`` particles."""
    from beluga_tpu_torch.lie import SE2

    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    xyt = torch.randn((3, n), generator=gen, device=dev)
    weights = torch.rand(n, generator=gen, device=dev) + 0.5
    return dict(lead=(), b1_weights=weights, states=SE2.from_xytheta(xyt[0], xyt[1], xyt[2]))


def window_inputs(w, cfg: dict, stray_every: int = 20, table_dtype: str = "bf16"):
    """The workload's θ-sorted cloud with every ``stray_every``-th slot moved
    5 m off (it scores miss), and the window LUT of its first scan about the
    cloud's mean, built as the filter builds it."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import build_windowed_scan_lut

    st = w.state.particles.state
    xy = st.xy.clone()
    xy[::stray_every] += 5.0
    states = SE2(xy, st.rot)
    ct = torch.atan2(torch.mean(st.rot.sin), torch.mean(st.rot.cos))
    geo = {k: v for k, v in cfg.items() if k in ("k_bins", "win", "dth", "max_point_radius")}
    lut = build_windowed_scan_lut(w.ctx["field"], w.points[0], w.mask[0], torch.mean(st.x),
                                  torch.mean(st.y), ct, table_dtype=table_dtype,
                                  padded_cubed=w.ctx["field_pad3"], dft=w.ctx["winlut_dft"],
                                  **geo)
    return states, lut


def check_winlut(dev, iters: int) -> dict:
    """Kernel B6 at the windowed filter's geometry (262144 particles, 64
    bins, a 128x128 window, tile 512, tblk 16; a θ-sorted cloud whose tiles
    span several slabs): within rtol 1e-6 of its plain version with an
    equal miss set, timed beside its plain version and ``grid_sample``
    (trilinear, ``align_corners=True``, the same coordinates, no slab rule),
    the library yardstick the port never calls."""
    import torch.nn.functional as F

    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import windowed_coords
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.WINDOWED_FILTER
    states, lut = window_inputs(workloads.windowed(1, dev), cfg)
    tile, tblk = cfg["tile"], cfg["tblk"]
    xi, yi, t = (v.contiguous() for v in windowed_coords(lut, states))
    k, wx, wy = lut.values_t.shape
    got = b6.winlut_lookup(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk)
    want = b6.winlut_lookup_reference(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk)
    torch.cuda.synchronize()
    n = xi.numel()
    label = f"{n} particles, [{k}, {wx}, {wy}] bf16, tile {tile}, tblk {tblk}"
    miss_got, miss_want = got == lut.miss, want == lut.miss
    check(torch.equal(miss_got, miss_want),
          f"B6 {label}: {int((miss_got != miss_want).sum())} particles differ in the miss set")
    check(bool(torch.isfinite(got).all()), "B6 weights not finite")
    check(torch.allclose(got, want, rtol=1e-6, atol=0),
          f"B6 {label}: max rel err {float(((got - want).abs() / want).max()):.3g} > 1e-6")
    t_lo = b6.slab_bases(F.pad(t, (0, -n % tile), value=-1.0), k, min(tblk, k), tile)
    slabs = int(torch.unique(t_lo).numel())
    check(slabs > 1, f"B6 {label}: the cloud's tiles share one slab")
    check(0 < int(miss_got.sum()) < n // 10, f"B6 {label}: {int(miss_got.sum())} misses")
    vol = lut.values_t.float()[None, None].contiguous()  # [1, 1, K, Wx, Wy]
    grid = torch.stack([2 * yi / (wy - 1) - 1, 2 * xi / (wx - 1) - 1, 2 * t / (k - 1) - 1],
                       -1)[None, None, None].contiguous()  # (W, H, D) = (y, x, θ)

    def library():
        return F.grid_sample(vol, grid, mode="bilinear", align_corners=True)

    lib = 1.0 + library().reshape(-1)
    hit = ~miss_got
    lib_rel = float(((lib[hit] - got[hit]).abs() / got[hit]).max())
    check(lib_rel < 1e-3, f"B6 {label}: grid_sample differs by {lib_rel:.3g} where B6 scores")
    times = timings(lambda: b6.winlut_lookup(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk),
                    lambda: b6.winlut_lookup_reference(lut.values_t, xi, yi, t, lut.miss, 1.0,
                                                       tile, tblk),
                    iters, library=library)
    bms, by = bound_ms(16 * n + 2 * lut.values_t.numel(), B6_OPS_PER_PARTICLE * int(hit.sum()))
    return dict(
        name="B6 winlut_lookup", route="cuda", source="beluga_tpu_torch/csrc/winlut.cu",
        replaces="beluga_tpu/ops/pallas_winlut.py:157", max_abs_err=float((got - want).abs().max()),
        bound_ms=bms, bound_by=by, shape=label, slabs=slabs, misses=int(miss_got.sum()),
        grid_sample_max_rel=lib_rel, **times,
    )


def check_winlut_int8(dev, iters: int) -> dict:
    """Kernel B6-int8 at the windowed filter's geometry on an int8 window
    table (the same cloud and scan as ``check_winlut``): bit-equal to its
    plain version, timed beside it (``grid_sample`` on the dequantized
    table as the yardstick)."""
    import torch.nn.functional as F

    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import windowed_coords
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.WINDOWED_FILTER
    states, lut = window_inputs(workloads.windowed(1, dev, table_dtype="int8"), cfg,
                                table_dtype="int8")
    tile, tblk = cfg["tile"], cfg["tblk"]
    xi, yi, t = (v.contiguous() for v in windowed_coords(lut, states))
    k, wx, wy = lut.values_t.shape
    args = (lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk)
    got = b6.winlut_lookup(*args, scale=lut.scale)
    want = b6.winlut_lookup_reference(*args, scale=lut.scale)
    torch.cuda.synchronize()
    n = xi.numel()
    label = f"{n} particles, [{k}, {wx}, {wy}] int8, tile {tile}, tblk {tblk}"
    check(lut.values_t.dtype == torch.int8, "B6-int8: the table is not int8")
    check(bool(torch.isfinite(got).all()), "B6-int8 weights not finite")
    check(torch.equal(got, want),
          f"B6-int8 {label}: {int((got != want).sum())} weights differ from the plain version")
    miss = got == lut.miss
    check(0 < int(miss.sum()) < n // 10, f"B6-int8 {label}: {int(miss.sum())} misses")
    vol = (lut.values_t.float() * lut.scale)[None, None].contiguous()
    grid = torch.stack([2 * yi / (wy - 1) - 1, 2 * xi / (wx - 1) - 1, 2 * t / (k - 1) - 1],
                       -1)[None, None, None].contiguous()

    def library():
        return F.grid_sample(vol, grid, mode="bilinear", align_corners=True)

    times = timings(lambda: b6.winlut_lookup(*args, scale=lut.scale),
                    lambda: b6.winlut_lookup_reference(*args, scale=lut.scale), iters,
                    library=library)
    hit = ~miss
    bms, by = bound_ms(16 * n + lut.values_t.numel(), B6_OPS_PER_PARTICLE * int(hit.sum()))
    return dict(
        name="B6-int8 winlut_lookup", route="cuda", source="beluga_tpu_torch/csrc/winlut.cu",
        replaces="beluga_tpu/ops/pallas_winlut.py:157 (int8 table, :109-142)",
        max_abs_err=float((got - want).abs().max()), bound_ms=bms, bound_by=by, shape=label,
        misses=int(miss.sum()), **times,
    )


def check_pool_draw(batch: int | None, p: int, n: int, dev, iters: int) -> dict:
    """Kernel B3's draw entry (the pooled recovery sampler's whole draw) on
    the arena's free cells, ``batch`` pools of ``p`` candidates and ``n``
    slots: translations and headings bit-equal to its plain version
    (``free_xy[cand]``, the row take, ``SO2.exp``) with some indices out of
    range (zero rows), timed on the sampler's in-range draws beside the plain
    version and ``torch.gather`` of the pooled rows (the translations only:
    no one PyTorch call computes the whole draw)."""
    from beluga_tpu_torch.core.random import uniform_free_cells_pooled_from_draws
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.ops import cuda_pool_take as b3
    from beluga_tpu_torch.tools import workloads

    grid = make_grid(workloads.arena_scans(1).data, workloads.RES, device=dev)
    free, rows = grid.free_xy, int(grid.num_free)
    lead = () if batch is None else (batch,)
    gen = torch.Generator(device=dev)
    gen.manual_seed(p + n + 1)
    cand = torch.randint(0, rows, (*lead, p), generator=gen, device=dev)
    theta = torch.rand((*lead, n), generator=gen, device=dev) * (2.0 * math.pi) - math.pi
    wild = torch.randint(-8, p + 8, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
    got = b3.pooled_free_cells(free, cand, wild, theta)
    want = b3.pooled_free_cells_reference(free, cand, wild, theta)
    torch.cuda.synchronize()
    label = f"[{', '.join(map(str, (*lead, p)))}] cells x {n} draws, {rows} free cells"
    check(torch.equal(got.xy, want.xy),
          f"B3 draw {label}: {int((got.xy != want.xy).any(-1).sum())} translations differ")
    outside = (wild < 0) | (wild >= p)
    check(bool(outside.any()) and not bool(got.xy[outside].any()),
          "B3 draw: out-of-range indices did not give zero rows")
    rot_err = float((got.rot.z - want.rot.z).abs().max())
    check(torch.equal(got.rot.z, want.rot.z),
          f"B3 draw {label}: cos and sin differ from torch.cos and torch.sin by {rot_err:.3g}")
    idx = torch.randint(0, p, (*lead, n), generator=gen, device=dev, dtype=torch.int32)
    pool = free[cand]
    gather_idx = idx.long()[..., None].expand(*idx.shape, 2).contiguous()
    times = timings(lambda: b3.pooled_free_cells(free, cand, idx, theta),
                    lambda: b3.pooled_free_cells_reference(free, cand, idx, theta), iters,
                    library=lambda: torch.gather(pool, -2, gather_idx))
    launch_device_ms(times, lambda: b3.pooled_free_cells(free, cand, idx, theta),
                     "pool_take_kernel<true>")
    times.update(model_timings(lambda: uniform_free_cells_pooled_from_draws(cand, idx, theta,
                                                                            free), iters))
    bms, by = bound_ms((batch or 1) * (24 * n + 16 * p), 0)
    return dict(
        name="B3-draw pooled_free_cells", route="cuda", source="beluga_tpu_torch/csrc/pool_take.cu",
        replaces="beluga_tpu/ops/pallas_lookup.py:153 (with beluga_tpu/core/random.py:97-134)",
        max_abs_err=max(float((got.xy - want.xy).abs().max()), rot_err), bound_ms=bms,
        bound_by=by, shape=label, library_note="torch.gather of the pooled rows, no headings",
        **times,
    )


def check_estimate(lead: tuple, n: int, dev, iters: int) -> dict:
    """Kernel E1 from log-weights and live counts at ``lead`` filters of
    ``n`` particles (ragged live prefixes; with filters, the first has no
    live slot): two calls bit-equal, one launch a call, and within a stated
    bound of its plain version, timed beside the plain version as the main
    paths ran it before the kernel (the weights, the mask, the moments)."""
    from beluga_tpu_torch.algorithms.estimation import estimate_se2_log, estimate_se2_reference
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.ops import cuda_estimate

    gen = torch.Generator(device=dev)
    gen.manual_seed(n + len(lead))
    b = math.prod(lead)
    centre = torch.rand((b, 1, 2), generator=gen, device=dev) * 20.0
    xy = centre + torch.randn((b, n, 2), generator=gen, device=dev)
    theta = torch.randn((b, n), generator=gen, device=dev) * 0.3 + 1.0
    log_w = torch.randn((b, n), generator=gen, device=dev)
    active = torch.randint(n // 2, n + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    active[-1] = n
    if b > 1:
        active[0] = 0
    states = SE2.from_xytheta(xy[..., 0].reshape(*lead, n), xy[..., 1].reshape(*lead, n),
                              theta.reshape(*lead, n))
    log_w, active = log_w.reshape(*lead, n), active.reshape(lead)

    def plain():
        mask = torch.arange(n, device=dev) < active[..., None]
        return estimate_se2_reference(states, torch.where(mask, torch.exp(log_w), 0.0), mask)

    before = cuda_estimate.launches
    got, again, want = estimate_se2_log(states, log_w, active), estimate_se2_log(states, log_w,
                                                                                 active), plain()
    torch.cuda.synchronize()
    label = f"[{', '.join(map(str, (*lead, n)))}]"
    check(cuda_estimate.launches == before + 2, f"E1 {label}: not one launch a call")
    check(all(torch.equal(x, y) for x, y in ((got[0].xy, again[0].xy),
                                             (got[0].rot.z, again[0].rot.z), (got[1], again[1]))),
          f"E1 {label}: two calls differ")
    # the plain version's own float32 error on these inputs is ~1e-7 of each
    # part's scale (tests/test_torch_estimate.py); 1e-5 leaves room for both
    gaps = dict(xy=(got[0].xy - want[0].xy).abs().max() / want[0].xy.abs().max(),
                rot=(got[0].rot.z - want[0].rot.z).abs().max(),
                cov_t=(got[1][..., :2, :2] - want[1][..., :2, :2]).abs().max()
                / want[1][..., :2, :2].abs().max())
    yaw, yaw_want = got[1][..., 2, 2], want[1][..., 2, 2]
    finite = torch.isfinite(yaw_want)
    check(torch.equal(finite, torch.isfinite(yaw)), f"E1 {label}: degenerate yaw differs")
    gaps["yaw_var"] = (yaw - yaw_want)[finite].abs().max() / yaw_want[finite].abs().max()
    gaps = {k: float(v) for k, v in gaps.items()}
    check(max(gaps.values()) <= 1e-5, f"E1 {label}: relative gaps {gaps} from the plain version")
    times = timings(lambda: estimate_se2_log(states, log_w, active), plain, iters)
    launch_device_ms(times, lambda: estimate_se2_log(states, log_w, active), "estimate_kernel")
    bms, by = bound_ms(b * (ESTIMATE_BYTES_PER_PARTICLE * n + ESTIMATE_BYTES_PER_FILTER), 0)
    return dict(
        name=ESTIMATE, route="cuda", source="beluga_tpu_torch/csrc/estimate.cu",
        replaces="beluga_tpu/algorithms/estimation.py:estimate_se2 (XLA's reductions, no Pallas)",
        max_abs_err=float((got[0].xy - want[0].xy).abs().max()), max_rel_err=gaps,
        bound_ms=bms, bound_by=by, shape=label, **times,
    )


def check_sort(lead: tuple, n: int, dev, iters: int, cut: bool = False) -> dict:
    """Kernel S1 at ``lead`` filters of ``n`` slots (normal clouds with
    strays in x, y and heading, runs of equal headings, ragged live
    prefixes; with ``cut``, in rows of n + 1 cut to n, as the pooled
    injection's ``tree_scatter`` leaves the states, the log-weights so too):
    its output bit-equal to the plain version's on every filter with no
    live slot SORT_Z_EDGE from 3.5 by the float64 z-scores, and to
    ``tree_sort_by`` of its own keys on all; ``inf`` keys exactly on the
    dead slots, which stay last in their order; its headings within
    SORT_THETA_ATOL of the plain key's, its stray flags the float64
    z-scores' wherever those lie SORT_Z_EDGE from 3.5; two calls bit-equal,
    one launch a call; timed beside the plain version (the key, the mask's
    ``inf``, ``tree_sort_by``)."""
    from beluga_tpu_torch.core.particles import ParticleSet, tree_scatter, tree_sort_by
    from beluga_tpu_torch.filters.amcl import AmclModels, se2_sort_key, sort_slots
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.ops import cuda_sort

    gen = torch.Generator(device=dev)
    gen.manual_seed(n + len(lead))
    b = math.prod(lead)
    centre = torch.rand((b, 1, 3), generator=gen, device=dev) * 40.0 - 20.0
    xyt = centre + torch.randn((b, n, 3), generator=gen, device=dev) * 0.35
    xyt[:, :6, 0] += 4.0  # strays in x, y and heading
    xyt[:, 6:9, 1] -= 3.0
    xyt[:, 9:12, 2] += math.pi
    xyt[:, 20:28, 2] = xyt[:, 20:21, 2]  # equal headings
    z = torch.stack([torch.cos(xyt[..., 2]), torch.sin(xyt[..., 2])], -1)
    states = SE2(xyt[..., :2].contiguous().reshape(*lead, n, 2), SO2(z.reshape(*lead, n, 2)))
    log_w = torch.randn((b, n), generator=gen, device=dev).reshape(*lead, n)
    if cut:  # every entry dropped: rows of n + 1 (16-, 8- and 4-byte aligned) cut to n
        drop = torch.full((*lead, 8), n, dtype=torch.int64, device=dev)
        spare = SE2(states.xy[..., :8, :], SO2(states.rot.z[..., :8, :]))
        states = tree_scatter(states, drop, spare)
        log_w = torch.cat([log_w, log_w[..., :1]], -1)[..., :n]
        check(not states.xy.is_contiguous() and not log_w.is_contiguous(),
              "S1: the cut rows came out contiguous")
    active = torch.randint(n // 2, n + 1, (b,), generator=gen, device=dev, dtype=torch.int32)
    active[-1] = n
    active = active.reshape(lead)
    particles = ParticleSet(states, log_w, active)
    models = AmclModels(None, None, None, None, None)

    def plain():
        keys = torch.where(particles.mask, se2_sort_key(states), torch.inf)
        return tree_sort_by(keys, (states, log_w))

    before = cuda_sort.launches
    got, again = (cuda_sort.sort_slots_se2(states, log_w, active, keys=True) for _ in range(2))
    torch.cuda.synchronize()
    label = f"[{', '.join(map(str, (*lead, n)))}]" + (" cut rows" if cut else "")
    check(cuda_sort.launches == before + 2, f"S1 {label}: not one launch a call")
    check(all(torch.equal(x, y) for x, y in ((got[0].xy, again[0].xy),
                                             (got[0].rot.z, again[0].rot.z), (got[1], again[1]),
                                             (got[2], again[2]))),
          f"S1 {label}: two calls differ")
    keys = got[2]
    want_states, want_w = tree_sort_by(keys, (states, log_w))
    check(torch.equal(got[0].xy, want_states.xy) and torch.equal(got[0].rot.z, want_states.rot.z)
          and torch.equal(got[1], want_w), f"S1 {label}: not the stable sort of its own keys")
    live = particles.mask
    check(torch.equal(torch.isinf(keys), ~live), f"S1 {label}: inf keys off the dead slots")
    check(torch.equal(got[0].xy[~live], states.xy[~live])
          and torch.equal(got[0].rot.z[~live], states.rot.z[~live])
          and torch.equal(got[1][~live], log_w[~live]),
          f"S1 {label}: dead slots not last in their order")
    plain_keys = torch.where(live, se2_sort_key(states), torch.inf)
    stray, plain_stray = (keys > 50.0) & live, (plain_keys > 50.0) & live
    theta_gap = float(((keys - 100.0 * stray) - (plain_keys - 100.0 * plain_stray))[live]
                      .abs().max())
    check(theta_gap <= SORT_THETA_ATOL, f"S1 {label}: headings {theta_gap} from the plain key's")
    x, y = states.x.double(), states.y.double()
    c, s = states.rot.cos.double(), states.rot.sin.double()
    centred = lambda v: v - v.mean(-1, keepdim=True)  # noqa: E731
    sd = lambda v: v.std(-1, correction=0, keepdim=True) + 1e-6  # noqa: E731
    rc = torch.hypot(centred(c), centred(s))
    zs = torch.stack([centred(x).abs() / sd(x), centred(y).abs() / sd(y), centred(rc) / sd(rc)],
                     -1)
    clear = ((zs - 3.5).abs() > SORT_Z_EDGE).all(-1) & live
    check(torch.equal(stray[clear], (zs > 3.5).any(-1)[clear]),
          f"S1 {label}: stray flags differ from float64's away from the threshold")
    check(int(stray.sum()) > 0, f"S1 {label}: no strays")
    # the whole output against the plain version's, on the filters whose
    # live slots all lie clear of the threshold (where the two keys' stray
    # flags cannot differ by rounding)
    far = (clear | ~live).all(-1)
    plain_states, plain_w = plain()
    same = ((got[0].xy == plain_states.xy).all(-1).all(-1)
            & (got[0].rot.z == plain_states.rot.z).all(-1).all(-1)
            & (got[1] == plain_w).all(-1))
    check(int(far.sum()) * 2 > b, f"S1 {label}: most filters have a slot near the threshold")
    check(bool(same[far].all()), f"S1 {label}: {int((~same & far).sum())} filters clear of the "
          "threshold differ from the plain version")
    times = timings(lambda: sort_slots(models, particles), plain, iters)
    launch_device_ms(times, lambda: sort_slots(models, particles), "sort_slots_kernel")
    bms, by = bound_ms(b * (SORT_BYTES_PER_PARTICLE * n + SORT_BYTES_PER_FILTER), 0)
    return dict(
        name=SORT, route="cuda", source="beluga_tpu_torch/csrc/sort_slots.cu",
        replaces="beluga_tpu/filters/amcl.py:se2_sort_key and beluga_tpu/core/particles.py:"
                 "tree_sort_by (XLA's reductions, sort and gathers, no Pallas)",
        max_abs_err=theta_gap, strays=int(stray.sum()),
        stray_flags_differ_from_plain=int((stray != plain_stray)[live].sum()),
        filters_equal_to_plain=f"{int((same & far).sum())} of {int(far.sum())} clear "
                               f"({int(same.sum())} of {b} in all)",
        bound_ms=bms, bound_by=by, shape=label, **times,
    )


def window_library(lut, xi, yi, t):
    """``grid_sample`` (trilinear, ``align_corners=True``) of the window
    table at the coordinates, no slab rule: the library yardstick of B6's
    entries, which the port never calls."""
    import torch.nn.functional as F

    k, wx, wy = lut.values_t.shape
    table = lut.values_t.float() * (lut.scale if lut.scale is not None else 1.0)
    vol = table[None, None].contiguous()  # [1, 1, K, Wx, Wy]
    grid = torch.stack([2 * yi / (wy - 1) - 1, 2 * xi / (wx - 1) - 1, 2 * t / (k - 1) - 1],
                       -1)[None, None, None].contiguous()  # (W, H, D) = (y, x, θ)
    return lambda: F.grid_sample(vol, grid, mode="bilinear", align_corners=True)


def check_winlut_states(dev, iters: int, table_dtype: str = "bf16") -> dict:
    """Kernel B6's states entry (``windowed_scan_lut_weights`` in one
    launch) at the windowed filter's geometry, on the cloud and scan of
    ``check_winlut``: an equal miss set with its plain version (the
    coordinate chain, then the lookup), bf16 within rtol 1e-6 and int8
    bit-equal, and bit-equal to the coordinates entry at the plain chain's
    coordinates; timed beside the plain version and ``grid_sample``."""
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import (
        windowed_coords,
        windowed_scan_lut_weights,
    )
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.WINDOWED_FILTER
    states, lut = window_inputs(workloads.windowed(1, dev, table_dtype=table_dtype), cfg,
                                table_dtype=table_dtype)
    states = SE2(states.xy.contiguous(), SO2(states.rot.z.contiguous()))
    tile, tblk = cfg["tile"], cfg["tblk"]
    args = (lut, states, lut.miss, 1.0, tile, tblk)
    got = b6.winlut_lookup_states(*args)
    want = b6.winlut_lookup_states_reference(*args)
    xi, yi, t = (v.contiguous() for v in windowed_coords(lut, states))
    by_coords = b6.winlut_lookup(lut.values_t, xi, yi, t, lut.miss, 1.0, tile, tblk,
                                 scale=lut.scale)
    torch.cuda.synchronize()
    n = states.xy.shape[0]
    k, wx, wy = lut.values_t.shape
    name = "B6" if table_dtype == "bf16" else "B6-int8"
    label = f"{n} particles (states), [{k}, {wx}, {wy}] {table_dtype}, tile {tile}, tblk {tblk}"
    miss_got, miss_want = got == lut.miss, want == lut.miss
    check(torch.equal(miss_got, miss_want),
          f"{name} states {label}: {int((miss_got != miss_want).sum())} particles differ in the "
          f"miss set")
    check(bool(torch.isfinite(got).all()), f"{name} states: weights not finite")
    if table_dtype == "bf16":
        check(torch.allclose(got, want, rtol=1e-6, atol=0),
              f"{name} states {label}: max rel err "
              f"{float(((got - want).abs() / want).max()):.3g} > 1e-6")
    else:
        check(torch.equal(got, want),
              f"{name} states {label}: {int((got != want).sum())} weights differ")
    check(torch.equal(got, by_coords),
          f"{name} states {label}: {int((got != by_coords).sum())} weights differ from the "
          f"coordinates entry at the plain chain's coordinates")
    hit = ~miss_got
    check(0 < int(miss_got.sum()) < n // 10, f"{name} states {label}: {int(miss_got.sum())} misses")
    times = timings(lambda: b6.winlut_lookup_states(*args),
                    lambda: b6.winlut_lookup_states_reference(*args), iters,
                    library=window_library(lut, xi, yi, t))
    launch_device_ms(times, lambda: b6.winlut_lookup_states(*args), "winlut_states_kernel")
    times.update(model_timings(lambda: windowed_scan_lut_weights(lut, states, tile, tblk), iters))
    bms, by = bound_ms(20 * n + lut.values_t.element_size() * lut.values_t.numel(),
                       B6_CHAIN_OPS * n + B6_OPS_PER_PARTICLE * int(hit.sum()))
    return dict(
        name=f"{name} winlut_lookup_states", route="cuda", source="beluga_tpu_torch/csrc/winlut.cu",
        replaces="beluga_tpu/ops/pallas_winlut.py:157" + (
            "" if table_dtype == "bf16" else " (int8 table, :109-142)")
        + " (with beluga_tpu/models/sensor/likelihood_field_winlut.py:293-304, 428)",
        max_abs_err=float((got - want).abs().max()), bound_ms=bms, bound_by=by, shape=label,
        misses=int(miss_got.sum()), **times,
    )


def check_winlut_coverage(dev, iters: int, shift: float = 0.0) -> dict:
    """Kernel B6's coverage entry (the windowed filter's gate,
    ``windowed_coverage_tiled_from_center``, in one launch) at the windowed
    filter's geometry on ``check_winlut``'s cloud, the centre its mean
    moved by ``shift`` m in x and -``shift`` in y (so that the window's
    origin clamps): equal to its plain version (the window origin, the
    coordinates, the slab rule, the share) in two calls in a row, its count
    printed; timed beside the plain version (no library call computes it)."""
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import (
        field_window,
        windowed_coverage_tiled_from_center,
    )
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.WINDOWED_FILTER
    w = workloads.windowed(1, dev)
    states, _ = window_inputs(w, cfg)
    states = SE2(states.xy.contiguous(), SO2(states.rot.z.contiguous()))
    st = w.state.particles.state
    centre = (torch.mean(st.x) + shift, torch.mean(st.y) - shift,
              torch.atan2(torch.mean(st.rot.sin), torch.mean(st.rot.cos)))
    geo = field_window(w.ctx["field"], cfg["k_bins"], cfg["win"], cfg["dth"],
                       cfg["max_point_radius"])
    tile, tblk = cfg["tile"], cfg["tblk"]
    args = (geo, states, *centre, tile, tblk)
    got, again = b6.winlut_coverage_states(*args), b6.winlut_coverage_states(*args)
    want = b6.winlut_coverage_states_reference(*args)
    torch.cuda.synchronize()
    n = states.xy.shape[0]
    label = (f"{n} particles, window [{geo.k_bins}, {geo.win_x}, {geo.win_y}], tile {tile}, "
             f"tblk {tblk}, centre moved {shift} m")
    check(got.shape == () and got.dtype == torch.float32, "B6 coverage: not a 0-d float32")
    check(torch.equal(got, want) and torch.equal(again, want),
          f"B6 coverage {label}: {float(got)}, {float(again)} against {float(want)}")
    count = round(float(want) * n)
    if shift == 0.0:
        check(n // 2 < count < n, f"B6 coverage {label}: {count} of {n} covered")
    times = timings(lambda: b6.winlut_coverage_states(*args),
                    lambda: b6.winlut_coverage_states_reference(*args), iters)
    launch_device_ms(times, lambda: b6.winlut_coverage_states(*args), "winlut_coverage_kernel")
    geo_kw = {k: cfg[k] for k in ("k_bins", "win", "dth", "max_point_radius")}
    times.update(model_timings(lambda: windowed_coverage_tiled_from_center(
        w.ctx["field"], states, *centre, tile=tile, tblk=tblk, **geo_kw), iters))
    bms, by = bound_ms(16 * n + 4, B6_CHAIN_OPS * n)
    return dict(
        name="B6-coverage winlut_coverage_states", route="cuda",
        source="beluga_tpu_torch/csrc/winlut.cu",
        replaces="beluga_tpu/models/sensor/likelihood_field_winlut.py:388 "
                 "windowed_coverage_tiled_from_center (B6's slab rule, "
                 "beluga_tpu/ops/pallas_winlut.py:157)",
        max_abs_err=abs(float(got) - float(want)), bound_ms=bms, bound_by=by, shape=label,
        covered=count, **times,
    )


def scan_lut_conv_weight(ox, oy, mask, sampling: str, radius: int) -> torch.Tensor:
    """``f32[K, 1, 2R+2, 2R+2]``: each beam's sampling weights scattered
    (summed) at its offset, so that a cross-correlation of the circularly
    padded field with it is B9's output (the library yardstick only)."""
    k, nb = ox.shape
    dev = ox.device
    m = mask[None, :].to(torch.float32).expand(k, nb)
    if sampling == "nearest":
        taps = [(torch.round(oy), torch.round(ox), m)]
    else:
        fx, fy = torch.floor(ox), torch.floor(oy)
        ax, ay = ox - fx, oy - fy
        taps = [(fy, fx, m * (1 - ax) * (1 - ay)), (fy, fx + 1, m * ax * (1 - ay)),
                (fy + 1, fx, m * (1 - ax) * ay), (fy + 1, fx + 1, m * ax * ay)]
    size = 2 * radius + 2
    weight = torch.zeros((k, size, size), dtype=torch.float32, device=dev)
    kk = torch.arange(k, device=dev)[:, None].expand(k, nb)
    for iy, ix, wt in taps:
        weight.index_put_((kk, iy.long() + radius, ix.long() + radius), wt, accumulate=True)
    return weight[:, None]


def check_scan_lut(dev, iters: int, sampling: str, downsample: int) -> dict:
    """Kernel B9 on the arena's padded pz³ field and first scan: the
    shared-scan filter's shape (nearest, downsample 2: K 128 x 280 x 384)
    or full resolution (bilinear: 128 x 552 x 640).  The main path's call
    (``scan_lut_correlate`` from the scan, the tables built in the
    kernel's prologue, the halo the field's pad) and the call from the
    tables are bit-equal to the plain version, two launches bit-equal;
    timed beside the plain version (tables and sums) and beside ``conv2d``
    on the circularly padded field (TF32 off), the library yardstick the
    port never calls, when one call of it takes under LIBRARY_LIMIT_MS."""
    import torch.nn.functional as F

    from beluga_tpu_torch.filters.builders import make_likelihood_field_filter
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.models.sensor.likelihood_field_lut import scan_lut_padded
    from beluga_tpu_torch.ops import cuda_scan_lut as b9
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.SHARED_SCAN_FILTER
    s = workloads.arena_scans(1)
    _, ctx = make_likelihood_field_filter(make_grid(s.data, workloads.RES, device=dev),
                                          lookup_mode="gather", device=dev)
    field = ctx["field"]
    padded, pad = scan_lut_padded(field, cfg["max_point_radius"], "pallas", downsample)
    res = field.resolution * downsample
    points = torch.as_tensor(s.points[0]).to(dev)
    mask = torch.as_tensor(s.mask[0]).to(dev)
    k = cfg["n_theta"]
    hp, wp = padded.shape

    def kernel():
        return b9.scan_lut_correlate(padded, points, mask, res, k, sampling, halo=pad)

    def plain():
        tables = b9.scan_lut_tables(points, mask, res, k, hp, wp, sampling)
        return b9.correlate_reference(padded, *tables, sampling)

    shifts, weights = b9.scan_lut_tables(points, mask, res, k, hp, wp, sampling)
    got, again, want = kernel(), kernel(), plain()
    from_tables = b9.correlate(padded, shifts, weights, sampling, halo=pad)
    torch.cuda.synchronize()
    label = f"K {k} x {hp} x {wp}, {points.shape[0]} beams ({int(mask.sum())} unmasked), {sampling}"
    check(bool(torch.isfinite(got).all()), f"B9 {label}: not finite")
    check(torch.equal(got, want),
          f"B9 {label}: {int((got != want).sum())} cells differ from the plain version")
    check(torch.equal(got, again), f"B9 {label}: two launches differ")
    check(torch.equal(from_tables, want),
          f"B9 {label}: from the tables, {int((from_tables != want).sum())} cells differ")
    # the library yardstick: cross-correlation with the scattered footprint
    ox, oy = b9.beam_offsets(points, res, k)
    radius = int(torch.ceil(torch.maximum(ox.abs().max(), oy.abs().max())).item()) + 1
    conv_w = scan_lut_conv_weight(ox, oy, mask, sampling, radius)
    src = F.pad(padded[None, None], (radius, radius + 1, radius, radius + 1), mode="circular")

    def library():
        return F.conv2d(src, conv_w)

    plain_iters = 2 if sampling == "bilinear" and downsample == 1 else 5
    times = timings(kernel, plain, iters, plain_iters=plain_iters)
    extra = {}
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        first = library()
        end.record()
        torch.cuda.synchronize()
    except RuntimeError as e:  # the yardstick only: B9 stands without it
        extra["library_note"] = f"conv2d failed: {e}"[:200]
    else:
        once = start.elapsed_time(end)
        lib_err = float((first[0] - got).abs().max() / got.abs().max())
        extra.update(conv2d_radius=radius, conv2d_rel_err=lib_err, conv2d_first_call_ms=once)
        if lib_err > 1e-4:
            extra["library_note"] = f"conv2d differs by {lib_err:.3g} of the maximum: not timed"
        elif once < LIBRARY_LIMIT_MS:
            times["library_ms"] = cuda_ms(library, max(2, min(iters, int(200 / max(once, 1e-3)))))
            # torch.profiler has reported conv2d's kernels for one call of
            # three, or for none, even with one call a profiler run: time
            # it queued
            times["library_device_ms"] = queued_device_ms(library, 3)
            if times["library_device_ms"] is None:
                extra["library_note"] = ("conv2d device time not measured: the host did not "
                                         "queue its calls within the spin")
        else:
            extra["library_note"] = f"conv2d took {once:.0f} ms on its first call: not timed"
    nb = points.shape[0]
    cells = k * hp * wp
    bms, by = bound_ms(4 * hp * wp + 20 * k * nb + 4 * cells,
                       B9_OPS[sampling] * cells * int(mask.sum()))
    return dict(
        name="B9 scan_lut_correlate", route="cuda", source="beluga_tpu_torch/csrc/scan_lut.cu",
        replaces="beluga_tpu/ops/pallas_scan_lut.py:74",
        max_abs_err=float((got - want).abs().max()), bound_ms=bms, bound_by=by, shape=label, **extra, **times,
    )


def near_edge(xo, yo, co, so, scalars, k: int, wx: int, wy: int, tile: int):
    """Particles whose float64 window coordinates (recomputed from the
    plain version's outputs) lie within EDGE of a window or bin edge, or in
    a tile whose minimum bin does."""
    from beluga_tpu_torch.ops import cuda_fused_step as b5

    sc = scalars.double()
    x, y, c, s = (v.double() for v in (xo, yo, co, so))
    xf = (sc[b5.WF_C] * x - sc[b5.WF_S] * y + sc[b5.WF_X]) * sc[b5.INV_RES] + sc[b5.OFF_X]
    yf = (sc[b5.WF_S] * x + sc[b5.WF_C] * y + sc[b5.WF_Y]) * sc[b5.INV_RES] + sc[b5.OFF_Y]
    rel = torch.remainder(torch.atan2(s, c) + sc[b5.T_ANG] + math.pi, 2 * math.pi) - math.pi
    t = rel * sc[b5.INV_DTH] + sc[b5.T_BIAS]
    frac = (t - torch.round(t)).abs()
    near = ((xf.abs() < EDGE) | ((xf - (wx - 1)).abs() < EDGE) | (yf.abs() < EDGE)
            | ((yf - (wy - 1)).abs() < EDGE) | (frac < EDGE))
    n = t.numel()
    pad = -n % tile
    tt = torch.nn.functional.pad(t, (0, pad), value=-1.0).reshape(-1, tile)
    ft = torch.nn.functional.pad(frac, (0, pad), value=1.0).reshape(-1, tile)
    arg = torch.where((tt >= 0) & (tt < k), tt, torch.inf).argmin(dim=1)
    tile_near = ft.gather(1, arg[:, None]) < EDGE
    return near | tile_near.expand(-1, tile).reshape(-1)[:n]


def check_fused_step(n: int, dev, iters: int, table: str = "mega") -> dict:
    """Kernel B5 at the mega geometry (2097152 particles, 20 bins, a 32x128
    window, tile 4096, tblk 20: its 160 KB table in shared memory) or, with
    ``table="windowed"``, at the windowed filter's (262144 particles, 64
    bins, 128x128, tile 512, tblk 16: its 2 MB table read through L2), on
    the workload's cloud with strays, the motion of its first step, fresh
    normals: states within 1e-5 of its plain version, log-likelihoods
    within 1e-5, miss sets equal except within EDGE of an edge (counted)."""
    from beluga_tpu_torch.filters.amcl import host_pose
    from beluga_tpu_torch.filters.builders import fused_step_scalars
    from beluga_tpu_torch.ops import cuda_fused_step as b5
    from beluga_tpu_torch.tools import workloads

    from beluga_tpu_torch.models.motion.differential_drive import DifferentialDriveParams

    if table == "mega":
        cfg, w = workloads.MEGA_FILTER, workloads.mega(2, dev)
    else:
        cfg, w = workloads.WINDOWED_FILTER, workloads.windowed(2, dev)
    states, lut = window_inputs(w, cfg)
    s = w.scans
    scalars = fused_step_scalars(lut, DifferentialDriveParams(),
                                 host_pose(s.xs[1], s.ys[1], s.yaws[1]),
                                 host_pose(s.xs[0], s.ys[0], s.yaws[0]), dev)
    tile, tblk = cfg["tile"], cfg["tblk"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    z = torch.randn((3, n), generator=gen, device=dev)
    planes = [v[:n].contiguous() for v in (states.x, states.y, states.theta)]
    args = (*planes, z, lut.values_t, scalars)
    got = b5.fused_propagate_winlut(*args, tile=tile, tblk=tblk)
    want = b5.fused_propagate_winlut_reference(*args, tile=tile, tblk=tblk)
    torch.cuda.synchronize()
    k, wx, wy = lut.values_t.shape
    where = "shared memory" if 2 * lut.values_t.numel() <= 225 * 1024 else "L2"
    label = f"{n} particles, [{k}, {wx}, {wy}] bf16 ({where}), tile {tile}, tblk {tblk}"
    for g, x, what in zip(got, want, ("x'", "y'", "cos'", "sin'", "log_lik")):
        check(bool(torch.isfinite(g).all()), f"B5 {label}: {what} not finite")
    state_err = max(float((g - x).abs().max()) for g, x in zip(got[:4], want[:4]))
    check(state_err <= 1e-5, f"B5 {label}: states differ by {state_err:.3g} > 1e-5")
    miss_lw = torch.log(lut.miss)
    miss_got, miss_want = got[4] == miss_lw, want[4] == miss_lw
    near = near_edge(*want[:4], scalars, k, wx, wy, tile)
    flips = miss_got != miss_want
    check(not bool((flips & ~near).any()),
          f"B5 {label}: {int((flips & ~near).sum())} miss flips away from an edge")
    both = ~miss_got & ~miss_want
    lw_err = float((got[4][both] - want[4][both]).abs().max())
    check(lw_err <= 1e-5, f"B5 {label}: log-likelihoods differ by {lw_err:.3g} > 1e-5")
    check(0 < int(miss_got.sum()) < n // 2, f"B5 {label}: {int(miss_got.sum())} misses")
    times = timings(lambda: b5.fused_propagate_winlut(*args, tile=tile, tblk=tblk),
                    lambda: b5.fused_propagate_winlut_reference(*args, tile=tile, tblk=tblk),
                    iters)
    bms, by = bound_ms(44 * n + 2 * lut.values_t.numel(), B5_OPS_PER_PARTICLE * n)
    return dict(
        name="B5 fused_propagate_winlut", route="cuda", source="beluga_tpu_torch/csrc/winlut.cu",
        replaces="beluga_tpu/ops/pallas_fused_step.py:169",
        max_abs_err=max(state_err, lw_err), bound_ms=bms, bound_by=by, shape=label,
        misses=int(miss_got.sum()), miss_flips=int(flips.sum()),
        near_edge=int(near.sum()), **times,
    )


def beam_scan(points: torch.Tensor):
    """Measured ranges, unit bearings and bearing angles of a scan's points."""
    px, py = points[..., 0], points[..., 1]
    z = torch.sqrt(px * px + py * py)
    return z, points / torch.clamp_min(z, 1e-12)[..., None], torch.atan2(py, px)


def arena_cloud(n: int, dev, seed: int, batch: int | None = None, stray_every: int = 0):
    """``n`` particles about the arena's first pose (sd 0.3 m, 0.2 rad),
    θ-sorted, every ``stray_every``-th moved 5 m off; one filter or
    ``batch``."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.tools.workloads import arena_scans

    s = arena_scans(1)
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    xyt = rng.normal([s.xs[0], s.ys[0], s.yaws[0]], [0.3, 0.3, 0.2], (*lead, n, 3))
    xyt = np.take_along_axis(xyt, np.argsort(xyt[..., 2:], axis=-2, kind="stable"), axis=-2)
    if stray_every:
        xyt[..., ::stray_every, :2] += 5.0
    return SE2.from_xytheta(*(torch.as_tensor(xyt[..., i], dtype=torch.float32)
                              for i in range(3)), device=dev), s


def r1_device_ms(times: dict, fn, calls: int = 30) -> None:
    """R1's device time in ``times`` (from ``timings``): each call queued
    alone behind a spin (``queued_device_ms(each=True)``), its median as
    ``device_ms`` and the spread as ``device_ms_each``, in place of the
    profiler's figure, which at times counts only part of R1's launches."""
    spread = queued_device_ms(fn, calls, each=True)
    times["device_ms"] = None if spread is None else spread["median"]
    times["device_ms_each"] = spread


def raycast_map(which: str, dev):
    """The grid of a ray-cast check: the 384² arena at 5 cm (``node``,
    ``lut_build``), the long-range 1024² map at 0.1 m (a bit plane of 128
    KB, staged in shared memory) or a 2048² map of the same kind (512 KB,
    past what a block's shared memory holds: read through L2), with its
    first pose and scan."""
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.tools import workloads

    if which in ("node", "lut_build", "record"):
        s = workloads.arena_scans(1)
        return (make_grid(s.data, workloads.RES, device=dev), (s.xs[0], s.ys[0], s.yaws[0]),
                s.points[0], s.mask[0])
    cfg = workloads.LONG_RANGE
    cells = cfg["cells"] if which == "long_range" else 2 * cfg["cells"]
    data = synthetic.long_range_world(cells)
    xs, ys, yaws = synthetic.arc_trajectory(1, cells, cfg["res"])
    pts, mask = synthetic.simulate_scans(data, cfg["res"], xs, ys, yaws, workloads.BEAMS,
                                         max_range=cfg["beam_max_range"])
    return make_grid(data, cfg["res"], device=dev), (xs[0], ys[0], yaws[0]), pts[0], mask[0]


def check_raycast(dev, iters: int, which: str) -> dict:
    """Kernel R1's ray entry: at the beam node's 2000 x 60 rays at 100 m on
    the arena (``which="node"``), the range-LUT build's 128 x 384 x 384
    rays at 4 m (``"lut_build"``, its sources and directions broadcast as
    ``build_range_lut`` passes them), ``tools/record.py``'s 360 rays at
    3.5 m from one source (``"record"``, as ``ScanSimulator.cast`` passes
    them), 2048 x 60 rays at 60 m on the
    long-range 1024² map (``"long_range"``: its 128 KB plane in shared
    memory) or 2000 x 60 at 60 m on a 2048² map (``"l2"``: the plane read
    through L2): hit flags and distances bit-equal to its plain version,
    both variants.  The bound counts the cells the plain version probes."""
    from beluga_tpu_torch.ops import raycast as r1
    from beluga_tpu_torch.tools import workloads

    grid, pose, points, _ = raycast_map(which, dev)
    if which == "lut_build":
        k, h, w = workloads.BEAM_FLEET["n_bearings"], grid.height, grid.width
        max_range = workloads.BEAM_FLEET["beam_max_range"]
        res = torch.tensor(grid.resolution, dtype=torch.float32, device=dev)
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * res
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * res
        src = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], -1)[None]
        th = torch.arange(k, dtype=torch.float32, device=dev) * (2.0 * math.pi / k)
        dirs = torch.stack([torch.cos(th), torch.sin(th)], -1)[:, None, None, :]
        label = f"{k}x{h}x{w} rays (range-LUT build, {max_range} m, broadcast inputs)"
        plain_iters = 2
        in_bytes = src.numel() * 4 + dirs.numel() * 4
    elif which == "record":
        from beluga_tpu_torch.io.replay import ScanSimulator
        from beluga_tpu_torch.lie import SE2

        sim = ScanSimulator(grid)  # the LDS-01 spec: 360 beams at 3.5 m
        local = grid.origin.inverse() @ SE2.from_xytheta(*pose, device=dev)
        n, max_range = sim.spec.num_beams, sim.spec.max_range
        src = local.xy.expand(n, 2)
        world = local.theta + sim._angles
        dirs = torch.stack([torch.cos(world), torch.sin(world)], -1)
        label = f"{n} rays (record's scan, {max_range} m, the source broadcast)"
        plain_iters = 20
        in_bytes = 8 + dirs.numel() * 4
    else:
        n = workloads.LONG_RANGE["n"] if which == "long_range" else 2000
        max_range = BEAM_NODE_RANGE if which == "node" else workloads.LONG_RANGE["beam_max_range"]
        rng = np.random.default_rng(11)
        xyt = rng.normal(pose, [0.3, 0.3, 0.2], (n, 3)).astype(np.float32)
        c, sn = (torch.as_tensor(f(xyt[:, 2:])).to(dev) for f in (np.cos, np.sin))
        _, bearing, _ = beam_scan(torch.as_tensor(points).to(dev))
        bx, by = bearing[None, :, 0], bearing[None, :, 1]
        src = torch.as_tensor(xyt[:, None, :2]).to(dev)
        dirs = torch.stack([c * bx - sn * by, sn * bx + c * by], -1)
        src, dirs = (v.contiguous() for v in torch.broadcast_tensors(src, dirs))
        label = (f"{n}x{bearing.shape[0]} rays ({which}, {grid.height}² at {grid.resolution:g} m, "
                 f"{max_range} m)")
        plain_iters = 3
        in_bytes = 16 * src.shape[0] * src.shape[1]
    plane_kb = r1.free_plane(grid).bits.numel() * 4 / 1024
    label += f", plane {plane_kb:g} KB"
    steps = r1.num_steps(max_range, grid.resolution)
    err, cells = 0.0, 0
    for variant in r1.VARIANTS:
        got = r1.cast_rays(grid, src, dirs, max_range, variant=variant)
        want = r1.cast_rays_reference(grid.free_mask, src, dirs, max_range, grid.resolution,
                                      steps, variant, count_cells=True)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]),
              f"R1 {variant} {label}: {int((got[1] != want[1]).sum())} hit flags differ")
        check(torch.equal(got[0], want[0]),
              f"R1 {variant} {label}: {int((got[0] != want[0]).sum())} distances differ")
        err = max(err, float((got[0] - want[0]).abs().max()))
        if variant == "standard":
            hit, cells = got[1], int(want[2].sum())
    check(0 < int(hit.sum()) < hit.numel() or which == "lut_build",
          f"R1 {label}: no hits or no misses")
    times = timings(lambda: r1.cast_rays(grid, src, dirs, max_range),
                    lambda: r1.cast_rays_reference(grid.free_mask, src, dirs, max_range,
                                                   grid.resolution, steps, "standard"),
                    iters, plain_iters=plain_iters)
    r1_device_ms(times, lambda: r1.cast_rays(grid, src, dirs, max_range),
                 10 if which == "lut_build" else 30)
    n = hit.numel()
    bms, by = bound_ms(in_bytes + 5 * n + r1.free_plane(grid).bits.numel() * 4,
                       R1_OPS_PER_CELL * cells)
    return dict(
        name="R1 cast_rays", route="cuda", source="beluga_tpu_torch/csrc/raycast.cu",
        replaces="beluga_tpu/ops/raycast.py:33 (no Pallas kernel)", max_abs_err=err,
        bound_ms=bms, bound_by=by, shape=label, cells_visited=cells, hits=int(hit.sum()),
        **times,
    )


def check_beam_exact(dev, iters: int, which: str) -> dict:
    """Kernel R1's exact beam-weights entry at the beam node's shape (2000
    particles x 60 beams at 100 m on the arena, ``which="node"``) or at
    2000 x 60 at 60 m on the 2048² map whose plane is read through L2
    (``"l2"``), one beam masked, both variants: each beam's pz³ (the
    weight of that beam alone) and the full sums within EXACT_RTOL of the
    plain version (and how many are bit-equal), log space within
    EXACT_RTOL, two launches bit-equal."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.models.sensor.beam import BeamModelParams, exact_mixture
    from beluga_tpu_torch.ops import raycast as r1
    from beluga_tpu_torch.tools import workloads

    grid, pose, points, mask = raycast_map(which, dev)
    bmr = BEAM_NODE_RANGE if which == "node" else workloads.LONG_RANGE["beam_max_range"]
    params = BeamModelParams(beam_max_range=bmr)
    mix = exact_mixture(params)
    rng = np.random.default_rng(15)
    xyt = rng.normal(pose, [0.3, 0.3, 0.2], (2000, 3))
    states = SE2.from_xytheta(*(torch.as_tensor(xyt[:, i], dtype=torch.float32)
                                for i in range(3)), device=dev)
    pts = torch.as_tensor(points).to(dev)
    beams = torch.as_tensor(mask).to(dev)
    beams[3] = False  # a masked beam
    label = (f"2000x{pts.shape[0]} ({which}, {grid.height}² at {grid.resolution:g} m, {bmr} m, "
             f"plane {r1.free_plane(grid).bits.numel() * 4 / 1024:g} KB)")
    out = dict(name="R1-exact beam_weights", route="cuda",
               source="beluga_tpu_torch/csrc/raycast.cu",
               replaces="beluga_tpu/models/sensor/beam.py:38 beam_weights (with "
                        "beluga_tpu/ops/raycast.py:33; no Pallas kernel)",
               shape=label, variants={})
    err = 0.0
    for variant in r1.VARIANTS:
        args = (grid, states, pts, beams, mix, bmr, variant)
        got, again = r1.exact_beam_weights(*args), r1.exact_beam_weights(*args)
        want = r1.exact_beam_weights_reference(*args)
        got_log = r1.exact_beam_weights(*args, log_space=True)
        want_log = r1.exact_beam_weights_reference(*args, log_space=True)
        # each unmasked beam alone: its pz³
        on = torch.nonzero(beams).flatten().tolist()
        pz3_got = torch.stack([
            r1.exact_beam_weights(grid, states, pts, torch.arange(beams.numel(), device=dev) == b,
                                  mix, bmr, variant) for b in on], -1)
        pz3_want = r1.exact_pz3_reference(grid, states, pts, mix, bmr, variant)[:, on]
        torch.cuda.synchronize()
        tag = f"R1-exact {variant} {label}"
        check(bool(torch.isfinite(got).all()), f"{tag}: weights not finite")
        check(torch.equal(got, again), f"{tag}: two launches differ")
        for what, g, w in (("pz³", pz3_got, pz3_want), ("sums", got, want)):
            bad = int((~torch.isclose(g, w, rtol=EXACT_RTOL, atol=0.0)).sum())
            check(bad == 0, f"{tag}: {bad} {what} outside rtol {EXACT_RTOL} of the plain version")
        bad = int((~torch.isclose(got_log, want_log, rtol=0.0, atol=EXACT_RTOL)).sum())
        check(bad == 0, f"{tag}: {bad} log weights beyond {EXACT_RTOL} of the plain version")
        check(float(want.std()) > 0, f"{tag}: the weights do not discriminate")
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max()
        out["variants"][variant] = dict(
            pz3_bit_equal_share=float((pz3_got == pz3_want).float().mean()),
            sums_bit_equal_share=float((got == want).float().mean()),
            log_bit_equal_share=float((got_log == want_log).float().mean()),
            max_rel_err=float(rel))
        err = max(err, float((got - want).abs().max()))
    args = (grid, states, pts, beams, mix, bmr, "standard")
    times = timings(lambda: r1.exact_beam_weights(*args, log_space=True),
                    lambda: r1.exact_beam_weights_reference(*args, log_space=True), iters,
                    plain_iters=3)
    r1_device_ms(times, lambda: r1.exact_beam_weights(*args, log_space=True))
    # the work these inputs need: the unmasked rays' cells, as the plain
    # version probes them, and the mixture
    local = grid.origin.inverse() @ states
    _, bearing = r1.ranges_and_bearings(pts[beams])
    c, sn = local.rot.cos[:, None], local.rot.sin[:, None]
    dirs = torch.stack([c * bearing[None, :, 0] - sn * bearing[None, :, 1],
                        sn * bearing[None, :, 0] + c * bearing[None, :, 1]], -1)
    src, dirs = torch.broadcast_tensors(local.xy[:, None, :], dirs)
    _, _, cells = r1.cast_rays_reference(grid.free_mask, src, dirs, bmr, grid.resolution,
                                         r1.num_steps(bmr, grid.resolution), "standard",
                                         count_cells=True)
    n, unmasked = states.shape[0], int(beams.sum())
    plane_bytes = r1.free_plane(grid).bits.numel() * 4
    bms, by = bound_ms(16 * n + 9 * beams.numel() + 4 * n + plane_bytes,
                       R1_OPS_PER_CELL * int(cells.sum()) + B8_OPS_PER_RAY * n * unmasked
                       + MIXTURE_BEAM_OPS * unmasked + SE2_COMPOSE_OPS * n)
    out.update(max_abs_err=err, bound_ms=bms, bound_by=by, cells_visited=int(cells.sum()),
               **times)
    return out


def check_sphere_trace(dev, iters: int, long_range: bool, n_beams: int | None = None) -> dict:
    """Kernel B8 at the beam node's 2000 x 60 on the arena at 100 m (89
    steps), or the long-range filter's 2048 x 60 on the 1024² map at 60 m
    (48 steps), or the node's 2000 particles with a scan of ``n_beams``
    beams (more than a block's tile of 256): weights bit-equal to its plain
    version (same operations in the same order), finite."""
    from beluga_tpu_torch.filters.builders import sphere_trace_steps
    from beluga_tpu_torch.io import synthetic
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.models.sensor.beam import BeamModelParams
    from beluga_tpu_torch.ops import cuda_beam as b8
    from beluga_tpu_torch.tools import workloads

    if long_range:
        cfg = workloads.LONG_RANGE
        data = synthetic.long_range_world(cfg["cells"])
        xs, ys, yaws = synthetic.arc_trajectory(1, cfg["cells"], cfg["res"])
        pts, mask = synthetic.simulate_scans(data, cfg["res"], xs, ys, yaws, workloads.BEAMS,
                                             max_range=cfg["beam_max_range"])
        grid = make_grid(data, cfg["res"], device=dev)
        params = BeamModelParams(beam_max_range=cfg["beam_max_range"], sigma_hit=cfg["sigma_hit"])
        rng = np.random.default_rng(12)
        xyt = rng.normal([xs[0], ys[0], yaws[0]], [0.5, 0.5, 0.2], (cfg["n"], 3))
        states = SE2.from_xytheta(*(torch.as_tensor(xyt[:, i], dtype=torch.float32)
                                    for i in range(3)), device=dev)
        label = f"{cfg['n']}x{workloads.BEAMS}, 1024² at 0.1 m, {params.beam_max_range} m"
    else:
        states, s = arena_cloud(2000, dev, seed=13)
        pts, mask = s.points, s.mask
        if n_beams:
            pts, mask = synthetic.simulate_scans(s.data, workloads.RES, s.xs[:1], s.ys[:1],
                                                 s.yaws[:1], n_beams)
        grid = make_grid(s.data, workloads.RES, device=dev)
        params = workloads.node_config(s, laser_model_type="beam").beam_params()
        label = f"2000x{pts.shape[1]}, arena, {params.beam_max_range} m"
    steps = sphere_trace_steps(params.beam_max_range, grid.resolution)
    label += f", {steps} steps"
    dist = b8.make_distance_cells(grid.free_mask)
    z, bearing, _ = beam_scan(torch.as_tensor(pts[0]).to(dev))
    beams = torch.as_tensor(mask[0]).to(dev)
    pv = (params.beam_max_range, params.z_hit, params.z_short, params.z_max, params.z_rand,
          params.sigma_hit, params.lambda_short)
    poses = [v.contiguous() for v in (states.x, states.y, states.rot.cos, states.rot.sin)]
    args = (dist, *poses, bearing.contiguous(), z.contiguous(), beams, grid.resolution, pv)
    got = b8.sphere_trace_beam_weights(*args, march_steps=steps)
    want = b8.sphere_trace_reference(*args, march_steps=steps)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"B8 {label}: weights not finite")
    check(torch.equal(got, want),
          f"B8 {label}: {int((got != want).sum())} weights differ from the plain version")
    traced = b8.trace_steps(dist, *poses, bearing, beams, grid.resolution, pv, steps)
    times = timings(lambda: b8.sphere_trace_beam_weights(*args, march_steps=steps),
                    lambda: b8.sphere_trace_reference(*args, march_steps=steps), iters,
                    plain_iters=2 if n_beams else 5)
    n, unmasked = poses[0].numel(), int(beams.sum())
    bms, by = bound_ms(20 * n + 13 * beams.numel() + dist.numel(),
                       B8_OPS_PER_RAY * n * unmasked + MIXTURE_BEAM_OPS * unmasked
                       + B8_OPS_PER_STEP * traced)
    return dict(
        name="B8 sphere_trace_beam_weights", route="cuda", source="beluga_tpu_torch/csrc/beam.cu",
        replaces="beluga_tpu/ops/pallas_beam.py:188", max_abs_err=float((got - want).abs().max()),
        bound_ms=bms, bound_by=by, shape=label, trace_steps=traced, **times,
    )


def check_beam_lut(dev, iters: int, which: str) -> tuple[dict, dict]:
    """Kernel B7 at the beam fleet's geometry (``which="fleet"``: 64 filters
    x 4096 θ-sorted particles x 60 beams, K = 128 at 4 m) or the beam
    node's ``windowed`` mode (``"node"``: 2000 particles, K = 128 at nav2's
    100 m), every 50th slot a stray 5 m off (all-miss): weights bit-equal to
    its plain version and two launches bit-equal, the strays scoring the
    LUT's max range in every bin; and its origins kernel equal to
    ``window_origins``.  Returns the weights' entry and the origins'."""
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.models.sensor.beam import BeamModelParams
    from beluga_tpu_torch.models.sensor.beam_lut import build_range_lut, lut_cells
    from beluga_tpu_torch.ops import cuda_beam_lut as b7
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.BEAM_FLEET
    batch, n, max_range = ((FLEET_B, FLEET_N, cfg["beam_max_range"]) if which == "fleet"
                           else (1, 2000, BEAM_NODE_RANGE))
    states, s = arena_cloud(n, dev, seed=14, batch=batch, stray_every=50)
    lut = build_range_lut(make_grid(s.data, workloads.RES, device=dev), max_range,
                          cfg["n_bearings"])
    table = b7.build_lut_bf16(lut.ranges)
    local, xi, yi = lut_cells(lut, states)
    z, _, beta = beam_scan(torch.as_tensor(s.points[0]).to(dev))
    beams = torch.as_tensor(s.mask[0]).to(dev)
    p = BeamModelParams(beam_max_range=max_range)
    mix = (p.z_hit, p.z_short, p.z_rand, p.z_max, p.sigma_hit, p.lambda_short, p.beam_max_range)
    lead = (batch, workloads.BEAMS)
    args = (table, local.theta.contiguous(), xi, yi, z.expand(lead).contiguous(),
            beta.expand(lead).contiguous(), beams.expand(lead).contiguous(), lut.max_range, mix)
    got, want = b7.beam_lut_windowed(*args), b7.beam_lut_windowed_reference(*args)
    again = b7.beam_lut_windowed(*args)
    torch.cuda.synchronize()
    label = (f"{which}: {batch}x{n}x{workloads.BEAMS}, K={cfg['n_bearings']} at {max_range} m, "
             f"bf16{list(table.shape)}")
    check(bool(torch.isfinite(got).all()), f"B7 {label}: weights not finite")
    check(torch.equal(got, want),
          f"B7 {label}: {int((got != want).sum())} weights differ from the plain version")
    check(torch.equal(got, again), f"B7 {label}: two launches differ")
    hq, wq, k = table.shape
    origins = b7.window_origins(xi, yi, hq, wq)
    on_card = b7.device_window_origins(xi, yi, hq, wq)
    torch.cuda.synchronize()
    check(torch.equal(on_card, origins),
          f"B7 {label}: {int((on_card != origins).sum())} window origins differ from "
          "window_origins")
    slot = torch.arange(n, device=dev)
    o = origins[:, slot // b7.TILE, (slot % b7.TILE >= b7.BLOCKS[1][0]).long()]
    covered = ((xi >= o[..., 0]) & (xi < o[..., 0] + b7.CWX) & (yi >= o[..., 1])
               & (yi < o[..., 1] + b7.CWY))
    strays = ~covered
    check(bool(strays[:, ::50].all()) and int(strays.sum()) < covered.numel() // 10,
          f"B7 {label}: {int(strays.sum())} particles outside their windows")
    all_miss = b7.beam_lut_windowed_reference(
        torch.full_like(table, lut.max_range), *args[1:])
    check(torch.equal(got[strays], all_miss[strays]), f"B7 {label}: strays do not read max range")
    times = timings(lambda: b7.beam_lut_windowed(*args),
                    lambda: b7.beam_lut_windowed_reference(*args), iters, plain_iters=5)
    cells = int(torch.unique((yi * wq + xi)[covered]).numel())
    total, unmasked = xi.numel(), int(beams.sum()) * batch
    bms, by = bound_ms(16 * total + 9 * batch * workloads.BEAMS + 2 * k * cells,
                       B7_OPS_PER_RAY * n * unmasked + MIXTURE_BEAM_OPS * unmasked)
    weights = dict(
        name="B7 beam_lut_windowed", route="cuda", source="beluga_tpu_torch/csrc/beam_lut.cu",
        replaces="beluga_tpu/ops/pallas_beam_lut.py:342",
        max_abs_err=float((got - want).abs().max()), bound_ms=bms, bound_by=by, shape=label,
        strays=int(strays.sum()), lut_cells_read=cells,
        **times,
    )
    times = timings(lambda: b7.device_window_origins(xi, yi, hq, wq),
                    lambda: b7.window_origins(xi, yi, hq, wq), iters, plain_iters=20)
    tiles = origins.shape[1]
    bms, by = bound_ms(8 * total + 16 * batch * tiles, 2 * total)
    window = dict(
        name="B7-origins window_origins", route="cuda", source="beluga_tpu_torch/csrc/beam_lut.cu",
        replaces="beluga_tpu/ops/pallas_beam_lut.py:256 (_beam_lut_call's block means; no Pallas)",
        max_abs_err=float((on_card - origins).abs().max()), bound_ms=bms, bound_by=by,
        shape=f"{which}: {batch}x{n} cells, {tiles} tile(s) of 4096", **times,
    )
    return weights, window


def ndt_queries(ndt_map, states, points, mask):
    """The encoded stencil cells that the NDT model probes for ``states``
    (one particle chunk) and a point cloud (``models/sensor/ndt.py:
    _kernel_likelihood``)."""
    from beluga_tpu_torch.maps.ndt import encode_cells
    from beluga_tpu_torch.models.sensor.ndt import (
        KERNEL_2D,
        KERNEL_3D,
        fit_measurement_cells,
        measurements_in_world,
    )

    means, covs, _ = fit_measurement_cells(points, mask, ndt_map.resolution)
    mean_w, _ = measurements_in_world(states, means, covs)
    kernel = KERNEL_2D if ndt_map.dim == 2 else KERNEL_3D
    offsets = torch.as_tensor(kernel, device=mean_w.device)
    return encode_cells(ndt_map.cell_near(mean_w)[..., None, :] + offsets)


def check_ndt_probe(dev, iters: int, dim: int) -> dict:
    """Kernel B10 at a main path's particle chunk: in 2D the NDT fleet's
    (64 filters x 512 particles x 60 cells x 9), in 3D the NDT-3D node's
    (512 particles x 3600 cells x 7), bit-equal to its plain version
    (``torch.searchsorted`` and a gather, the yardstick); no single library
    call computes the function."""
    from beluga_tpu_torch.core.particles import tree_map
    from beluga_tpu_torch.core.random import sample_normal_se3
    from beluga_tpu_torch.lie import SE3
    from beluga_tpu_torch.ops import cuda_ndt as b10
    from beluga_tpu_torch.tools import workloads

    if dim == 2:
        w = workloads.ndt_fleet(1, dev)
        ndt_map = w.ctx["ndt_map"]
        states = tree_map(lambda leaf: leaf[:, :NDT_CHUNK].contiguous(), w.state.particles.state)
        q = ndt_queries(ndt_map, states, w.points, w.mask)
    else:
        s = workloads.ndt_scans(1)
        clouds, cmask = workloads.ndt_clouds(s)
        ndt_map = workloads.ndt_map_3d(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(10)
        states = sample_normal_se3(gen, NDT_CHUNK, SE3.from_xyzrpy(
            [s.xs[0], s.ys[0], 0.0], (0.0, 0.0, s.yaws[0]), device="cpu"),
            workloads.INITIAL_COV_3D)
        q = ndt_queries(ndt_map, states, torch.as_tensor(clouds[0]).to(dev),
                        torch.as_tensor(cmask[0]).to(dev))
    args = (ndt_map.keys, ndt_map.values, ndt_map.num_cells, q)
    got_v, got_f = b10.ndt_probe(*args)
    want_v, want_f = b10.ndt_probe_reference(*args)
    torch.cuda.synchronize()
    label = f"{list(q.shape)} queries, {ndt_map.num_cells} keys, P = {ndt_map.values.shape[1]}"
    check(torch.equal(got_f, want_f),
          f"B10 {label}: {int((got_f != want_f).sum())} found flags differ")
    check(torch.equal(got_v, want_v),
          f"B10 {label}: {int((got_v != want_v).any(-1).sum())} value rows differ")
    hits = float(got_f.float().mean())
    check(0.0 < hits < 1.0, f"B10 {label}: hit share {hits}")
    times = timings(lambda: b10.ndt_probe(*args), lambda: b10.ndt_probe_reference(*args), iters)
    n, m, p = q.numel(), ndt_map.num_cells, ndt_map.values.shape[1]
    bms, by = bound_ms(n * (4 + 4 * p + 1) + m * (4 + 4 * p), 0)
    return dict(
        name="B10 ndt_probe", route="cuda", source="beluga_tpu_torch/csrc/ndt_probe.cu",
        replaces="beluga_tpu/ops/pallas_ndt.py:48", max_abs_err=float(
            (got_v - want_v).abs().max()), bound_ms=bms, bound_by=by, hit_share=hits,
        shape=f"{dim}D {label}", **times,
    )


def ndt_weights_inputs(dev, which: str) -> tuple[tuple, object, str]:
    """The fused NDT kernel's arguments at a main path's shape, the map's
    cell index and a label: the NDT node's (2000 particles about its first
    pose, one 360-beam scan, the 2D map), the NDT fleet's (64 x 4096
    particles, 60 points), the NDT-3D node's (2000 particles, one
    3600-point cloud, the 3D map) or the benchmark's (``ndt_fleet.track``:
    4096 x 4096 particles, 360-beam scans, the 2D map; filter b about the
    pose of scan b mod 64 of the arena circle, 0.1 m and 0.05 rad apart)."""
    from beluga_tpu_torch.core.random import sample_normal_se3
    from beluga_tpu_torch.lie import SE2, SE3
    from beluga_tpu_torch.models.sensor.ndt import (
        KERNEL_2D,
        KERNEL_3D,
        NdtModelParams,
        fit_measurement_cells,
        pose_matrices,
    )
    from beluga_tpu_torch.tools import workloads

    if which == "fleet":
        w = workloads.ndt_fleet(1, dev)
        ndt_map, states, points, mask = w.ctx["ndt_map"], w.state.particles.state, w.points, w.mask
    elif which == "node":
        s = workloads.ndt_scans(1)
        ndt_map = workloads.ndt_map_2d(dev)
        rng = np.random.default_rng(15)
        xyt = rng.normal([s.xs[0], s.ys[0], s.yaws[0]], [0.3, 0.3, 0.2], (2000, 3))
        states = SE2.from_xytheta(*(torch.as_tensor(xyt[:, i], dtype=torch.float32)
                                    for i in range(3)), device=dev)
        points, mask = (torch.as_tensor(v[0]).to(dev) for v in (s.points, s.mask))
    elif which == "bench":
        s = workloads.ndt_scans(NDT_BENCH_SCANS)
        ndt_map = workloads.ndt_map_2d(dev)
        scan = torch.arange(NDT_BENCH_ROBOTS, device=dev) % NDT_BENCH_SCANS
        gen = torch.Generator(device=dev)
        gen.manual_seed(17)
        pose = torch.as_tensor(np.stack([s.xs, s.ys, s.yaws], -1), dtype=torch.float32,
                               device=dev)[scan]
        spread = torch.as_tensor([0.1, 0.1, 0.05], device=dev)
        xyt = pose[:, None, :] + spread * torch.randn(
            (NDT_BENCH_ROBOTS, NDT_BENCH_PARTICLES, 3), generator=gen, device=dev)
        states = SE2.from_xytheta(xyt[..., 0], xyt[..., 1], xyt[..., 2])
        points = torch.as_tensor(s.points).to(dev)[scan]
        mask = torch.as_tensor(s.mask).to(dev)[scan]
    else:
        s = workloads.ndt_scans(1)
        clouds, cmask = workloads.ndt_clouds(s)
        ndt_map = workloads.ndt_map_3d(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(16)
        states = sample_normal_se3(gen, 2000, SE3.from_xyzrpy(
            [s.xs[0], s.ys[0], 0.0], (0.0, 0.0, s.yaws[0]), device="cpu"),
            workloads.INITIAL_COV_3D)
        points, mask = torch.as_tensor(clouds[0]).to(dev), torch.as_tensor(cmask[0]).to(dev)
    means, covs, cell_mask = fit_measurement_cells(points, mask, ndt_map.resolution)
    rot, trans = pose_matrices(states)
    p = NdtModelParams()
    kernel = KERNEL_2D if ndt_map.dim == 2 else KERNEL_3D
    args = (ndt_map.keys, ndt_map.values, ndt_map.num_cells, ndt_map.resolution,
            rot.contiguous(), trans.contiguous(), means, covs, cell_mask, kernel,
            p.minimum_likelihood, p.d1, p.d2)
    lead = "x".join(str(v) for v in rot.shape[:-2])
    path = {"node": "NDT node", "fleet": "NDT fleet", "3d": "NDT-3D node",
            "bench": "ndt_fleet.track"}[which]
    return args, ndt_map.index, (f"{path}, {lead} particles x {cell_mask.shape[-1]} slots, "
                                 f"{ndt_map.num_cells} keys ({ndt_map.dim}D), K = {len(kernel)}")


def filters_of(args, filters: int) -> tuple:
    """The fused kernel's arguments of the first ``filters`` filters of a
    fleet: each filter's weights depend on its own poses and cells alone."""
    rot, trans, means, covs, cell_mask = args[4:9]
    return (*args[:4], rot[:filters], trans[:filters], means[:filters], covs[:filters],
            cell_mask[:filters], *args[9:])


def ndt_hits(args, chunk: int = 256) -> tuple[int, int]:
    """(hits, probes): the stencil probes of live cells that the fused
    kernel makes on these inputs, and how many find a map cell (the plain
    version's probe, over particle chunks)."""
    from beluga_tpu_torch.ops import cuda_ndt

    keys, values, m, res, rot, trans, means, covs, cell_mask, kernel = args[:10]

    def body(r, t):  # hits a particle
        mean_w, cov_w = cuda_ndt.world_gaussians(r, t, means, covs)
        _, found = cuda_ndt.probe_likelihood(keys, values, m, res, mean_w, cov_w, kernel, 1.0, 1.0)
        return torch.sum(found & cell_mask[..., None, :, None], dim=(-1, -2))

    hits = int(cuda_ndt.particle_chunks(rot, trans, chunk, body).sum())
    live = int(cell_mask.expand(*rot.shape[:-3], cell_mask.shape[-1]).sum())  # (filter, cell)
    return hits, live * rot.shape[-3] * len(kernel)


def check_ndt_weights(dev, iters: int, which: str) -> dict:
    """The fused NDT kernel at a main path's shape (``ndt_weights_inputs``),
    with the map's cell index as the model passes it, against its plain
    version (the chunked probe path through B10's plain version): every
    weight finite, two launches bit-equal and equal to the search of the
    sorted keys, every weight within ``NDT_RTOL``; no single library call
    computes the function.  At the benchmark's shape the plain version and
    the hit count take the first ``NDT_BENCH_CHECKED`` filters (the hits
    scaled to the fleet), and the plain version is not timed."""
    from beluga_tpu_torch.ops import cuda_ndt

    args, index, label = ndt_weights_inputs(dev, which)
    before = cuda_ndt.weights_indexed_launches
    got = cuda_ndt.ndt_weights(*args, index=index)
    again = cuda_ndt.ndt_weights(*args, index=index)
    indexed = cuda_ndt.weights_indexed_launches - before
    searched = cuda_ndt.ndt_weights(*args)
    bench = which == "bench"
    checked = filters_of(args, NDT_BENCH_CHECKED) if bench else args
    want = cuda_ndt.ndt_weights_reference(*checked)
    torch.cuda.synchronize()
    check(indexed == 2, f"NDT weights {label}: {indexed} of 2 launches by the cell index")
    check(bool(torch.isfinite(got).all()), f"NDT weights {label}: weights not finite")
    check(torch.equal(got, again), f"NDT weights {label}: two launches differ")
    check(torch.equal(got, searched), f"NDT weights {label}: the index and the search differ")
    got_checked = got[:NDT_BENCH_CHECKED] if bench else got
    rel = ((got_checked - want).abs() / want.abs()).reshape(-1)
    outside = float((rel > NDT_RTOL).float().mean())
    check(outside == 0.0,
          f"NDT weights {label}: {outside:.2e} of the particles beyond rtol {NDT_RTOL} "
          f"(max {float(rel.max()):.2e})")
    m, rot, cell_mask, kernel = args[2], args[4], args[8], args[9]
    if bench:  # the hits of the first filters, scaled to the fleet
        part, part_probes = ndt_hits(filters_of(args, NDT_BENCH_HITS), chunk=64)
        live_all = int(cell_mask.sum()) * rot.shape[-3] * len(kernel)
        hits, probes = round(part * live_all / part_probes), live_all
    else:
        hits, probes = ndt_hits(args)
    live = int(cell_mask.sum()) // max(math.prod(cell_mask.shape[:-1]), 1)  # a filter
    check(0 < hits < probes, f"NDT weights {label}: {hits} hits of {probes} probes")
    times = timings(lambda: cuda_ndt.ndt_weights(*args, index=index),
                    None if bench else lambda: cuda_ndt.ndt_weights_reference(*args), iters,
                    plain_iters=3)
    # the kernel's own device time: the median launch the profiler recorded
    launch_device_ms(times, lambda: cuda_ndt.ndt_weights(*args, index=index),
                     "ndt_weights_kernel")
    search = {}
    launch_device_ms(search, lambda: cuda_ndt.ndt_weights(*args), "ndt_weights_kernel")
    times["search_ms"] = cuda_ms(lambda: cuda_ndt.ndt_weights(*args), iters)
    times["search_device_ms"] = search["device_ms"]
    if which == "node":
        check(times["device_ms"] is None or times["device_ms"] <= NDT_NODE_DEVICE_MS,
              f"NDT weights {label}: {times['device_ms']} device ms, above "
              f"{NDT_NODE_DEVICE_MS}")
    d, k, n = rot.shape[-1], len(kernel), rot.shape[:-2].numel()
    p = d + d * d
    cells = probes // k  # (particle, live cell) pairs
    ops = NDT_CELL_OPS[d] * cells + NDT_PROBE_OPS * probes + NDT_HIT_OPS[d] * hits
    nbytes = (n * 4 * (d * d + d + 1) + cell_mask.numel() * (4 * p + 1) + m * (4 + 4 * p))
    bms, by = bound_ms(nbytes, ops)
    return dict(
        name="B10-fused ndt_weights", route="cuda", source="beluga_tpu_torch/csrc/ndt_weights.cu",
        replaces="beluga_tpu/ops/pallas_ndt.py:48",
        max_abs_err=float((got_checked - want).abs().max()), max_rel_err=float(rel.max()),
        outside_rtol_share=outside, live_cells=live, hit_share=hits / probes,
        probe="cell index" if index is not None else "search",
        index_box=None if index is None else list(index.size),
        bound_ms=bms, bound_by=by, shape=label, **times,
    )


def building_floor(dev):
    """The 200 x 200 x 50-voxel building floor of ``maps/voxel.py:6-8`` at
    0.1 m: a floor slab, outer walls, interior walls with door gaps and a
    row of pillars, 2 m background."""
    from beluga_tpu_torch.maps.voxel import make_distance_grid

    occ = np.zeros((50, 200, 200), bool)
    occ[0] = True
    occ[:, [0, -1], :] = occ[:, :, [0, -1]] = True
    for x in (60, 130):
        occ[:, :, x] = True
        occ[:21, 90:100, x] = False  # doors
    occ[:, 100, :] = True
    occ[:21, 100, 30:40] = occ[:21, 100, 160:170] = False
    for y in range(20, 200, 40):
        occ[:, y:y + 3, 95:98] = True
    return make_distance_grid(occ, 0.1, max_distance=2.0, device=dev)


def check_codebook_lookup(dev, iters: int, volume: str) -> dict:
    """Kernel B11 at the VDB filter's 131072 x 80 queries, on the bench
    volume (the queries of the filter's initial cloud) or on the building
    floor (uniform points in the volume), bit-equal to its plain version
    and timed beside a gather of the float volume (``values[z, y, x]``,
    the same function where the codebook is exact)."""
    from beluga_tpu_torch.lie import SO3
    from beluga_tpu_torch.maps.voxel import make_distance_codes
    from beluga_tpu_torch.ops import cuda_codebook as b11
    from beluga_tpu_torch.tools import workloads

    n, p = workloads.VDB_N, workloads.VDB_POINTS
    if volume == "bench":
        w = workloads.vdb_filter(1, dev)
        grid, (codes, book) = w.ctx["vdb_grid"], w.ctx["vdb_codes"]
        st = w.state.particles.state
        world = SO3(st.rot.q[:, None, :]).act(w.points[None]) + st.xyz[:, None, :]
    else:
        grid = building_floor(dev)
        codes, book = make_distance_codes(grid, 0.1, 2.0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(11)
        world = torch.rand((n, p, 3), generator=gen, device=dev) * torch.tensor(
            [20.4, 20.4, 5.4], device=dev) - 0.2
    idx = grid.voxel_index(world)
    d, h, wd = grid.values.shape
    x, y, z = (torch.clamp(idx[..., i], 0, lim - 1) for i, lim in enumerate((wd, h, d)))
    yi, xi = y.contiguous(), (z * wd + x).contiguous()
    got = b11.codebook_lookup(codes, book, yi, xi)
    want = b11.codebook_lookup_reference(codes, book, yi, xi)
    torch.cuda.synchronize()
    label = (f"{n}x{p} queries, codes [{codes.shape[0]}, {codes.shape[1]}] "
             f"({'shared memory' if codes.numel() + 1024 <= 200 * 1024 else 'global memory'})")
    check(torch.equal(got, want), f"B11 {label}: {int((got != want).sum())} values differ")
    exact = bool(torch.equal(got, grid.values[z.long(), y.long(), x.long()]))
    zl, yl, xl = z.long(), y.long(), x.long()
    times = timings(lambda: b11.codebook_lookup(codes, book, yi, xi),
                    lambda: b11.codebook_lookup_reference(codes, book, yi, xi), iters,
                    library=lambda: grid.values[zl, yl, xl])
    bms, by = bound_ms(12 * yi.numel() + codes.numel() + 4 * book.numel(), 0)
    return dict(
        name="B11 codebook_lookup", route="cuda", source="beluga_tpu_torch/csrc/codebook_lookup.cu",
        replaces="beluga_tpu/ops/pallas_lookup.py:82", max_abs_err=float((got - want).abs().max()),
        codebook_exact=exact, bound_ms=bms, bound_by=by, shape=f"{volume}: {label}", **times,
    )


# -- phases 4 to 19: the main paths --------------------------------------------


def reset_counts() -> None:
    from beluga_tpu_torch.ops import (
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
        cuda_sort,
        cuda_winlut,
        raycast,
    )

    cuda_estimate.launches = 0
    cuda_sort.launches = 0
    cuda_ndt.launches = 0
    cuda_ndt.weights_launches = 0
    cuda_ndt.weights_indexed_launches = 0
    cuda_codebook.launches = 0
    cuda_reweight.launches = 0
    cuda_reweight.values3_launches = 0
    cuda_reweight.log_launches = 0
    cuda_reweight.values3_log_launches = 0
    cuda_reweight.states_launches = 0
    cuda_resample.launches = 0
    cuda_resample.tile_launches = 0
    cuda_resample.cdf_launches = 0
    cuda_resample.sum_launches = 0
    cuda_pool_take.launches = 0
    cuda_pool_take.draw_launches = 0
    cuda_winlut.launches = 0
    cuda_winlut.int8_launches = 0
    cuda_winlut.states_launches = 0
    cuda_winlut.int8_states_launches = 0
    cuda_winlut.coverage_launches = 0
    cuda_fused_step.launches = 0
    cuda_beam_lut.launches = 0
    cuda_beam_lut.origins_launches = 0
    cuda_beam.launches = 0
    raycast.launches = 0
    raycast.exact_launches = 0
    cuda_scan_lut.launches = 0


def read_counts() -> dict:
    from beluga_tpu_torch.ops import (
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
        cuda_sort,
        cuda_winlut,
        raycast,
    )

    return {"B1 fused_reweight": cuda_reweight.launches,
            "B1-log fused_reweight": cuda_reweight.log_launches,
            B2_SEARCH: cuda_resample.launches,
            B2_TILE: cuda_resample.tile_launches,
            RESAMPLES: cuda_resample.launches + cuda_resample.tile_launches,
            B2_CDF: cuda_resample.cdf_launches,
            RUNNING_SUM: cuda_resample.sum_launches,
            "B3 pool_take": cuda_pool_take.launches,
            "B3-draw pooled_free_cells": cuda_pool_take.draw_launches,
            "B4 fused_reweight values3": cuda_reweight.values3_launches,
            "B4-log fused_reweight values3": cuda_reweight.values3_log_launches,
            "B5 fused_propagate_winlut": cuda_fused_step.launches,
            "B6 winlut_lookup": cuda_winlut.launches,
            "B6-int8 winlut_lookup": cuda_winlut.int8_launches,
            "B6 winlut_lookup_states": cuda_winlut.states_launches,
            "B6-int8 winlut_lookup_states": cuda_winlut.int8_states_launches,
            "B6-coverage winlut_coverage_states": cuda_winlut.coverage_launches,
            "B7 beam_lut_windowed": cuda_beam_lut.launches,
            "B7-origins window_origins": cuda_beam_lut.origins_launches,
            "B8 sphere_trace_beam_weights": cuda_beam.launches,
            "B9 scan_lut_correlate": cuda_scan_lut.launches,
            "B10 ndt_probe": cuda_ndt.launches,
            "B10-fused ndt_weights": cuda_ndt.weights_launches,
            NDT_INDEXED: cuda_ndt.weights_indexed_launches,
            "B11 codebook_lookup": cuda_codebook.launches,
            "R1 cast_rays": raycast.launches,
            "R1-exact beam_weights": raycast.exact_launches,
            REWEIGHT_STATES: cuda_reweight.states_launches,
            ESTIMATE: cuda_estimate.launches,
            SORT: cuda_sort.launches}


class B2Cummax:
    """While active, counts the calls of ``torch.cummax`` and
    ``Tensor.cummax`` (each an ``aten::cummax``) made inside
    ``cuda_resample.resample_take``, B2's path from the weights to the donor
    rows, and inside the positions it searches (the sorted multinomial
    positions the update draws, and residual resampling's), and the calls
    of B2's path."""

    def _scopes(self):
        from beluga_tpu_torch.filters import amcl
        from beluga_tpu_torch.ops import cuda_resample

        return ((cuda_resample, "resample_take"), (cuda_resample, "residual_positions"),
                (amcl, "sorted_multinomial_positions"))

    def __enter__(self):
        self.calls, self.b2_calls, inside = 0, 0, [0]
        self._saved = [(torch, "cummax", torch.cummax),
                       (torch.Tensor, "cummax", torch.Tensor.cummax)]
        self._saved += [(mod, name, getattr(mod, name)) for mod, name in self._scopes()]

        def counted(fn):
            def inner(*args, **kwargs):
                self.calls += inside[0] > 0
                return fn(*args, **kwargs)
            return inner

        def scoped(fn, b2: bool):
            def inner(*args, **kwargs):
                inside[0] += 1
                self.b2_calls += b2
                try:
                    return fn(*args, **kwargs)
                finally:
                    inside[0] -= 1
            return inner

        for owner, name, fn in self._saved:
            setattr(owner, name, counted(fn) if name == "cummax"
                    else scoped(fn, name == "resample_take"))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


def no_cummax_on_b2(run, what: str, *args, **kwargs) -> tuple[dict, dict]:
    """``run(*args, **kwargs)`` with ``torch.cummax`` counted on B2's path
    (the CDF kernel, then the search) and in the sorted positions it
    searches (their running sum: B2's CDF kernel), which must call none;
    the path's calls and cummax calls go into the phase's result."""
    with B2Cummax() as cm:
        counts, out = run(*args, **kwargs)
    check(cm.b2_calls == counts[RESAMPLES],
          f"{what}: {cm.b2_calls} calls of B2's path for {counts[RESAMPLES]} launches")
    check(cm.calls == 0, f"{what}: aten::cummax called {cm.calls} times on B2's path")
    out.update(b2_path_calls=cm.b2_calls, b2_path_cummax_calls=cm.calls)
    return counts, out


def run_node(dev, scans: int = NODE_SCANS, what: str = "node",
             must_launch=("B1 fused_reweight", B2_TILE),
             scans_fn=None, forced: bool = False, **overrides) -> tuple[dict, dict]:
    """The node at nav2 defaults (``overrides`` of ``AmclNodeConfig``
    fields select the beam node or another motion model) for ``scans``
    scans of ``scans_fn`` (default the arena's circle); ``forced`` calls
    ``request_nomotion_update`` before each scan.  The launch counts cover
    the map load and every scan, and each kernel of ``must_launch`` must
    have been launched."""
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.tools import workloads

    s = (scans_fn or workloads.arena_scans)(scans)
    reset_counts()
    t0 = time.perf_counter()
    node = AmclNode(workloads.node_config(s, **overrides), seed=0, device=dev)
    node.set_map(make_grid(s.data, workloads.RES, device=dev))
    torch.cuda.synchronize()
    set_map_s = time.perf_counter() - t0
    times, worst_pos, worst_yaw, valid = [], 0.0, 0.0, 0
    for t in range(scans):
        t0 = time.perf_counter()
        if forced:
            node.request_nomotion_update()
        r = node.handle_scan((s.xs[t], s.ys[t], s.yaws[t]), s.points[t], s.mask[t])
        times.append(time.perf_counter() - t0)
        if not r.valid:
            continue
        valid += 1
        check(bool(np.isfinite(r.pose).all() and np.isfinite(r.covariance[:2, :2]).all()),
              f"{what} scan {t}: estimate not finite")
        e_pos = math.hypot(r.pose[0] - s.xs[t], r.pose[1] - s.ys[t])
        e_yaw = yaw_error(r.pose[2], s.yaws[t])
        worst_pos, worst_yaw = max(worst_pos, e_pos), max(worst_yaw, e_yaw)
        check(e_pos < GATE_POS_M and e_yaw < GATE_YAW_RAD,
              f"{what} scan {t}: error {e_pos:.3f} m / {math.degrees(e_yaw):.1f} deg")
    counts = read_counts()
    check(valid >= scans - 1, f"{what}: only {valid} valid updates of {scans}")
    for name in must_launch:
        check(counts[name] > 0, f"{what}: {name} was never launched")
    steady = sorted(times[2:])
    return counts, dict(
        scans=scans, valid=valid, set_map_s=set_map_s, worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw),
        ms_per_update_median=1e3 * steady[len(steady) // 2],
        ms_per_update_mean=1e3 * sum(steady) / len(steady),
        ms_first_update=1e3 * times[0],
        active_particles=int(node._state.particles.active),
    )


def run_large_filter(dev, n: int = LARGE_N, n_min: int = LARGE_MIN,
                     scans: int = LARGE_SCANS, resampling: str = "systematic",
                     sync_tail: int = 0, keep: dict | None = None) -> tuple[dict, dict]:
    """The large filter (``resampling`` its strategy); its last
    ``sync_tail`` scans run with the waits on the stream listed (not
    timed).  With residual resampling B2 runs twice a resample.  ``keep``
    receives the last particle weights."""
    from beluga_tpu_torch.filters.amcl import host_pose, update
    from beluga_tpu_torch.tools import workloads

    what = "large filter" if resampling == "systematic" else f"large filter {resampling}"
    w = workloads.large_filter(scans, dev, n, n_min, resampling=resampling)
    s = w.scans
    box = {"state": w.state}
    reset_counts()
    times, worst, active = [], [0.0, 0.0], []

    def step(t: int) -> None:
        box["state"], est = update(w.params, w.models, w.ctx, box["state"],
                                   host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t],
                                   w.mask[t])
        pose = est.pose.as_xytheta().cpu().numpy()
        check(est.valid, f"{what} scan {t}: update gated out")
        check(bool(np.isfinite(pose).all()), f"{what} scan {t}: estimate not finite")
        e_pos = math.hypot(pose[0] - s.xs[t], pose[1] - s.ys[t])
        e_yaw = yaw_error(float(pose[2]), s.yaws[t])
        worst[0], worst[1] = max(worst[0], e_pos), max(worst[1], e_yaw)
        check(e_pos < GATE_POS_M and e_yaw < GATE_YAW_RAD,
              f"{what} scan {t}: error {e_pos:.3f} m / {math.degrees(e_yaw):.1f} deg")
        active.append(int(box["state"].particles.active))

    for t in range(scans - sync_tail):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(t)
        times.append(time.perf_counter() - t0)
    sites = sync_sites(step, scans - sync_tail, scans) if sync_tail else None
    counts = read_counts()
    for name in ("B1 fused_reweight", b2_entry(n), POOL_DRAW):
        check(counts[name] > 0, f"{what}: {name} was never launched")
    steady = times[2:]
    mean_s = sum(steady) / len(steady)
    out = dict(particles=n, scans=scans, resampling=resampling, worst_pos_m=worst[0],
               worst_yaw_deg=math.degrees(worst[1]), ms_per_update_mean=1e3 * mean_s,
               particle_updates_per_s=n / mean_s, active_last=active[-1])
    sums = scans if resampling == "residual" else 0  # systematic draws no sorted positions
    check(counts[RUNNING_SUM] == sums,
          f"{what}: {RUNNING_SUM} launched {counts[RUNNING_SUM]} times in {scans} resamples")
    if resampling == "residual":
        check(counts[RESAMPLES] == 2 * scans,
              f"{what}: B2 launched {counts[RESAMPLES]} times in {scans} resamples")
        out.update(sync_sites=sites)
    if keep is not None:
        keep["weights"] = box["state"].particles.weight
    return counts, out


def residual_floor_check(weights: torch.Tensor, what: str) -> int:
    """Resample ``weights`` ``[..., N]`` once through the two passes with an
    identity payload: every particle appears at least ``floor(N·w)`` times,
    no zero-weight one appears, each filter gets N donors; returns the
    least slack (copies beyond the floor)."""
    from beluga_tpu_torch.ops.cuda_resample import resample_take_tree_residual

    n = weights.shape[-1]
    lead = tuple(weights.shape[:-1])
    gen = torch.Generator(device=weights.device)
    gen.manual_seed(11)
    u = torch.rand((*lead, n + 1), generator=gen, device=weights.device)
    ident = torch.arange(n, dtype=torch.float32, device=weights.device).expand(*lead, n)
    donors = resample_take_tree_residual(weights, ident.contiguous(), u).long()
    floor = torch.floor(weights / weights.sum(-1, keepdim=True) * n).long()
    copies = torch.zeros((*lead, n), dtype=torch.long, device=weights.device)
    copies.scatter_add_(-1, donors, torch.ones_like(donors))
    slack = copies - floor
    check(bool((slack >= 0).all()), f"{what}: a particle below its floor(M·w) copies")
    check(bool((copies[weights == 0] == 0).all()), f"{what}: a zero-weight particle drawn")
    return int(slack.min())


def fleet_errors(pose: np.ndarray, s, t: int, what: str, filters=slice(None)):
    """Position and heading errors ``[b]`` of a fleet's estimates at scan
    ``t``; the ``filters`` chosen must lie within the gate."""
    e_pos = np.hypot(pose[:, 0] - s.xs[t], pose[:, 1] - s.ys[t])
    e_yaw = np.abs(np.arctan2(np.sin(pose[:, 2] - s.yaws[t]), np.cos(pose[:, 2] - s.yaws[t])))
    check(bool(np.isfinite(pose).all()), f"{what} scan {t}: estimate not finite")
    check(bool((e_pos[filters] < GATE_POS_M).all() and (e_yaw[filters] < GATE_YAW_RAD).all()),
          f"{what} scan {t}: worst filter {e_pos[filters].max():.3f} m / "
          f"{math.degrees(e_yaw[filters].max()):.1f} deg")
    return e_pos, e_yaw


def run_fleet(dev, b: int = FLEET_B, n: int = FLEET_N, scans: int = FLEET_SCANS,
              prob_model: bool = False, resampling: str = "multinomial",
              sync_tail: int = 0, keep: dict | None = None) -> tuple[dict, dict]:
    """The JAX benchmark's fleet (bench.py:46-49, :180-220): B filters of N
    particles, codebook16, theta-sorted slots, fixed count, multinomial
    resampling, pooled recovery; every filter scores the same scan.  With
    ``prob_model`` the fleet scores the probability model through B4-log;
    with ``resampling="residual"`` each resample is two launches of B2.
    The last ``sync_tail`` scans run with the waits on the stream listed
    (not timed); ``keep`` receives the last particle weights."""
    from beluga_tpu_torch.parallel.fleet import make_fleet_update
    from beluga_tpu_torch.tools import workloads

    what = ("prob fleet" if prob_model else "fleet") + (
        "" if resampling == "multinomial" else f" {resampling}")
    reweight = "B4-log fused_reweight values3" if prob_model else "B4 fused_reweight values3"
    w = workloads.fleet(scans, dev, b, n, prob_model=prob_model, resampling=resampling)
    s = w.scans
    box = {"state": w.state}
    fleet_update = make_fleet_update(w.params, w.models)
    reset_counts()
    times, worst = [], [0.0, 0.0]

    def step(t: int) -> None:
        odoms = workloads.fleet_odometry(s, t, b)
        box["state"], est = fleet_update(w.ctx, box["state"], odoms, w.points[t], w.mask[t])
        pose = est.pose.as_xytheta().cpu().numpy()  # [b, 3], the one readback
        check(bool(np.all(est.valid)), f"{what} scan {t}: a filter was gated out")
        e_pos, e_yaw = fleet_errors(pose, s, t, what)
        worst[0], worst[1] = max(worst[0], float(e_pos.max())), max(worst[1], float(e_yaw.max()))

    for t in range(scans - sync_tail):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(t)
        times.append(time.perf_counter() - t0)
    sites = sync_sites(step, scans - sync_tail, scans) if sync_tail else None
    worst_pos, worst_yaw = worst
    counts = read_counts()
    passes = 2 if resampling == "residual" else 1
    for name, per_update in ((b2_entry(n), passes), (POOL_DRAW, 1), (reweight, 1),
                             (RUNNING_SUM, 1), (ESTIMATE, 1), (SORT, 1)):
        check(counts[name] == scans * per_update,
              f"{what}: {name} launched {counts[name]} times in {scans} updates")
    others = {"B1 fused_reweight", "B1-log fused_reweight", "B4 fused_reweight values3",
              "B4-log fused_reweight values3"} - {reweight}
    for name in sorted(others):
        check(counts[name] == 0, f"{what}: {name} launched {counts[name]} times")
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    out = dict(
        filters=b, particles=n, scans=scans, worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw), ms_per_update_mean=1e3 * mean_s,
        ms_per_update_median=1e3 * steady[len(steady) // 2],
        ms_first_update=1e3 * times[0], particle_updates_per_s=b * n / mean_s,
    )
    if resampling == "residual":
        out.update(sync_sites=sites)
    if keep is not None:
        keep["weights"] = box["state"].particles.weight
    return counts, out


def run_forced(w, scans: int, what: str, sort_every: int | None = None):
    """Step a single filter with ``force_update`` on every scan (and
    ``sort_now`` on every ``sort_every``-th): the gate on every scan, the
    launch counts, wall times and errors."""
    from beluga_tpu_torch.filters.amcl import host_pose, update

    s, state = w.scans, w.state
    reset_counts()
    times, errs, yaws, builds = [], [], [], []
    for t in range(scans):
        sort_now = None if sort_every is None else t % sort_every == 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx = w.ctx
        if w.prepare is not None:  # the shared-scan LUT, rebuilt for every scan
            ctx = w.prepare(ctx, w.points[t], w.mask[t])
            torch.cuda.synchronize()
            builds.append(time.perf_counter() - t0)
        state, est = update(w.params, w.models, ctx, state._replace(force_update=True),
                            host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t],
                            sort_now=sort_now)
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(est.valid, f"{what} scan {t}: update gated out")
        check(bool(np.isfinite(pose).all()), f"{what} scan {t}: estimate not finite")
        errs.append(math.hypot(pose[0] - s.xs[t], pose[1] - s.ys[t]))
        yaws.append(yaw_error(float(pose[2]), s.yaws[t]))
        check(errs[-1] < GATE_POS_M and yaws[-1] < GATE_YAW_RAD,
              f"{what} scan {t}: error {errs[-1]:.3f} m / {math.degrees(yaws[-1]):.1f} deg")
    counts = read_counts()
    n = w.params.max_particles
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    out = dict(
        particles=n, scans=scans, err_mean_m=float(np.mean(errs)), err_max_m=max(errs),
        worst_yaw_deg=math.degrees(max(yaws)), ms_per_update_mean=1e3 * mean_s,
        ms_per_update_median=1e3 * steady[len(steady) // 2], ms_first_update=1e3 * times[0],
        particle_updates_per_s=n / mean_s,
    )
    if builds:
        out.update(lut_build_ms_mean=1e3 * sum(builds[2:]) / len(builds[2:]),
                   lut_build_share=sum(builds[2:]) / sum(times[2:]))
    return counts, errs, out


def run_mega(dev, scans: int = MEGA_SCANS, n: int | None = None) -> tuple[dict, dict]:
    """The JAX benchmark's headline mega filter (bench.py:247-386)."""
    from beluga_tpu_torch.tools import workloads

    w = workloads.mega(scans, dev, **({} if n is None else {"n": n}))
    counts, errs, out = run_forced(w, scans, "mega", workloads.MEGA_SORT_EVERY)
    last = errs[-MEGA_LAST:]
    out.update(err_mean_last_m=float(np.mean(last)), err_max_last_m=max(last))
    check(max(last) <= MEGA_LAST_GATE_M,
          f"mega: max error {max(last):.3f} m over the last {MEGA_LAST} scans > "
          f"{MEGA_LAST_GATE_M} m")
    for name in ("B5 fused_propagate_winlut", ESTIMATE):
        check(counts[name] == scans,
              f"mega: {name} launched {counts[name]} times in {scans} updates")
    for name in ("B1 fused_reweight", "B4 fused_reweight values3", WINLUT_STATES["bf16"],
                 WINLUT_COVERAGE):
        check(counts[name] == 0, f"mega: {name} launched {counts[name]} times")
    return counts, out


def run_windowed(dev, scans: int = WINDOWED_SCANS,
                 table_dtype: str = "bf16") -> tuple[dict, dict]:
    """The coverage-gated windowed filter (bench.py:880-900) on bf16 window
    tables (B6) or int8 ones (B6-int8): the gate one launch of B6's
    coverage entry every update, the lookup through B6's states entry at
    least once, B1 on every update (the exact tail, or the fallback), the
    other table type's lookup never."""
    from beluga_tpu_torch.tools import workloads

    what = "windowed" if table_dtype == "bf16" else f"windowed {table_dtype}"
    lookup = WINLUT_STATES[table_dtype]
    other = WINLUT_STATES["int8" if table_dtype == "bf16" else "bf16"]
    w = workloads.windowed(scans, dev, table_dtype=table_dtype)
    counts, _, out = run_forced(w, scans, what)
    fast = counts[lookup]
    check(fast >= 1, f"{what}: {lookup} was never launched")
    check(counts[other] == 0, f"{what}: {other} launched {counts[other]} times")
    check(counts[WINLUT_COVERAGE] == scans,
          f"{what}: the gate launched {WINLUT_COVERAGE} {counts[WINLUT_COVERAGE]} times in "
          f"{scans} updates")
    check(counts["B1 fused_reweight"] == scans,
          f"{what}: B1 launched {counts['B1 fused_reweight']} times in {scans} updates")
    out.update(fast_updates=fast, exact_updates=scans - fast)
    return counts, out


def run_shared_scan(dev, scans: int = SHARED_SCAN_SCANS) -> tuple[dict, dict]:
    """The shared-scan filter (bench.py:916-955), the LUT rebuilt for every
    scan: every scan within the gate, B9 once per update, B1 and B4 (either
    mode) never."""
    from beluga_tpu_torch.tools import workloads

    w = workloads.shared_scan(scans, dev)
    counts, _, out = run_forced(w, scans, "shared scan")
    check(counts["B9 scan_lut_correlate"] == scans,
          f"shared scan: B9 launched {counts['B9 scan_lut_correlate']} times in {scans} updates")
    for name in ("B1 fused_reweight", "B1-log fused_reweight", "B4 fused_reweight values3",
                 "B4-log fused_reweight values3"):
        check(counts[name] == 0, f"shared scan: {name} launched {counts[name]} times")
    return counts, out


def run_prob_node(dev) -> tuple[dict, dict]:
    """The node with nav2's probability model (laser_model_type
    likelihood_field_prob) at nav2 defaults: B1-log on every update, the
    cube B1 never."""
    counts, out = run_node(dev, NODE_SCANS, "prob node",
                           ("B1-log fused_reweight", B2_TILE),
                           laser_model_type="likelihood_field_prob")
    check(counts["B1-log fused_reweight"] == out["valid"],
          f"prob node: B1-log launched {counts['B1-log fused_reweight']} times in "
          f"{out['valid']} updates")
    check(counts["B1 fused_reweight"] == 0,
          f"prob node: B1 launched {counts['B1 fused_reweight']} times")
    return counts, out


def run_beam_node(dev, mode: str) -> tuple[dict, dict]:
    """The beam node at nav2 defaults (100 m) in ``beam_fast_path=mode``."""
    counts, out = run_node(dev, BEAM_NODE_SCANS, f"beam node {mode}", (B2_TILE,),
                           laser_model_type="beam", beam_fast_path=mode)
    updates = out["valid"]
    expected = {  # launches of each beam kernel: the map load and every update
        "exact": {"R1-exact beam_weights": updates, "R1 cast_rays": 0,
                  "B7 beam_lut_windowed": 0, "B8 sphere_trace_beam_weights": 0},
        "lut": {"R1-exact beam_weights": 0, "R1 cast_rays": 1, "B7 beam_lut_windowed": 0,
                "B8 sphere_trace_beam_weights": 0},
        "windowed": {"R1-exact beam_weights": 0, "R1 cast_rays": 1,
                     "B7 beam_lut_windowed": updates, "B8 sphere_trace_beam_weights": 0},
        "sphere_trace": {"R1-exact beam_weights": 0, "R1 cast_rays": 0,
                         "B7 beam_lut_windowed": 0, "B8 sphere_trace_beam_weights": updates},
    }[mode]
    # B7's window origins: its own kernel, once per B7 launch
    expected["B7-origins window_origins"] = expected["B7 beam_lut_windowed"]
    for name, want in {**expected, "B1 fused_reweight": 0}.items():
        check(counts[name] == want,
              f"beam node {mode}: {name} launched {counts[name]} times, expected {want}")
    return counts, out


def run_long_range(dev, scans: int = LONG_RANGE_SCANS) -> tuple[dict, dict]:
    """The long-range sphere-trace filter (benchmarks/REPORT.md:175-185):
    every scan after the warm-up within the gate, B8 once per update."""
    from beluga_tpu_torch.filters.amcl import host_pose, update
    from beluga_tpu_torch.tools import workloads

    w = workloads.long_range(scans, dev)
    s, state = w.scans, w.state
    reset_counts()
    times, errs, yaws = [], [], []
    for t in range(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = update(w.params, w.models, w.ctx, state._replace(force_update=True),
                            host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t])
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(est.valid, f"long range scan {t}: update gated out")
        check(bool(np.isfinite(pose).all()), f"long range scan {t}: estimate not finite")
        errs.append(math.hypot(pose[0] - s.xs[t], pose[1] - s.ys[t]))
        yaws.append(yaw_error(float(pose[2]), s.yaws[t]))
        if t >= LONG_RANGE_WARMUP:
            check(errs[-1] < GATE_POS_M and yaws[-1] < GATE_YAW_RAD,
                  f"long range scan {t}: error {errs[-1]:.3f} m / "
                  f"{math.degrees(yaws[-1]):.1f} deg")
    counts = read_counts()
    check(counts["B8 sphere_trace_beam_weights"] == scans,
          f"long range: B8 launched {counts['B8 sphere_trace_beam_weights']} times in "
          f"{scans} updates")
    for name in ("B1 fused_reweight", "R1 cast_rays", "B7 beam_lut_windowed",
                 "B7-origins window_origins"):
        check(counts[name] == 0, f"long range: {name} launched {counts[name]} times")
    hits = s.mask[LONG_RANGE_WARMUP:]
    ranges = np.hypot(s.points[..., 0], s.points[..., 1])[LONG_RANGE_WARMUP:][hits]
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    gated = errs[LONG_RANGE_WARMUP:]
    return counts, dict(
        particles=w.params.max_particles, scans=scans, err_mean_m=float(np.mean(gated)),
        err_max_m=max(gated), worst_yaw_deg=math.degrees(max(yaws[LONG_RANGE_WARMUP:])),
        mean_hit_range_m=float(ranges.mean()), ms_per_update_mean=1e3 * mean_s,
        ms_per_update_median=1e3 * steady[len(steady) // 2], ms_first_update=1e3 * times[0],
        particle_updates_per_s=w.params.max_particles / mean_s,
    )


def run_beam_fleet(dev, b: int = FLEET_B, n: int = FLEET_N,
                   scans: int = BEAM_FLEET_SCANS) -> tuple[dict, dict]:
    """The windowed beam fleet (bench.py:678-720): every filter within the
    gate, B7 once per update, B1 and B4 never, R1 in the LUT build."""
    from beluga_tpu_torch.parallel.fleet import make_fleet_update
    from beluga_tpu_torch.tools import workloads

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = workloads.beam_fleet(scans, dev, b, n)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    s, state = w.scans, w.state
    fleet_update = make_fleet_update(w.params, w.models)
    times, worst_pos, worst_yaw = [], 0.0, 0.0
    for t in range(scans):
        odoms = workloads.fleet_odometry(s, t, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = fleet_update(w.ctx, state, odoms, w.points[t], w.mask[t])
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(bool(np.all(est.valid)), f"beam fleet scan {t}: a filter was gated out")
        check(bool(np.isfinite(pose).all()), f"beam fleet scan {t}: estimate not finite")
        e_pos = np.hypot(pose[:, 0] - s.xs[t], pose[:, 1] - s.ys[t])
        e_yaw = np.abs(np.arctan2(np.sin(pose[:, 2] - s.yaws[t]), np.cos(pose[:, 2] - s.yaws[t])))
        worst_pos, worst_yaw = max(worst_pos, float(e_pos.max())), max(worst_yaw, float(e_yaw.max()))
        check(bool((e_pos < GATE_POS_M).all() and (e_yaw < GATE_YAW_RAD).all()),
              f"beam fleet scan {t}: worst filter {e_pos.max():.3f} m / "
              f"{math.degrees(e_yaw.max()):.1f} deg")
    counts = read_counts()
    for name in ("B7 beam_lut_windowed", "B7-origins window_origins"):
        check(counts[name] == scans,
              f"beam fleet: {name} launched {counts[name]} times in {scans} updates")
    check(counts["R1 cast_rays"] >= 1, "beam fleet: R1 was not launched by the LUT build")
    for name in ("B1 fused_reweight", "B4 fused_reweight values3"):
        check(counts[name] == 0, f"beam fleet: {name} launched {counts[name]} times")
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    return counts, dict(
        filters=b, particles=n, scans=scans, lut_build_s=build_s, worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw), ms_per_update_mean=1e3 * mean_s,
        ms_per_update_median=1e3 * steady[len(steady) // 2], ms_first_update=1e3 * times[0],
        particle_updates_per_s=b * n / mean_s,
    )


def check_ndt_launches(counts: dict, updates: int, what: str) -> None:
    """The NDT paths weigh through the fused kernel, once per update, by
    their map's cell index, and never through the standalone probe."""
    fused = counts["B10-fused ndt_weights"]
    check(fused == updates, f"{what}: the fused NDT kernel launched {fused} times in "
          f"{updates} updates")
    check(counts[NDT_INDEXED] == fused,
          f"{what}: {counts[NDT_INDEXED]} of {fused} fused launches by the cell index")
    check(counts["B10 ndt_probe"] == 0,
          f"{what}: B10 launched {counts['B10 ndt_probe']} times")


def run_ndt_node(dev, scans: int = NDT_NODE_SCANS) -> tuple[dict, dict]:
    """``NdtAmclNode`` at nav2 defaults on the 2D NDT map: every valid
    estimate within the gate, the fused NDT kernel once per update and B10
    never."""
    from beluga_tpu_torch.models.sensor.ndt import fit_measurement_cells
    from beluga_tpu_torch.ndt_node import NdtAmclNode
    from beluga_tpu_torch.tools import workloads

    s = workloads.ndt_scans(scans)
    reset_counts()
    node = NdtAmclNode(workloads.node_config(s), seed=0, device=dev)
    node.set_map(workloads.ndt_map_2d(dev))
    live = [int(fit_measurement_cells(torch.as_tensor(s.points[t]), torch.as_tensor(s.mask[t]),
                                      workloads.NDT_CELL_2D)[2].sum()) for t in range(scans)]
    times, worst_pos, worst_yaw, valid = [], 0.0, 0.0, 0
    for t in range(scans):
        t0 = time.perf_counter()
        r = node.handle_point_cloud((s.xs[t], s.ys[t], s.yaws[t]), s.points[t], s.mask[t])
        times.append(time.perf_counter() - t0)
        if not r.valid:
            continue
        valid += 1
        check(bool(np.isfinite(r.pose).all()), f"NDT node scan {t}: estimate not finite")
        e_pos = math.hypot(r.pose[0] - s.xs[t], r.pose[1] - s.ys[t])
        e_yaw = yaw_error(r.pose[2], s.yaws[t])
        worst_pos, worst_yaw = max(worst_pos, e_pos), max(worst_yaw, e_yaw)
        check(e_pos < GATE_POS_M and e_yaw < GATE_YAW_RAD,
              f"NDT node scan {t}: error {e_pos:.3f} m / {math.degrees(e_yaw):.1f} deg")
    counts = read_counts()
    check(valid >= scans - 1, f"NDT node: only {valid} valid updates of {scans}")
    check_ndt_launches(counts, valid, "NDT node")
    check(counts[RESAMPLES] > 0, "NDT node: B2 was never launched")
    steady = sorted(times[2:])
    return counts, dict(
        scans=scans, valid=valid, live_cells_mean=float(np.mean(live)), worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw), ms_per_update_median=1e3 * steady[len(steady) // 2],
        ms_per_update_mean=1e3 * sum(steady) / len(steady), ms_first_update=1e3 * times[0],
        particle_updates_per_s=node.params.max_particles * len(steady) / sum(steady),
        active_particles=int(node._state.particles.active),
    )


def run_ndt_fleet(dev, b: int = FLEET_B, n: int = FLEET_N,
                  scans: int = NDT_FLEET_SCANS) -> tuple[dict, dict]:
    """The NDT fleet (bench.py:780-837): forced updates at the truth, every
    filter within the gate at every scan, the fused NDT kernel once per
    update and B10 never."""
    from beluga_tpu_torch.models.sensor.ndt import fit_measurement_cells
    from beluga_tpu_torch.parallel.fleet import make_fleet_update
    from beluga_tpu_torch.tools import workloads

    w = workloads.ndt_fleet(scans, dev, b, n)
    s, state = w.scans, w.state
    live = int(fit_measurement_cells(w.points[0], w.mask[0], workloads.NDT_CELL_2D)[2].sum())
    print(f"NDT fleet: {live} live measurement cells of {w.points.shape[1]} points")
    check(live >= 8, f"NDT fleet: only {live} live measurement cells")
    fleet_update = make_fleet_update(w.params, w.models)
    odoms = workloads.fleet_odometry(s, 0, b)
    reset_counts()
    times, worst_pos, worst_yaw = [], 0.0, 0.0
    for t in range(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = fleet_update(w.ctx, state._replace(force_update=np.ones(b, bool)), odoms,
                                  w.points, w.mask)
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(bool(np.all(est.valid)), f"NDT fleet scan {t}: a filter was gated out")
        check(bool(np.isfinite(pose).all()), f"NDT fleet scan {t}: estimate not finite")
        e_pos = np.hypot(pose[:, 0] - s.xs[0], pose[:, 1] - s.ys[0])
        e_yaw = np.abs(np.arctan2(np.sin(pose[:, 2] - s.yaws[0]), np.cos(pose[:, 2] - s.yaws[0])))
        worst_pos, worst_yaw = max(worst_pos, float(e_pos.max())), max(worst_yaw, float(e_yaw.max()))
        check(bool((e_pos < GATE_POS_M).all() and (e_yaw < GATE_YAW_RAD).all()),
              f"NDT fleet scan {t}: worst filter {e_pos.max():.3f} m / "
              f"{math.degrees(e_yaw.max()):.1f} deg")
    counts = read_counts()
    check_ndt_launches(counts, scans, "NDT fleet")
    check(counts[RESAMPLES] == scans,
          f"NDT fleet: B2 launched {counts[RESAMPLES]} times in {scans} updates")
    check(counts[ESTIMATE] == scans + counts[RESAMPLES],
          f"NDT fleet: E1 launched {counts[ESTIMATE]} times in {scans} updates (the estimate "
          f"and the recovery's at each of {counts[RESAMPLES]} resamples)")
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    return counts, dict(
        filters=b, particles=n, scans=scans, live_cells=live, worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw), ms_per_update_mean=1e3 * mean_s,
        ms_per_update_median=1e3 * steady[len(steady) // 2], ms_first_update=1e3 * times[0],
        particle_updates_per_s=b * n / mean_s,
    )


def run_ndt3d_node(dev, scans: int = NDT3D_SCANS) -> tuple[dict, dict]:
    """``NdtAmclNode3D`` at nav2 defaults on the 3D NDT map, 3600-point
    clouds: every valid estimate within the gate on x, y and yaw, the fused
    NDT kernel once per update and B10 never."""
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.ndt_node import NdtAmclNode3D
    from beluga_tpu_torch.tools import workloads

    s = workloads.ndt_scans(scans)
    clouds, cmask = workloads.ndt_clouds(s)
    reset_counts()
    node = NdtAmclNode3D(AmclNodeConfig(), seed=0, device=dev)
    node.set_map(workloads.ndt_map_3d(dev))
    node.set_initial_pose((s.xs[0], s.ys[0], 0.0), (0.0, 0.0, s.yaws[0]),
                          workloads.INITIAL_COV_3D)
    times, worst_pos, worst_yaw, valid = [], 0.0, 0.0, 0
    for t in range(scans):
        t0 = time.perf_counter()
        r = node.handle_point_cloud((s.xs[t], s.ys[t], 0.0, 0.0, 0.0, s.yaws[t]), clouds[t],
                                    cmask[t])
        times.append(time.perf_counter() - t0)
        if not r.valid:
            continue
        valid += 1
        check(bool(np.isfinite(r.pose).all()), f"NDT-3D node scan {t}: estimate not finite")
        e_pos = math.hypot(r.pose[0] - s.xs[t], r.pose[1] - s.ys[t])
        e_yaw = yaw_error(r.pose[5], s.yaws[t])
        worst_pos, worst_yaw = max(worst_pos, e_pos), max(worst_yaw, e_yaw)
        check(e_pos < GATE_POS_M and e_yaw < GATE_YAW_RAD,
              f"NDT-3D node scan {t}: error {e_pos:.3f} m / {math.degrees(e_yaw):.1f} deg")
    counts = read_counts()
    check(valid >= scans - 1, f"NDT-3D node: only {valid} valid updates of {scans}")
    check_ndt_launches(counts, valid, "NDT-3D node")
    steady = sorted(times[2:])
    return counts, dict(
        scans=scans, valid=valid, points=int(clouds.shape[1]), worst_pos_m=worst_pos,
        worst_yaw_deg=math.degrees(worst_yaw), ms_per_update_median=1e3 * steady[len(steady) // 2],
        ms_per_update_mean=1e3 * sum(steady) / len(steady), ms_first_update=1e3 * times[0],
        particle_updates_per_s=node.params.max_particles * len(steady) / sum(steady),
        active_particles=int(node._state.particles.active),
    )


def run_vdb(dev, scans: int = VDB_SCANS) -> tuple[dict, dict]:
    """BASELINE config #4 (bench.py:722-778): forced updates at the
    identity odometry, each within 0.9 m / 30 degrees of (3, 3, 0, yaw
    0.3), B11 once per update."""
    from beluga_tpu_torch.filters.amcl import update
    from beluga_tpu_torch.lie import SE3
    from beluga_tpu_torch.tools import workloads

    w = workloads.vdb_filter(scans, dev)
    state, truth = w.state, np.asarray(workloads.VDB_TRUTH)
    odom = SE3.identity()
    reset_counts()
    times, errs, yaws, active = [], [], [], []
    for t in range(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = update(w.params, w.models, w.ctx, state._replace(force_update=True), odom,
                            w.points, w.mask)
        xyz = est.pose.xyz.cpu().numpy()
        times.append(time.perf_counter() - t0)
        yaw = float(est.pose.rot.rpy()[2])
        check(est.valid, f"VDB scan {t}: update gated out")
        check(bool(np.isfinite(xyz).all()), f"VDB scan {t}: estimate not finite")
        errs.append(float(np.linalg.norm(xyz - truth[:3])))
        yaws.append(yaw_error(yaw, truth[5]))
        active.append(int(state.particles.active))
        check(errs[-1] < GATE_POS_M and yaws[-1] < GATE_YAW_RAD,
              f"VDB scan {t}: error {errs[-1]:.3f} m / {math.degrees(yaws[-1]):.1f} deg")
    counts = read_counts()
    check(counts["B11 codebook_lookup"] == scans,
          f"VDB: B11 launched {counts['B11 codebook_lookup']} times in {scans} updates")
    check(counts["B10 ndt_probe"] == 0 and counts["B10-fused ndt_weights"] == 0,
          f"VDB: B10 launched {counts['B10 ndt_probe']} times, the fused NDT kernel "
          f"{counts['B10-fused ndt_weights']}")
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    n = w.params.max_particles
    return counts, dict(
        particles=n, points=int(w.points.shape[0]), scans=scans,
        err_mean_m=float(np.mean(errs)), err_max_m=max(errs),
        worst_yaw_deg=math.degrees(max(yaws)), active_last=active[-1],
        ms_per_update_mean=1e3 * mean_s, ms_per_update_median=1e3 * steady[len(steady) // 2],
        ms_first_update=1e3 * times[0], particle_updates_per_s=n / mean_s,
    )


# -- phases 20 and 21: the node's raw input and the replay tools (slice 13) --------

RAW_SCANS, RAW_PROFILED, RAW_SYNC_CHECKED = 40, 16, 6
RECORD_STEPS = 60


def profiled_window(step, t0: int, t1: int) -> dict:
    """Scans ``t0`` to ``t1`` of ``step(t)`` under ``torch.profiler``: the
    device busy ms an update (the kernels' and copies' durations summed)
    and the kernel launches an update.  Busy is None where the profiler
    missed more than one in a hundred of the kernels the host launched (it
    at times records only part of a run's launches, more of them late in
    this script); how many it recorded is printed beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(t0, t1):
            step(t)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    launched = sum(e.name in LAUNCH_CALLS for e in events)
    seen = sum(not e.name.startswith(("Memcpy", "Memset")) for e in device)
    n = t1 - t0
    busy_ms = 1e-3 * sum(e.time_range.elapsed_us() for e in device) / n
    return dict(profiled_scans=n,
                device_busy_ms_per_update=busy_ms if seen >= launched - launched // 100 else None,
                launches_per_update=launched / n, kernels_recorded=f"{seen} of {launched}")


def sync_sites(step, t0: int, t1: int) -> dict:
    """Where scans ``t0`` to ``t1`` of ``step(t)`` made the host wait for
    the card: ``torch.cuda.set_sync_debug_mode("warn")`` turns each
    synchronizing call (a stream or device synchronize, a blocking copy)
    into a warning, counted here by the Python line that made it.  An
    event's ``synchronize`` is not such a call."""
    import warnings

    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for t in range(t0, t1):
                step(t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites: dict[str, int] = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, root)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def run_raw_node(dev, map_yaml: str, raw, mode: str, smi: str,
                 **overrides) -> tuple[dict, dict, dict]:
    """The nav2-default node on the arena loaded from PGM and YAML, fed the
    raw LDS-01 input: ``mode`` "sync" and "pipelined" through
    ``handle_laser_scan``, "cloud" through ``handle_point_cloud`` (the same
    returns as 3D points, synchronous).  RAW_SCANS scans on the host clock
    (ms an update, the first two left out), RAW_PROFILED more under the
    profiler (busy and launches; the idle share is 1 - busy / the host
    clock's mean, as ``tools/profile_update.py`` takes it, since the
    profiler slows the host), RAW_SYNC_CHECKED more with the syncs listed;
    every valid estimate within the gate.  ``overrides`` of the node's
    config fields (``max_particles=10000``: the sparse cluster estimate)
    name the run.  Returns the launch counts, the phase's numbers and the
    estimates by scan."""
    from beluga_tpu_torch.maps.occupancy import load_pgm_yaml
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.tools import workloads

    s = raw.scans
    what = f"raw node {mode}" + "".join(f" {k}={v}" for k, v in overrides.items())
    reset_counts()
    node = AmclNode(workloads.node_config(s, **overrides), seed=0, device=dev,
                    pipelined=mode == "pipelined")
    node.set_map(load_pgm_yaml(map_yaml, device=dev))
    estimates: dict[int, np.ndarray] = {}
    worst = [0.0, 0.0]

    def take(t: int, r) -> None:
        if not r.valid:
            return
        check(bool(np.isfinite(r.pose).all()), f"{what} scan {t}: estimate not finite")
        e_pos = math.hypot(r.pose[0] - s.xs[t], r.pose[1] - s.ys[t])
        e_yaw = yaw_error(r.pose[2], s.yaws[t])
        check(e_pos < GATE_POS_M and e_yaw < GATE_YAW_RAD,
              f"{what} scan {t}: error {e_pos:.3f} m / {math.degrees(e_yaw):.1f} deg")
        worst[0], worst[1] = max(worst[0], e_pos), max(worst[1], e_yaw)
        estimates[t] = r.pose

    def step(t: int) -> None:
        odom = (s.xs[t], s.ys[t], s.yaws[t])
        if mode == "cloud":
            r = node.handle_point_cloud(odom, raw.clouds[t])
        else:
            r = node.handle_laser_scan(odom, raw.ranges[t], raw.angle_min, raw.angle_increment,
                                       workloads.LDS_MIN, workloads.LDS_MAX)
        take(t - 1 if mode == "pipelined" else t, r)

    times = []
    for t in range(RAW_SCANS):
        t0 = time.perf_counter()
        step(t)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    prof = profiled_window(step, RAW_SCANS, RAW_SCANS + RAW_PROFILED)
    end = RAW_SCANS + RAW_PROFILED + RAW_SYNC_CHECKED
    sites = sync_sites(step, RAW_SCANS + RAW_PROFILED, end)
    if mode == "pipelined":
        take(end - 1, node.flush())
        check(node.flush() is None, f"{what}: a second flush returned a result")
        # the harvest waits on its scan's event and nothing else in node.py
        check(not any(k.startswith("beluga_tpu_torch/node.py") for k in sites),
              f"{what}: the node waited on the stream: {sites}")
    counts = read_counts()
    check(len(estimates) >= end - 1, f"{what}: only {len(estimates)} valid updates of {end}")
    for name in ("B1 fused_reweight", RESAMPLES):
        check(counts[name] > 0, f"{what}: {name} was never launched")
    steady = sorted(times[2:])
    mean_ms = 1e3 * sum(steady) / len(steady)
    busy = prof["device_busy_ms_per_update"]
    out = dict(mode=mode, device=smi, scans=end, valid=len(estimates),
               ms_per_update_median=1e3 * steady[len(steady) // 2], ms_per_update_mean=mean_ms,
               worst_pos_m=worst[0], worst_yaw_deg=math.degrees(worst[1]), **prof,
               device_idle_share=None if busy is None else 1.0 - busy / mean_ms,
               sync_sites=sites)
    return counts, out, estimates


def run_replay(dev, map_yaml: str, workdir: str) -> tuple[dict, dict]:
    """``tools/record.py`` on the arena (R1's ray entry casts every scan),
    then ``tools/localize.py`` host-driven and scan-driven on the ``.npz``
    stream and on a ``.db3`` bag of the same stream, at nav2 defaults: the
    same updates in both modes, APE rmse within the gate in each.  Returns
    the launch counts by run and the phase's numbers."""
    from beluga_tpu_torch.io import rosbag
    from beluga_tpu_torch.tools import localize, workloads
    from beluga_tpu_torch.tools.record import record

    counts: dict[str, dict] = {}
    out: dict = {}
    stream = os.path.join(workdir, "stream.npz")
    reset_counts()
    t0 = time.perf_counter()
    traj, scans = record(map_yaml, stream, steps=RECORD_STEPS, start=workloads.REPLAY_START,
                         device=dev)
    out["record_s"] = time.perf_counter() - t0
    counts["record"] = read_counts()
    check(counts["record"]["R1 cast_rays"] == RECORD_STEPS,
          f"record: R1 launched {counts['record']['R1 cast_rays']} times for {RECORD_STEPS} scans")
    check(bool(np.isfinite(scans[np.isfinite(scans)]).all()) and np.isfinite(scans).mean() > 0.2,
          "record: too few returns")
    bag = os.path.join(workdir, "stream.db3")
    rosbag.write_scan_bag(bag, traj, scans, -np.pi, 2 * np.pi / scans.shape[1], 0.12, 3.5)
    for source, path in (("npz", stream), ("bag", bag)):
        saved = {}
        for driven in (False, True):
            name = f"localize_{source}_{'scan_driven' if driven else 'host'}"
            result = os.path.join(workdir, f"{name}.npz")
            reset_counts()
            t0 = time.perf_counter()
            summary = localize.run(map_yaml, path, result, device=dev, scan_driven=driven)
            wall = time.perf_counter() - t0
            counts[name] = read_counts()
            check(summary["updates"] >= 5, f"{name}: only {summary['updates']} updates")
            check(summary["ape"]["rmse"] <= GATE_POS_M,
                  f"{name}: APE rmse {summary['ape']['rmse']:.3f} m")
            for kernel in ("B1 fused_reweight", RESAMPLES):
                check(counts[name][kernel] > 0, f"{name}: {kernel} was never launched")
            saved[driven] = np.load(result)
            out[name] = dict(wall_s=wall, updates=summary["updates"], ape=summary["ape"],
                             latency=summary["latency"])
        check(np.array_equal(saved[True]["estimate_indices"], saved[False]["estimate_indices"]),
              f"localize {source}: the modes updated at different scans")
        out[f"localize_{source}_max_pose_diff"] = float(np.abs(
            saved[True]["estimates"] - saved[False]["estimates"]).max())
    return counts, out


# -- slice 14: omni and stationary nodes, residual resampling, the sparse cluster
# estimate, the winlut fleet, the landmark models ---------------------------------

OMNI_SCANS, STATIONARY_SCANS = 50, 30
RESIDUAL_FLEET_SCANS, RESIDUAL_SYNC_CHECKED = 20, 3
WINLUT_FLEET_SCANS, WINLUT_FLEET_SYNC_CHECKED = 20, 3
SPARSE_NODE_PARTICLES = 10000
LANDMARK_N, LANDMARK_D, LANDMARK_L = 2000, 32, 256
LANDMARK_RTOL = 1e-4  # products of 32 float32 Gaussian terms, card against CPU
# the port's modules of the residual resample and the sparse estimate: no
# line of theirs may wait on the stream
RESIDUAL_FILES = ("beluga_tpu_torch/ops/resample.py", "beluga_tpu_torch/ops/cuda_resample.py")
SPARSE_FILES = ("beluga_tpu_torch/algorithms/cluster.py",)
WINLUT_FILES = ("beluga_tpu_torch/models/sensor/likelihood_field_winlut.py",
                "beluga_tpu_torch/ops/cuda_winlut.py")


def no_waits_in(sites: dict, files, what: str) -> None:
    """``sites`` (``sync_sites``'s lines) name none of ``files``."""
    bad = {k: v for k, v in sites.items() if k.startswith(files)}
    check(not bad, f"{what}: waited on the stream at {bad}")


def check_winlut_coverage_fleet(dev, iters: int, b: int = FLEET_B, n: int = FLEET_N) -> dict:
    """Kernel B6's coverage entry over a fleet (the winlut fleet's gate):
    ``b`` filters of the fleet's prefix slots (``n`` less the exact tail,
    the predicted poses of the phase's tight clouds, one filter shifted
    out of the window), one launch, each filter's share equal to its plain
    version's; timed beside the plain version (no library call computes
    it), its bound from this run's states."""
    from beluga_tpu_torch.filters.builders import _exact_tail_slots
    from beluga_tpu_torch.lie import SE2, SO2
    from beluga_tpu_torch.models.sensor.likelihood_field_winlut import field_window
    from beluga_tpu_torch.ops import cuda_winlut as b6
    from beluga_tpu_torch.tools import workloads

    cfg = workloads.WINLUT_FLEET
    w = workloads.winlut_fleet(1, dev, b, n)
    prefix = n - _exact_tail_slots(n, cfg["tile"], cfg["exact_tail_frac"])
    st = w.state.particles.state
    xy = st.xy[:, :prefix].clone()
    xy[0] += 5.0  # one filter off the window
    states = SE2(xy.contiguous(), SO2(st.rot.z[:, :prefix].contiguous()))
    centre = (torch.mean(states.x), torch.mean(states.y),
              torch.atan2(torch.mean(states.rot.sin), torch.mean(states.rot.cos)))
    geo = field_window(w.ctx["field"], cfg["k_bins"], cfg["win"], cfg["dth"],
                       cfg["max_point_radius"])
    tile, tblk = cfg["tile"], cfg["tblk"]
    args = (geo, states, *centre, tile, tblk)
    before = b6.coverage_launches
    got = b6.winlut_coverage_states(*args)
    torch.cuda.synchronize()
    check(b6.coverage_launches == before + 1, "B6 coverage fleet: not one launch")
    want = b6.winlut_coverage_states_reference(*args)
    again = b6.winlut_coverage_states(*args)
    label = (f"{b} filters x {prefix} particles (the winlut fleet's prefix), window "
             f"[{geo.k_bins}, {geo.win_x}, {geo.win_y}], tile {tile}, tblk {tblk}")
    check(got.shape == (b,) and got.dtype == torch.float32, "B6 coverage fleet: not f32[B]")
    check(torch.equal(got, want) and torch.equal(again, want),
          f"B6 coverage fleet {label}: {got.tolist()} against {want.tolist()}")
    check(float(got[0]) < 0.98 <= float(got[1:].min()),
          f"B6 coverage fleet {label}: shares {got.tolist()}")
    times = timings(lambda: b6.winlut_coverage_states(*args),
                    lambda: b6.winlut_coverage_states_reference(*args), iters)
    launch_device_ms(times, lambda: b6.winlut_coverage_states(*args), "winlut_coverage_kernel")
    bms, by = bound_ms(16 * b * prefix + 4 * b, B6_CHAIN_OPS * b * prefix)
    return dict(
        name=WINLUT_COVERAGE, route="cuda", source="beluga_tpu_torch/csrc/winlut.cu",
        replaces="beluga_tpu/filters/builders.py:717-725 (the fleet gate's vmapped "
                 "windowed_coverage_tiled_from_center; B6's slab rule, "
                 "beluga_tpu/ops/pallas_winlut.py:157)",
        max_abs_err=float((got - want).abs().max()), bound_ms=bms, bound_by=by, shape=label,
        covered=[round(float(v) * prefix) for v in want], **times,
    )


def check_cluster_sparse(dev) -> dict:
    """The sparse cluster estimate on the card: at 4096 particles (the dense
    form's largest) the cluster of the dense form, the first and second
    moments within 1e-5 of their scale (``|mean|``; ``|mean|² + max|cov|``);
    at 262144 two calls bit-equal; each form's time a call (back to back and
    on the device) and its launches."""
    from beluga_tpu_torch.algorithms.cluster import cluster_based_estimate

    out = {}
    for n in (4096, LARGE_N):
        states, _ = arena_cloud(n, dev, seed=n, stray_every=7)  # a second, lighter cloud
        gen = torch.Generator(device=dev)
        gen.manual_seed(n)
        w = torch.rand(n, generator=gen, device=dev)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        mask[-n // 10:] = False  # a dead tail, as after a KLD cut
        args = (states, w, mask)
        a = cluster_based_estimate(*args, method="sparse")
        b = cluster_based_estimate(*args, method="sparse")
        torch.cuda.synchronize()
        check(torch.equal(a[0].xy, b[0].xy) and torch.equal(a[0].rot.z, b[0].rot.z)
              and torch.equal(a[1], b[1]), f"sparse cluster {n}: two calls differ")
        sparse = lambda: cluster_based_estimate(*args, method="sparse")  # noqa: E731
        row = dict(sparse_ms=cuda_ms(sparse, 10), sparse_device_ms=device_ms(sparse, 5),
                   sparse_launches=call_launches(sparse)["launches"])
        if n <= 4096:
            d = cluster_based_estimate(*args, method="dense")
            # relative to each moment's scale: the first moment's |mean|, the
            # second's |mean|² + max |cov| (the covariance is E[x²] - mean²
            # from raw sums, whose cancellation the two forms share)
            scale = d[0].xy.abs().max()
            rel = max(float((a[0].xy - d[0].xy).abs().max() / scale),
                      float((a[0].rot.z - d[0].rot.z).abs().max()),
                      float((a[1] - d[1]).abs().max() / (scale * scale + d[1].abs().max())))
            check(rel < 1e-5, f"sparse cluster {n}: {rel} from the dense form")
            dense = lambda: cluster_based_estimate(*args, method="dense")  # noqa: E731
            row.update(dense_ms=cuda_ms(dense, 10), dense_device_ms=device_ms(dense, 5),
                       dense_launches=call_launches(dense)["launches"],
                       max_rel_err_vs_dense=rel)
        out[str(n)] = row
    return out


def run_winlut_fleet(dev, b: int = FLEET_B, n: int = FLEET_N,
                     scans: int = WINLUT_FLEET_SCANS) -> tuple[dict, dict]:
    """The winlut fleet (benchmarks/report.py:289-318), ``b`` filters of
    ``n`` from a tight cloud along the circle: every filter within the gate
    at every scan; the gate (B6's coverage entry) once an update; on the
    fast branch B6's states entry once and B4 once (the tails), on the
    exact one B4 once; the fast branch at least once.  Then filter 0 is
    moved 5 m off its cloud: that update takes the exact branch (the other
    filters still within the gate).  The last scans run with the waits on
    the stream listed: the gate's readback (``filters/builders.py``) is the
    step's one, by design."""
    from beluga_tpu_torch.lie import SE2
    from beluga_tpu_torch.ops import cuda_winlut
    from beluga_tpu_torch.tools import workloads

    w = workloads.winlut_fleet(scans + 1, dev, b, n)
    s = w.scans
    box = {"state": w.state}
    lookups = WINLUT_STATES["bf16"]
    reset_counts()
    times, worst, branch = [], [0.0, 0.0], []

    def step(t: int, filters=slice(None)) -> None:
        before = cuda_winlut.states_launches
        box["state"], est = w.step(w.ctx, box["state"], workloads.fleet_odometry(s, t, b),
                                   w.points[t], w.mask[t])
        pose = est.pose.as_xytheta().cpu().numpy()
        branch.append(cuda_winlut.states_launches - before)
        check(bool(np.all(est.valid)), f"winlut fleet scan {t}: a filter was gated out")
        e_pos, e_yaw = fleet_errors(pose, s, t, "winlut fleet", filters)
        worst[0] = max(worst[0], float(e_pos[filters].max()))
        worst[1] = max(worst[1], float(e_yaw[filters].max()))

    tail = scans - WINLUT_FLEET_SYNC_CHECKED
    for t in range(tail):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(t)
        times.append(time.perf_counter() - t0)
    sites = sync_sites(step, tail, scans)
    counts = read_counts()
    fast = sum(branch)
    check(fast >= 1, "winlut fleet: the fast branch never ran")
    check(counts[lookups] == fast and counts[WINLUT_COVERAGE] == scans,
          f"winlut fleet: {counts[lookups]} lookups, {counts[WINLUT_COVERAGE]} gates in "
          f"{scans} updates")
    check(counts["B4 fused_reweight values3"] == scans,
          f"winlut fleet: B4 launched {counts['B4 fused_reweight values3']} times in {scans}")
    # the gate's readback is the step's one wait of its own: none in the LUT
    # build or the lookups
    builder_sites = {k: v for k, v in sites.items() if "filters/builders.py" in k}
    check(len(builder_sites) == 1, f"winlut fleet: waits in the step {builder_sites}")
    no_waits_in(sites, WINLUT_FILES, "winlut fleet")
    # one filter diverges: the gate's minimum trips the exact branch
    p = box["state"].particles
    moved = SE2(p.state.xy.clone(), p.state.rot)
    moved.xy[0] += 5.0
    box["state"] = box["state"]._replace(particles=p.replace(state=moved))
    before = read_counts()
    step(scans, filters=slice(1, None))
    after = read_counts()
    check(after[lookups] == before[lookups] and after[WINLUT_COVERAGE] == before[WINLUT_COVERAGE] + 1
          and after["B4 fused_reweight values3"] == before["B4 fused_reweight values3"] + 1,
          "winlut fleet: the diverged filter did not send the fleet down the exact branch")
    steady = sorted(times[2:])
    mean_s = sum(steady) / len(steady)
    return after, dict(
        filters=b, particles=n, scans=scans + 1, fast_updates=fast,
        exact_updates=scans - fast + 1, branch_by_scan=branch, worst_pos_m=worst[0],
        worst_yaw_deg=math.degrees(worst[1]), ms_per_update_mean=1e3 * mean_s,
        ms_per_update_median=1e3 * steady[len(steady) // 2], ms_first_update=1e3 * times[0],
        particle_updates_per_s=b * n / mean_s, sync_sites=sites,
        gate_readback_site=builder_sites,
    )


def run_landmarks(dev) -> dict:
    """The landmark and bearing models at LANDMARK_N SE2 and SE3 particles x
    LANDMARK_D detections x LANDMARK_L landmarks (one detection of a
    category with no landmark), on the card and on the CPU from the same
    inputs: every weight within LANDMARK_RTOL of the CPU's but where a
    nearest or best-aligned landmark ties within rounding (their share
    printed, at most 1 in 1000); one unscented transform on the card
    against the CPU's."""
    from beluga_tpu_torch.algorithms.unscented import unscented_transform
    from beluga_tpu_torch.lie import SE2, SE3, SO3
    from beluga_tpu_torch.models.sensor import landmark as lm

    rng = np.random.default_rng(14)
    n, d, nl = LANDMARK_N, LANDMARK_D, LANDMARK_L
    pos = rng.uniform(-8, 8, (nl, 3)).astype(np.float32)
    pos[:, 2] *= 0.1
    cats = rng.integers(0, 8, nl)
    seen = rng.choice(nl, d, replace=False)
    dcats = cats[seen].copy()
    no_landmark = dcats.copy()
    no_landmark[0] = 8  # a category with no landmark: random_prob (landmark), 0 (bearing)
    mask = np.ones(d, bool)
    mask[-2:] = False
    xyt = rng.normal(0.0, [0.3, 0.3, 0.1], (n, 3)).astype(np.float32)
    xyz = rng.normal(0.0, 0.3, (n, 3)).astype(np.float32)
    rot = rng.normal(0.0, 0.05, (n, 3)).astype(np.float32)
    sensor = (np.float32([0.1, 0.0, 0.2]), np.float32([0.0, 0.0, 0.3]))
    # detections as seen from the origin: ranges and bearings of the chosen landmarks
    det = pos[seen] + rng.normal(0, 0.05, (d, 3)).astype(np.float32)
    bearings = det / np.linalg.norm(det, axis=-1, keepdims=True)
    out = {}

    def run(device):
        lmap = lm.make_landmark_map(pos, cats, device=device)
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        se2 = SE2.from_xytheta(*(xyt[:, i] for i in range(3)), device=device)
        se3 = SE3(t(xyz), SO3.exp(t(rot)))
        sp = SE3(t(sensor[0]), SO3.exp(t(sensor[1])))
        res = {}
        for space, st in (("se2", se2), ("se3", se3)):
            res[f"landmark_{space}"] = lm.landmark_weights(
                lm.LandmarkModelParams(0.5, 0.3, 1e-3), lmap, st, t(det), t(no_landmark),
                t(mask))
            res[f"bearing_{space}"] = lm.bearing_weights(
                lm.BearingModelParams(0.3), lmap, st, t(bearings), t(dcats), t(mask), sp)
            res[f"bearing_{space}_unmatched"] = lm.bearing_weights(
                lm.BearingModelParams(0.3), lmap, st, t(bearings), t(no_landmark), t(mask), sp)
        return {k: v.cpu().numpy() for k, v in res.items()}

    card, cpu = run(dev), run(torch.device("cpu"))
    for space in ("se2", "se3"):
        check(not card.pop(f"bearing_{space}_unmatched").any(),
              f"bearing {space}: an unmatched detection did not weigh 0")
        cpu.pop(f"bearing_{space}_unmatched")
        check(bool((cpu[f"bearing_{space}"] > 0).mean() > 0.5),
              f"bearing {space}: the detections score 0 at most particles")
    for key in card:
        got, want = card[key], cpu[key]
        check(got.shape == (n,) and bool(np.isfinite(got).all()), f"{key}: not finite f32[N]")
        off = ~np.isclose(got, want, rtol=LANDMARK_RTOL, atol=1e-30)
        check(off.mean() <= 1e-3, f"{key}: {int(off.sum())} of {n} weights off the CPU's")
        inside = ~off
        out[key] = dict(shape=f"{n} x {d} x {nl}", positive_share=float((want > 0).mean()),
                        max_rel_err=float(np.max(np.abs(got[inside] - want[inside])
                                                 / np.maximum(np.abs(want[inside]), 1e-30))),
                        off_share=float(off.mean()))
    cov = torch.tensor([[0.2, 0.05, 0.0], [0.05, 0.1, 0.01], [0.0, 0.01, 0.05]])

    def transfer(p):
        return torch.stack([p[:, 0] + torch.cos(p[:, 2]), p[:, 1] * p[:, 0],
                            torch.sin(p[:, 2])], -1)

    mean = torch.tensor([1.0, 2.0, 0.3])
    got = unscented_transform(mean.to(dev), cov.to(dev), transfer)
    want = unscented_transform(mean, cov, transfer)
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    check(err < 1e-5, f"unscented transform: {err} from the CPU's")
    out["unscented_max_abs_err"] = err
    return out


# -- phase 29: the same updates twice give the same bits ----------------------

REPEAT_UPDATES = 4


def same_bits(a, b) -> bool:
    """Whether two lists of tensors and arrays hold the same bits."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
                return False
        elif not np.array_equal(np.asarray(x), np.asarray(y)):
            return False
    return True


def particle_bits(particles) -> list:
    from beluga_tpu_torch.core.particles import tree_leaves

    return [*tree_leaves(particles.state), particles.log_weight, particles.active]


def repeat_large_residual(dev) -> list:
    """The large filter with residual resampling (phase 24's), 4 updates."""
    from beluga_tpu_torch.filters.amcl import host_pose, update
    from beluga_tpu_torch.tools import workloads

    w = workloads.large_filter(REPEAT_UPDATES, dev, resampling="residual")
    s, state, out = w.scans, w.state, []
    for t in range(REPEAT_UPDATES):
        state, est = update(w.params, w.models, w.ctx, state,
                            host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t])
        out += [est.pose.xy, est.pose.rot.z, est.covariance]
    return out + particle_bits(state.particles)


def repeat_sparse_node(dev) -> list:
    """The node at nav2 defaults with ``max_particles: 10000`` (phase 25's,
    multinomial, the sparse cluster estimate), 4 scans of the circle."""
    from beluga_tpu_torch.maps.occupancy import make_grid
    from beluga_tpu_torch.node import AmclNode
    from beluga_tpu_torch.tools import workloads

    s = workloads.arena_scans(REPEAT_UPDATES)
    node = AmclNode(workloads.node_config(s, max_particles=SPARSE_NODE_PARTICLES), seed=0,
                    device=dev)
    node.set_map(make_grid(s.data, workloads.RES, device=dev))
    out = []
    for t in range(REPEAT_UPDATES):
        r = node.handle_scan((s.xs[t], s.ys[t], s.yaws[t]), s.points[t], s.mask[t])
        out += [r.pose, r.covariance, np.asarray(r.valid)]
    return out + particle_bits(node._state.particles)


def repeat_fleet(dev) -> list:
    """Phase 6's fleet (64 x 4096, multinomial), 4 updates."""
    from beluga_tpu_torch.parallel.fleet import make_fleet_update
    from beluga_tpu_torch.tools import workloads

    w = workloads.fleet(REPEAT_UPDATES, dev)
    fleet_update = make_fleet_update(w.params, w.models)
    state, out = w.state, []
    for t in range(REPEAT_UPDATES):
        state, est = fleet_update(w.ctx, state, workloads.fleet_odometry(w.scans, t, FLEET_B),
                                  w.points[t], w.mask[t])
        out += [est.pose.xy, est.pose.rot.z, est.covariance]
    return out + particle_bits(state.particles)


def repeat_ndt3d_node(dev) -> list:
    """Phase 18's NDT-3D node (3600-point clouds: the measurement cells'
    segment sums), 4 scans."""
    from beluga_tpu_torch.io.config import AmclNodeConfig
    from beluga_tpu_torch.ndt_node import NdtAmclNode3D
    from beluga_tpu_torch.tools import workloads

    s = workloads.ndt_scans(REPEAT_UPDATES)
    clouds, cmask = workloads.ndt_clouds(s)
    node = NdtAmclNode3D(AmclNodeConfig(), seed=0, device=dev)
    node.set_map(workloads.ndt_map_3d(dev))
    node.set_initial_pose((s.xs[0], s.ys[0], 0.0), (0.0, 0.0, s.yaws[0]),
                          workloads.INITIAL_COV_3D)
    out = []
    for t in range(REPEAT_UPDATES):
        r = node.handle_point_cloud((s.xs[t], s.ys[t], 0.0, 0.0, 0.0, s.yaws[t]), clouds[t],
                                    cmask[t])
        out += [r.pose, r.covariance, np.asarray(r.valid)]
    return out + particle_bits(node._state.particles)


def run_repeatable(dev) -> dict:
    """Phase 29: each of four paths run twice from the same generators for
    4 updates; particles (states, log-weights, active counts) and every
    estimate must be bit-equal between the two runs.  The first run's
    launch counts show which repaired sums it took (B2-sum: the sorted
    positions)."""
    out = {}
    for what, run in (("large residual", repeat_large_residual),
                      ("sparse node", repeat_sparse_node),
                      ("fleet multinomial", repeat_fleet), ("NDT-3D node", repeat_ndt3d_node)):
        t0 = time.perf_counter()
        reset_counts()
        first = run(dev)
        counts = read_counts()
        second = run(dev)
        torch.cuda.synchronize()
        equal = same_bits(first, second)
        check(equal, f"repeatable {what}: two runs from the same generators differ")
        check(counts[RUNNING_SUM] > 0, f"repeatable {what}: no {RUNNING_SUM}")
        out[what] = dict(updates=REPEAT_UPDATES, bit_equal=equal, tensors=len(first),
                         running_sums=counts[RUNNING_SUM], searches=counts[RESAMPLES],
                         seconds=time.perf_counter() - t0)
    return out


# -- phase 30: the three examples on the card ---------------------------------

EXAMPLE_MEGA_N, EXAMPLE_MEGA_STEPS = 1 << 21, 16


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def run_examples(dev) -> dict:
    """Phase 30: the port's three examples through their ``main``: the
    tutorial and the fleet demo at their defaults, the mega demo at 2^21
    particles for 16 steps.  Each raises when it misses its gate (the
    tutorial's tail below 1.0 is checked here); their launches show they
    ran the kernels."""
    out = {}
    t0 = time.perf_counter()
    reset_counts()
    tail = load_example("torch_tutorial_1d").main(device=dev)
    counts = read_counts()
    check(tail < 1.0, f"tutorial: tail error {tail:.3f} >= 1.0")
    check(counts["B2-cdf monotone_cdf"] > 0, "tutorial: B2's CDF kernel never launched")
    out["tutorial"] = dict(tail_m=tail, seconds=time.perf_counter() - t0,
                           cdf_launches=counts["B2-cdf monotone_cdf"])

    t0 = time.perf_counter()
    reset_counts()
    fleet = load_example("torch_fleet_demo").main(device=dev)
    counts = read_counts()
    check(fleet["worst_pos_m"] < GATE_POS_M, "fleet demo: a filter left the gate")
    for name in (RESAMPLES, REWEIGHT_STATES):
        check(counts[name] > 0, f"fleet demo: {name} never launched")
    out["fleet_demo"] = dict(fleet, seconds=time.perf_counter() - t0,
                             resamples=counts[RESAMPLES])

    t0 = time.perf_counter()
    reset_counts()
    mega = load_example("torch_mega_demo").main(EXAMPLE_MEGA_N, EXAMPLE_MEGA_STEPS, device=dev)
    counts = read_counts()
    check(mega["err_max_m"] < GATE_POS_M, "mega demo: an estimate left the gate")
    check(counts["B5 fused_propagate_winlut"] == EXAMPLE_MEGA_STEPS,
          f"mega demo: B5 launched {counts['B5 fused_propagate_winlut']} times")
    check(counts["R1 cast_rays"] >= EXAMPLE_MEGA_STEPS, "mega demo: R1 did not cast the scans")
    out["mega_demo"] = dict(mega, seconds=time.perf_counter() - t0,
                            b5_launches=counts["B5 fused_propagate_winlut"])
    return out


# -- slice 15: the sharded mega filter and fleet over torch.distributed ----------

SHARDED_COMPARE = 8  # updates held against the dense update on the same draws
SHARDED_TIMED = 16  # updates of each timed in turns, sharded and dense
SHARDED_PROFILED = 4  # sharded updates under torch.profiler: NCCL's kernels apart
SHARDED_FLEET_SCANS, SHARDED_FLEET_COMPARE = 20, 4
# past one rank, the estimates' gap to the dense update on the same draws:
# tests/test_mega.py:187-237 (the flagship on 2 devices) and
# tests/test_parallel.py:127-130 (the fleet)
MEGA_SHARDED_ATOL, FLEET_SHARDED_ATOL = 0.05, 2e-4
SHARDED_TIMEOUT = 600.0  # seconds the ranks of phases 27-28 may take past one card
MULTIHOST_TIMEOUT = 300


def whole_state(state, tp_mesh, seed: int):
    """The filters of a sharded state with their particles gathered over the
    ``tp`` group (the whole filter at one rank along ``tp``), and a plain
    generator of ``seed``: the dense update's state."""
    from beluga_tpu_torch.core.particles import ParticleSet
    from beluga_tpu_torch.parallel.collectives import all_gather_last
    from beluga_tpu_torch.parallel.mega import all_gather_states

    group, p = tp_mesh.get_group("tp"), state.particles
    gen = torch.Generator(device=p.log_weight.device)
    gen.manual_seed(seed)
    return state._replace(
        particles=ParticleSet(all_gather_states(p.state, group, p.log_weight.dim() - 1),
                              all_gather_last(p.log_weight, group), p.active),
        generator=gen)


def same_draws_gap(dense, sharded, dest, sest, tp_mesh) -> dict:
    """How far a sharded update lies from the dense one on the same draws:
    whether particles, log-weights and active counts are bit-equal, the
    share of donor rows that differ, the largest relative log-weight gap,
    and the estimates' largest x/y and 2 x 2 covariance gaps."""
    whole = whole_state(sharded, tp_mesh, 0).particles
    d, s = dense.particles, whole
    rows = torch.any(d.state.xy != s.state.xy, -1) | torch.any(d.state.rot.z != s.state.rot.z, -1)
    live = d.log_weight > -1e29
    rel = torch.abs(d.log_weight - s.log_weight) / torch.clamp_min(torch.abs(d.log_weight), 1e-30)
    same = (torch.equal(d.state.xy, s.state.xy), torch.equal(d.state.rot.z, s.state.rot.z),
            torch.equal(d.log_weight, s.log_weight), torch.equal(d.active, s.active))
    return dict(
        bit_equal=all(same),
        rows_differ_share=float(rows.float().mean()),
        log_w_max_rel=float(torch.where(live, rel, 0.0).max()),
        active_equal=bool(torch.equal(d.active, s.active)),
        est_xy_gap=float(torch.abs(dest.pose.xy - sest.pose.xy).max()),
        cov_gap=float(torch.abs(dest.covariance[..., :2, :2] - sest.covariance[..., :2, :2]).max()))


def check_same_draws(gaps: list, world: int, what: str, est_atol: float, cov_atol) -> dict:
    """At one rank every compared update bit-equal and the estimate within
    1e-5 on x, y and 1e-4 on the 2 x 2 covariance (tests/test_mega.py:
    66-93); past it the CPU tests' tolerance for the configuration: the
    estimate's x and y within ``est_atol`` and its covariance within
    ``cov_atol`` (unchecked when ``None``), the active counts equal.  Past
    one rank each rank sorts its own slots and the windowed models centre
    their window on the rank's own cloud, so slots and weights differ."""
    for i, g in enumerate(gaps):
        if world == 1:
            check(g["bit_equal"] and g["est_xy_gap"] <= 1e-5 and g["cov_gap"] <= 1e-4,
                  f"{what} update {i}: not bit-equal to the dense update on the same draws: {g}")
        else:
            check(g["active_equal"] and g["est_xy_gap"] <= est_atol
                  and (cov_atol is None or g["cov_gap"] <= cov_atol),
                  f"{what} update {i}: estimate apart from the dense one: {g}")
    return {key: max(float(g[key]) for g in gaps) for key in
            ("rows_differ_share", "log_w_max_rel", "est_xy_gap", "cov_gap")} | {
        "compared_updates": len(gaps), "all_bit_equal": all(g["bit_equal"] for g in gaps)}


def nccl_window(step, t0: int, t1: int) -> dict:
    """Scans ``t0`` to ``t1`` of ``step(t)`` under ``torch.profiler``: NCCL's
    kernels (names with ``nccl``) an update and their device ms, apart from
    every other kernel's; the collective calls (``c10d::`` operators) an
    update and the host ms inside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(t0, t1):
            step(t)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    nccl = [e for e in device if "nccl" in e.name.lower()]
    other = [e for e in device if "nccl" not in e.name.lower()
             and not e.name.startswith(("Memcpy", "Memset"))]
    calls = [e for e in prof.events()
             if e.device_type == DeviceType.CPU and e.name.startswith("c10d::")]
    n = t1 - t0

    def ms(events):
        return 1e-3 * sum(e.time_range.elapsed_us() for e in events) / n

    return dict(profiled_updates=n, collective_calls_per_update=len(calls) / n,
                collective_host_ms_per_update=ms(calls),
                collective_names=sorted({e.name for e in calls}),
                nccl_kernels_per_update=len(nccl) / n,
                nccl_device_ms_per_update=ms(nccl), other_kernels_per_update=len(other) / n,
                other_device_ms_per_update=ms(other),
                nccl_kernel_names=sorted({e.name for e in nccl})[:8])


def run_mega_sharded(dev, world: int, scans: int = MEGA_SCANS):
    """Phase 27: the mega filter (phase 7's configuration, 2097152 x 60)
    split over the ``tp`` axis of every rank, through ``make_mega_update``:
    ``scans`` forced updates with the θ sort on every 8th and phase 7's
    gate; then SHARDED_COMPARE updates against the dense update on the same
    draws; then SHARDED_TIMED updates of each in turns.  Returns the main
    run's launch counts, the result and the sharded state."""
    from torch.distributed.device_mesh import init_device_mesh

    from beluga_tpu_torch.filters.amcl import draw_update, host_pose, update
    from beluga_tpu_torch.parallel.mega import make_mega_update, shard_draws, shard_mega_state
    from beluga_tpu_torch.tools import workloads

    total = scans + SHARDED_COMPARE + SHARDED_TIMED + SHARDED_PROFILED
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("tp",))
    w = workloads.mega(total, dev)
    s = w.scans
    state = shard_mega_state(mesh, w.state)  # its broadcasts start NCCL, untimed
    mega = make_mega_update(w.params, w.models, mesh)

    def args(t):
        return (host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t])

    def sort_now(t):
        return t % workloads.MEGA_SORT_EVERY == 0

    reset_counts()
    times, errs, yaws = [], [], []
    for t in range(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = mega(w.ctx, state._replace(force_update=True), *args(t),
                          sort_now=sort_now(t))
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(est.valid and bool(np.isfinite(pose).all()), f"mega sharded scan {t}: no estimate")
        errs.append(math.hypot(pose[0] - s.xs[t], pose[1] - s.ys[t]))
        yaws.append(yaw_error(float(pose[2]), s.yaws[t]))
        check(errs[-1] < GATE_POS_M and yaws[-1] < GATE_YAW_RAD,
              f"mega sharded scan {t}: error {errs[-1]:.3f} m / "
              f"{math.degrees(yaws[-1]):.1f} deg")
    counts = read_counts()
    last = errs[-MEGA_LAST:]
    check(max(last) <= MEGA_LAST_GATE_M,
          f"mega sharded: max error {max(last):.3f} m over the last {MEGA_LAST} scans")
    check(counts["B5 fused_propagate_winlut"] == scans,
          f"mega sharded: B5 launched {counts['B5 fused_propagate_winlut']} times in "
          f"{scans} updates")
    # a resample searches once through B2 and draws its pool once through B3
    check(counts[B2_SEARCH] > 0, "mega sharded: B2 was never launched")
    check(counts[POOL_DRAW] == counts[B2_SEARCH],
          f"mega sharded: {POOL_DRAW} launched {counts[POOL_DRAW]} times in "
          f"{counts[B2_SEARCH]} resamples")
    for name in ("B1 fused_reweight", "B4 fused_reweight values3", WINLUT_STATES["bf16"],
                 WINLUT_COVERAGE):
        check(counts[name] == 0, f"mega sharded: {name} launched {counts[name]} times")
    steady = sorted(times[2:])
    out = dict(world=world, particles=w.params.max_particles, particles_per_rank=
               w.params.max_particles // world, scans=scans, err_mean_m=float(np.mean(errs)),
               err_max_m=max(errs), err_max_last_m=max(last),
               worst_yaw_deg=math.degrees(max(yaws)),
               ms_per_update_mean=1e3 * sum(steady) / len(steady),
               ms_per_update_median=1e3 * steady[len(steady) // 2],
               ms_first_update=1e3 * times[0])

    # the dense update and the sharded one on the same draws; past one rank
    # a pooled injection's draws are each rank's own, so both inject nothing
    params = w.params if world == 1 else dataclasses.replace(w.params, recovery_pool=0)
    sharded = mega if world == 1 else make_mega_update(params, w.models, mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    gaps = []
    for t in range(scans, scans + SHARDED_COMPARE):
        # each compared update from the sharded filter's state, gathered
        dense = whole_state(state, mesh, 15)
        draws = draw_update(params, w.models, w.ctx, dense.particles, gen)
        if world > 1:
            draws = draws._replace(inject_uniform=torch.ones_like(draws.inject_uniform))
        dense, dest = update(params, w.models, w.ctx, dense._replace(force_update=True),
                             *args(t), draws=draws, sort_now=sort_now(t))
        state, sest = sharded(w.ctx, state._replace(force_update=True), *args(t),
                              draws=shard_draws(draws, params, mesh), sort_now=sort_now(t))
        gaps.append(same_draws_gap(dense, state, dest, sest, mesh))
    out["same_draws"] = check_same_draws(gaps, world, "mega sharded",
                                         est_atol=MEGA_SHARDED_ATOL, cov_atol=None)

    # ms an update of each, in turns (dense then sharded on even scans,
    # sharded then dense on odd ones), both from their own generators
    box = {"dense": dense, "sharded": state}
    spent = {"dense": [], "sharded": []}

    def one(which, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if which == "dense":
            box[which], est = update(w.params, w.models, w.ctx,
                                     box[which]._replace(force_update=True), *args(t),
                                     sort_now=sort_now(t))
        else:
            box[which], est = mega(w.ctx, box[which]._replace(force_update=True), *args(t),
                                   sort_now=sort_now(t))
        est.pose.as_xytheta().cpu()
        spent[which].append(time.perf_counter() - t0)

    first = scans + SHARDED_COMPARE
    for t in range(first, first + SHARDED_TIMED):
        for which in (("dense", "sharded") if t % 2 == 0 else ("sharded", "dense")):
            one(which, t)
    for which, ts in spent.items():
        ts = sorted(ts)
        out[f"{which}_ms_per_update_median"] = 1e3 * ts[len(ts) // 2]
        out[f"{which}_ms_per_update_mean"] = 1e3 * sum(ts) / len(ts)
    first += SHARDED_TIMED
    out["nccl"] = nccl_window(lambda t: one("sharded", t), first, first + SHARDED_PROFILED)
    if dev.type == "cuda":
        out["peak_device_memory_mb"] = torch.cuda.max_memory_allocated(dev) / 2**20
    return counts, out, box["sharded"], (mesh, w, mega)


def run_fleet_sharded(dev, world: int, scans: int = SHARDED_FLEET_SCANS):
    """Phase 28, first part: phase 6's fleet (64 x 4096, codebook16) placed
    by ``shard_fleet`` on the ``("dp", "tp")`` mesh of every rank (``(1,
    1)`` on one card, ``tp`` 2 on an even count), its map by ``replicate``,
    for ``scans`` updates within the gate; then SHARDED_FLEET_COMPARE
    updates against the dense fleet on the same draws."""
    from torch.distributed.device_mesh import init_device_mesh

    from beluga_tpu_torch.filters.amcl import draw_update, update
    from beluga_tpu_torch.parallel.fleet import make_fleet_update, replicate, shard_fleet
    from beluga_tpu_torch.parallel.mega import axis_size, shard_draws
    from beluga_tpu_torch.tools import workloads

    tp = 2 if world % 2 == 0 else 1
    mesh = init_device_mesh(dev.type, (world // tp, tp), mesh_dim_names=("dp", "tp"))
    w = workloads.fleet(scans + SHARDED_FLEET_COMPARE, dev)
    s = w.scans
    b = FLEET_B // axis_size(mesh, "dp")
    at = mesh.get_local_rank("dp")
    block = slice(at * b, (at + 1) * b)
    state = shard_fleet(mesh, w.state)
    ctx = replicate(mesh, w.ctx)
    fleet_update = make_fleet_update(w.params, w.models, mesh)
    reset_counts()
    times, worst = [], [0.0, 0.0]
    for t in range(scans):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, est = fleet_update(ctx, state, workloads.fleet_odometry(s, t, b),
                                  w.points[t][block].contiguous(), w.mask[t][block].contiguous())
        pose = est.pose.as_xytheta().cpu().numpy()
        times.append(time.perf_counter() - t0)
        check(bool(np.all(est.valid)), f"fleet sharded scan {t}: a filter was gated out")
        e_pos, e_yaw = fleet_errors(pose, s, t, "fleet sharded")
        worst[0], worst[1] = max(worst[0], float(e_pos.max())), max(worst[1], float(e_yaw.max()))
    counts = read_counts()
    for name in (B2_TILE, POOL_DRAW, "B4 fused_reweight values3"):
        check(counts[name] == scans,
              f"fleet sharded: {name} launched {counts[name]} times in {scans} updates")
    check(counts["B1 fused_reweight"] == 0, "fleet sharded: B1 launched")
    steady = sorted(times[2:])
    out = dict(world=world, mesh=list(mesh.shape), filters=FLEET_B, filters_per_rank=b,
               particles=FLEET_N, scans=scans, worst_pos_m=worst[0],
               worst_yaw_deg=math.degrees(worst[1]),
               ms_per_update_mean=1e3 * sum(steady) / len(steady),
               ms_per_update_median=1e3 * steady[len(steady) // 2])

    tp_mesh = mesh["tp"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(28)
    gaps = []
    for t in range(scans, scans + SHARDED_FLEET_COMPARE):
        dense = whole_state(state, tp_mesh, 28)
        odoms = workloads.fleet_odometry(s, t, b)
        pts, mask = w.points[t][block].contiguous(), w.mask[t][block].contiguous()
        draws = draw_update(w.params, w.models, w.ctx, dense.particles, gen)
        dense, dest = update(w.params, w.models, w.ctx, dense, odoms, pts, mask, draws=draws)
        state, sest = fleet_update(ctx, state, odoms, pts, mask,
                                   draws=shard_draws(draws, w.params, tp_mesh))
        gaps.append(same_draws_gap(dense, state, dest, sest, tp_mesh))
    out["same_draws"] = check_same_draws(gaps, world, "fleet sharded",
                                         est_atol=FLEET_SHARDED_ATOL, cov_atol=FLEET_SHARDED_ATOL)
    return counts, out


def run_multihost() -> dict:
    """Phase 28, second part: the pod run as a user starts it, one rank
    on the card (``python -m beluga_tpu_torch.parallel.multihost``); its
    rows must parse, with filters/s above 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "beluga_tpu_torch.parallel.multihost", "--particles", "4096",
         "--filters-per-device", "8"], capture_output=True, text=True, cwd=root,
        timeout=MULTIHOST_TIMEOUT)
    check(run.returncode == 0, f"multihost exited {run.returncode}: {run.stderr[-2000:]}")
    rows = [json.loads(line) for line in run.stdout.splitlines() if line.startswith("{")]
    check(bool(rows) and all(r["filters_per_s"] > 0 for r in rows),
          f"multihost printed no rows with filters/s > 0: {run.stdout[-2000:]}")
    return dict(rows=rows, seconds=time.perf_counter() - t0)


def run_sharded_checkpoint(dev, state, mesh_run, workdir: str) -> dict:
    """Phase 28, third part: the sharded mega state saved by
    ``save_state_sharded`` and loaded by ``load_state_sharded`` must come
    back bit-equal, generators included, and the next update from the
    restored state must equal the next update from the saved one."""
    from beluga_tpu_torch.filters.amcl import host_pose
    from beluga_tpu_torch.parallel.mega import shard_mega_state
    from beluga_tpu_torch.utils.checkpoint import (
        _leaves,
        load_state_sharded,
        save_state_sharded,
    )

    mesh, w, mega = mesh_run
    path = os.path.join(workdir, "mega_ckpt")
    t0 = time.perf_counter()
    save_state_sharded(path, state, mesh)
    template = shard_mega_state(mesh, w.state)
    back = load_state_sharded(path, template, mesh)
    seconds = time.perf_counter() - t0

    def leaves(tree):
        out: list = []
        _leaves(tree, out)
        return [x.get_state() if isinstance(x, torch.Generator) else x for x in out]

    for i, (a, b) in enumerate(zip(leaves(state), leaves(back))):
        same = (torch.equal(a.cpu(), b.cpu()) if isinstance(a, torch.Tensor)
                else np.array_equal(np.asarray(a), np.asarray(b)))
        check(same, f"sharded checkpoint: leaf {i} did not round-trip")
    s = w.scans
    t = len(s.xs) - 1
    step = (host_pose(s.xs[t], s.ys[t], s.yaws[t]), w.points[t], w.mask[t])
    after, _ = mega(w.ctx, state._replace(force_update=True), *step)
    after_back, _ = mega(w.ctx, back._replace(force_update=True), *step)
    for i, (a, b) in enumerate(zip(leaves(after), leaves(after_back))):
        same = (torch.equal(a.cpu(), b.cpu()) if isinstance(a, torch.Tensor)
                else np.array_equal(np.asarray(a), np.asarray(b)))
        check(same, f"sharded checkpoint: the next update's leaf {i} differs")
    files = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    return dict(leaves=len(leaves(state)), bytes_written=files, save_load_s=seconds)


def sharded_phases(rank: int, world: int, dev) -> dict:
    """Phases 27 and 28 on this rank of ``world`` (one a visible card);
    rank 0's results are the report."""
    import tempfile

    import torch.distributed as dist

    mega_counts, mega, mega_state, mesh_run = run_mega_sharded(dev, world)
    fleet_counts, fleet = run_fleet_sharded(dev, world)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
        # every rank saves into rank 0's directory: one host here
        where = [workdir]
        dist.broadcast_object_list(where, src=0)
        fleet["checkpoint"] = run_sharded_checkpoint(dev, mega_state, mesh_run, where[0])
        dist.barrier()
    if rank == 0:
        fleet["multihost"] = run_multihost()
    dist.barrier()
    return dict(mega_counts=mega_counts, mega=mega, fleet_counts=fleet_counts, fleet=fleet)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    import beluga_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)
    from beluga_tpu_torch.ops import _build
    from beluga_tpu_torch.tools import workloads

    # float32 products in full precision, stated rather than assumed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernels against their plain versions, on the card
    dev = torch.device("cuda")
    k_main, w = check_reweight(2000, dev, iters=200)
    r_main, rc_main = check_resample(2000, w, dev, iters=200)
    k_big, w = check_reweight(LARGE_N, dev, iters=50)
    r_big, rc_big = check_resample(LARGE_N, w, dev, iters=50)
    c_big = check_codebook16(LARGE_N, w, iters=50)
    k_fleet, w = check_reweight(FLEET_N, dev, iters=50, batch=FLEET_B)
    r_fleet, rc_fleet = check_resample(FLEET_N, w, dev, iters=50)
    c_fleet = check_codebook16(FLEET_N, w, iters=50)
    del w
    p_fleet = check_pool_take(FLEET_B, 512, FLEET_N, dev, iters=200)
    p_big = check_pool_take(None, 4096, LARGE_N, dev, iters=50)
    p_mega = check_pool_take(None, 512, 4096, dev, iters=200)
    d_fleet = check_pool_draw(FLEET_B, 512, FLEET_N, dev, iters=200)
    d_big = check_pool_draw(None, 4096, LARGE_N, dev, iters=50)
    d_mega = check_pool_draw(None, 512, 4096, dev, iters=200)
    est_bench = check_estimate((NDT_BENCH_ROBOTS,), NDT_BENCH_PARTICLES, dev, iters=20)
    est_fleet = check_estimate((FLEET_B,), FLEET_N, dev, iters=100)
    est_node = check_estimate((), 2000, dev, iters=200)
    est_mega = check_estimate((), MEGA_N, dev, iters=50)
    sort_bench = check_sort((NDT_BENCH_ROBOTS,), NDT_BENCH_PARTICLES, dev, iters=20, cut=True)
    sort_node = check_sort((), 2000, dev, iters=200)
    r_mega, rc_mega = check_resample(MEGA_N, resample_inputs(MEGA_N, dev), dev, iters=20)
    # the sorted positions' running sum at the fleet's, the node's, the sparse
    # node's and the large residual filter's shapes (M + 1 uniforms a filter)
    rs_fleet = check_running_sum((FLEET_B,), FLEET_N + 1, dev, iters=50)
    rs_node = check_running_sum((), 2001, dev, iters=200)
    rs_sparse = check_running_sum((), SPARSE_NODE_PARTICLES + 1, dev, iters=100)
    rs_large = check_running_sum((), LARGE_N + 1, dev, iters=50)
    rs_mega = check_running_sum((), MEGA_N, dev, iters=20)  # the sharded CDF's local sums
    w_big = check_winlut(dev, iters=50)
    f_mega = check_fused_step(MEGA_N, dev, iters=20)
    f_ragged = check_fused_step(MEGA_N - 1000, dev, iters=5)
    f_l2 = check_fused_step(workloads.WINDOWED_N, dev, iters=20, table="windowed")
    s_node = check_sphere_trace(dev, iters=100, long_range=False)
    s_long = check_sphere_trace(dev, iters=100, long_range=True)
    s_wide = check_sphere_trace(dev, iters=20, long_range=False, n_beams=1000)
    l_fleet, o_fleet = check_beam_lut(dev, iters=50, which="fleet")
    l_node, o_node = check_beam_lut(dev, iters=100, which="node")
    c_node = check_raycast(dev, iters=100, which="node")
    c_build = check_raycast(dev, iters=10, which="lut_build")
    c_long = check_raycast(dev, iters=50, which="long_range")
    c_l2 = check_raycast(dev, iters=50, which="l2")
    c_record = check_raycast(dev, iters=100, which="record")
    e_node = check_beam_exact(dev, iters=100, which="node")
    e_l2 = check_beam_exact(dev, iters=50, which="l2")
    g_shared = check_scan_lut(dev, iters=20, sampling="nearest", downsample=2)
    g_full = check_scan_lut(dev, iters=10, sampling="bilinear", downsample=1)
    k_log_node, _ = check_reweight(2000, dev, iters=200, log_space=True)
    k_log_fleet, w = check_reweight(FLEET_N, dev, iters=50, batch=FLEET_B, log_space=True)
    c_log_fleet = check_codebook16(FLEET_N, w, iters=50, log_space=True)
    del w
    i_big = check_winlut_int8(dev, iters=50)
    ws_big = check_winlut_states(dev, iters=50)
    ws_int8 = check_winlut_states(dev, iters=50, table_dtype="int8")
    wc_big = check_winlut_coverage(dev, iters=50)
    wc_edge = check_winlut_coverage(dev, iters=20, shift=12.0)
    wc_fleet = check_winlut_coverage_fleet(dev, iters=50)
    n_fleet = check_ndt_probe(dev, iters=20, dim=2)
    n_3d = check_ndt_probe(dev, iters=20, dim=3)
    f_node = check_ndt_weights(dev, iters=50, which="node")
    f_fleet = check_ndt_weights(dev, iters=20, which="fleet")
    f_3d = check_ndt_weights(dev, iters=20, which="3d")
    f_bench = check_ndt_weights(dev, iters=10, which="bench")
    torch.cuda.empty_cache()
    v_bench = check_codebook_lookup(dev, iters=20, volume="bench")
    v_floor = check_codebook_lookup(dev, iters=20, volume="floor")
    torch.cuda.empty_cache()
    checked = (k_main, r_main, rc_main, k_big, r_big, rc_big, c_big, k_fleet, r_fleet, rc_fleet,
               c_fleet, p_fleet, p_big, p_mega, d_fleet, d_big, d_mega, est_bench, est_fleet,
               est_node, est_mega, sort_bench, sort_node, r_mega, rc_mega,
               rs_fleet, rs_node, rs_sparse, rs_large, rs_mega, w_big,
               ws_big, ws_int8, wc_big, wc_edge, wc_fleet, f_mega, f_ragged, f_l2,
               s_node, s_long, s_wide, l_fleet, l_node,
               o_fleet, o_node, c_node, c_build, c_long, c_l2, c_record, e_node, e_l2,
               g_shared, g_full, k_log_node, k_log_fleet, c_log_fleet, i_big, n_fleet,
               n_3d, f_node, f_fleet, f_3d, f_bench, v_bench, v_floor)
    ms = lambda v: "not measured" if v is None else f"{v:.5f} ms"  # noqa: E731
    for k in checked:
        lib = "" if k["library_ms"] is None else (
            f", library {ms(k['library_ms'])} (device {ms(k['library_device_ms'])})")
        extra = "".join(f", {key} {k[key]}" for key in (
            "max_rel_err", "outside_rtol_share", "live_cells", "hit_share", "library_note",
            "max_abs_err_float64", "rows_moved_from_plain", "misses", "covered",
            "launches_per_call", "probe", "index_box", "strays",
            "stray_flags_differ_from_plain") if key in k)
        if "search_ms" in k:
            extra += (f"; by binary search {ms(k['search_ms'])} (device "
                      f"{ms(k['search_device_ms'])})")
        if "device_ms_each" in k:
            extra += "; device, one call alone (ms) " + json.dumps(k["device_ms_each"])
        if "device_launches_seen" in k:
            extra += f"; device: median of the {k['device_launches_seen']} launches recorded"
        if "variants" in k:
            extra += "; by variant " + json.dumps(k["variants"])
        if "model_ms" in k:
            extra += (f"; the model's call {ms(k['model_ms'])} (device "
                      f"{ms(k['model_device_ms'])}, {k['model_launches']} launches and "
                      f"{k['model_copies']} copies a call)")
        if "tf_entry_ms" in k:
            extra += (f"; transform entry {ms(k['tf_entry_ms'])} (device "
                      f"{ms(k['tf_entry_device_ms'])}; plain {ms(k['tf_entry_plain_ms'])})")
        if "cdf_device_ms" in k:
            extra += (f"; device: CDF build {ms(k['cdf_device_ms'])}, search "
                      f"{ms(k['search_device_ms'])}, whole {ms(k['device_ms'])}; old path "
                      f"(torch.cumsum + torch.cummax, then the search) {ms(k['old_path_ms'])}"
                      f" (device {ms(k['old_path_device_ms'])}, its CDF "
                      f"{ms(k['old_cdf_device_ms'])})")
        print(f"kernel {k['name']} {k['shape']}: {ms(k['ms'])} (device {ms(k['device_ms'])};"
              f" plain {ms(k['plain_ms'])}, device {ms(k['plain_device_ms'])};"
              f" bound {ms(k['bound_ms'])} by {k['bound_by']}{lib}),"
              f" max abs err {k['max_abs_err']}{extra}")
    print("all-shape kernels: " + json.dumps({"kernels": checked}))

    # 4. the node at nav2 defaults (slice 1's main path)
    node_counts, node = run_node(dev)
    print("node: " + json.dumps(node) + " launches " + json.dumps(node_counts))

    # 20. the node's raw input: synchronous, pipelined, point clouds (slice 13);
    # 21. record -> localize; both run here, while the profiler still records
    # every launch of a window
    import tempfile

    from beluga_tpu_torch.io import native

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    print(f"host IO: native forms {native.native_available()} ({native.library_path().name})")
    raw_counts, raw_est = {}, {}
    with tempfile.TemporaryDirectory(dir=build_dir) as workdir:
        map_yaml = workloads.arena_map_yaml(workdir)
        raw = workloads.arena_ranges(RAW_SCANS + RAW_PROFILED + RAW_SYNC_CHECKED)
        for mode in ("sync", "pipelined", "cloud"):
            raw_counts[mode], raw_node, raw_est[mode] = run_raw_node(dev, map_yaml, raw, mode,
                                                                     smi)
            print(f"raw node {mode}: " + json.dumps(raw_node) + " launches "
                  + json.dumps(raw_counts[mode]))
        both = sorted(set(raw_est["sync"]) & set(raw_est["pipelined"]))
        check(len(both) >= len(raw_est["sync"]) - 1, "raw node: the modes updated apart")
        diff = max(float(np.abs(raw_est["pipelined"][t] - raw_est["sync"][t]).max())
                   for t in both)
        print(f"raw node: pipelined estimates against the synchronous ones shifted by one scan,"
              f" largest difference {diff} over {len(both)} scans")
        replay_counts, replay = run_replay(dev, map_yaml, workdir)
        print("replay: " + json.dumps(replay) + " launches " + json.dumps(replay_counts))

        # 25. the raw node at max_particles 10000: the sparse cluster estimate
        # (slice 14), while the profiler still records every launch
        sparse_counts, sparse_node, _ = run_raw_node(dev, map_yaml, raw, "sync", smi,
                                                     max_particles=SPARSE_NODE_PARTICLES)
        no_waits_in(sparse_node["sync_sites"], SPARSE_FILES, "sparse-estimate node")
        sparse_node["cluster"] = check_cluster_sparse(dev)
        print("sparse-estimate node: " + json.dumps(sparse_node) + " launches "
              + json.dumps(sparse_counts))

    # 5. the large single filter, with its pooled recovery
    large_counts, large = no_cummax_on_b2(run_large_filter, "large filter", dev)
    print("large filter: " + json.dumps(large) + " launches " + json.dumps(large_counts))

    # 6. the fleet (slice 2's main path)
    fleet_counts, fleet = run_fleet(dev)
    print("fleet: " + json.dumps(fleet) + " launches " + json.dumps(fleet_counts))

    # 7. the mega filter (slice 3's headline path)
    mega_counts, mega = no_cummax_on_b2(run_mega, "mega", dev)
    print("mega: " + json.dumps(mega) + " launches " + json.dumps(mega_counts))

    # 8. the windowed filter (slice 3's gated path)
    win_counts, windowed = no_cummax_on_b2(run_windowed, "windowed", dev)
    print("windowed: " + json.dumps(windowed) + " launches " + json.dumps(win_counts))

    # 9. the beam node in each of its four modes (slice 4)
    beam_counts = {}
    for mode in workloads.BEAM_MODES:
        beam_counts[mode], beam = run_beam_node(dev, mode)
        print(f"beam node {mode}: " + json.dumps(beam) + " launches "
              + json.dumps(beam_counts[mode]))

    # 10. the long-range sphere-trace filter
    long_counts, long_range = run_long_range(dev)
    print("long range: " + json.dumps(long_range) + " launches " + json.dumps(long_counts))

    # 11. the windowed beam fleet (slice 4's fleet path)
    bfleet_counts, bfleet = run_beam_fleet(dev)
    print("beam fleet: " + json.dumps(bfleet) + " launches " + json.dumps(bfleet_counts))

    # 12. the node with nav2's probability model (slice 5)
    prob_counts, prob = run_prob_node(dev)
    print("prob node: " + json.dumps(prob) + " launches " + json.dumps(prob_counts))

    # 13. the shared-scan filter, its LUT built by B9 for every scan (slice 5)
    shared_counts, shared = run_shared_scan(dev)
    print("shared scan: " + json.dumps(shared) + " launches " + json.dumps(shared_counts))

    # 14. the fleet in the probability model's codebook16 mode (slice 5)
    pfleet_counts, pfleet = run_fleet(dev, scans=PROB_FLEET_SCANS, prob_model=True)
    print("prob fleet: " + json.dumps(pfleet) + " launches " + json.dumps(pfleet_counts))

    # 15. the windowed filter on int8 window tables (slice 5)
    int8_counts, int8 = run_windowed(dev, WINDOWED_INT8_SCANS, table_dtype="int8")
    print("windowed int8: " + json.dumps(int8) + " launches " + json.dumps(int8_counts))

    # 16. the NDT node on the 2D NDT map (slice 6)
    ndt_counts, ndt = run_ndt_node(dev)
    print("NDT node: " + json.dumps(ndt) + " launches " + json.dumps(ndt_counts))

    # 17. the NDT fleet (slice 6)
    nfleet_counts, nfleet = run_ndt_fleet(dev)
    print("NDT fleet: " + json.dumps(nfleet) + " launches " + json.dumps(nfleet_counts))

    # 18. the NDT-3D node on the 3D NDT map (slice 6)
    ndt3_counts, ndt3 = run_ndt3d_node(dev)
    print("NDT-3D node: " + json.dumps(ndt3) + " launches " + json.dumps(ndt3_counts))

    # 19. the VDB filter, BASELINE config #4 (slice 6)
    vdb_counts, vdb = run_vdb(dev)
    print("VDB filter: " + json.dumps(vdb) + " launches " + json.dumps(vdb_counts))

    # 22. the node with nav2's omni motion model, strafing the circle (slice 14)
    omni_counts, omni = run_node(
        dev, OMNI_SCANS, "omni node",
        scans_fn=lambda n: workloads.arena_scans(n, yaw_offset=math.pi / 2),
        robot_model_type="nav2_amcl::OmniMotionModel")
    print("omni node: " + json.dumps(omni) + " launches " + json.dumps(omni_counts))

    # 23. the stationary node, every update forced at one pose (slice 14)
    still_counts, still = run_node(dev, STATIONARY_SCANS, "stationary node",
                                   scans_fn=workloads.still_scans, forced=True,
                                   robot_model_type="stationary")
    check(still["valid"] == STATIONARY_SCANS, "stationary node: a forced update gated out")
    print("stationary node: " + json.dumps(still) + " launches " + json.dumps(still_counts))

    # 24. residual resampling: the large filter and the fleet (slice 14)
    last = {}
    rlarge_counts, rlarge = no_cummax_on_b2(run_large_filter, "large filter residual", dev,
                                            resampling="residual",
                                            sync_tail=RESIDUAL_SYNC_CHECKED, keep=last)
    no_waits_in(rlarge["sync_sites"], RESIDUAL_FILES, "large filter residual")
    # the last weights resampled once more: every particle at least floor(M·w) times
    rlarge["floor_copies_min_slack"] = residual_floor_check(last["weights"],
                                                            "large filter residual")
    print("large filter residual: " + json.dumps(rlarge) + " launches "
          + json.dumps(rlarge_counts))
    rfleet_counts, rfleet = no_cummax_on_b2(run_fleet, "fleet residual", dev,
                                            scans=RESIDUAL_FLEET_SCANS, resampling="residual",
                                            sync_tail=RESIDUAL_SYNC_CHECKED, keep=last)
    no_waits_in(rfleet["sync_sites"], RESIDUAL_FILES, "fleet residual")
    rfleet["floor_copies_min_slack"] = residual_floor_check(last["weights"], "fleet residual")
    print("fleet residual: " + json.dumps(rfleet) + " launches " + json.dumps(rfleet_counts))

    # 26. the winlut fleet: one shared windowed LUT for 64 filters (slice 14)
    wfleet_counts, wfleet = no_cummax_on_b2(run_winlut_fleet, "winlut fleet", dev)
    print("winlut fleet: " + json.dumps(wfleet) + " launches " + json.dumps(wfleet_counts))

    # the landmark and bearing models and the unscented transform (slice 14)
    print("landmarks: " + json.dumps(run_landmarks(dev)))

    # 29. four paths twice from the same generators: the same bits (slice 16)
    t0 = time.perf_counter()
    repeat = run_repeatable(dev)
    print(f"repeatable ({time.perf_counter() - t0:.1f} s): " + json.dumps(repeat))

    # 30. the three examples on the card (slice 16)
    t0 = time.perf_counter()
    examples = run_examples(dev)
    print(f"examples ({smi}, {time.perf_counter() - t0:.1f} s): " + json.dumps(examples))

    # 27-28. the sharded mega filter and fleet, the sharded checkpoint and
    # the pod run over torch.distributed (slice 15): one rank a visible
    # card, over NCCL; in this process at one card, else one process a card
    import torch.distributed as dist

    from beluga_tpu_torch.parallel import multihost

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    if world == 1:
        with tempfile.TemporaryDirectory(dir=build_dir) as store:
            rank_dev = multihost.start_process_group("cuda", 0, 1, f"file://{store}/store",
                                                     SHARDED_TIMEOUT)
            try:
                sharded = sharded_phases(0, 1, rank_dev)
            finally:
                dist.destroy_process_group()
    else:
        sharded = multihost.spawn_ranks(sharded_phases, world, "cuda", timeout=SHARDED_TIMEOUT)
    print(f"sharded phases: {world} rank(s) over NCCL in {time.perf_counter() - t0:.1f} s")
    print(f"mega sharded ({smi}): " + json.dumps(sharded["mega"]) + " launches "
          + json.dumps(sharded["mega_counts"]))
    print(f"fleet sharded ({smi}): " + json.dumps(sharded["fleet"]) + " launches "
          + json.dumps(sharded["fleet_counts"]))

    # each kernel at the shapes and with the launches of the newest main
    # path that runs it: B1 the windowed filter's (tail and fallback), B2
    # and B3's draw entry the mega filter's where its selective resampling
    # fired, else the windowed filter's (the draw entry's other shapes under
    # "other_shapes"), B4 the fleet's, B5 the mega filter's, B6's states
    # and coverage entries the windowed filter's (B6-int8's states entry the
    # int8 windowed filter's); B3's row entry and B6's coordinates entries,
    # on no main path since their new entries came, show their launches
    # summed over every main path (0); B7 and R1 the beam fleet's (R1 in its LUT build;
    # B7 and its window origins also the beam node's windowed mode's),
    # B8 the long-range filter's and the beam node's (the beam node's entry
    # also holds, under "other_shapes", a 1000-beam scan that no main path
    # gives it), B1-log the prob node's, B4-log the prob fleet's, B9 the
    # shared-scan filter's, the fused
    # NDT kernel the NDT node's, the NDT fleet's and the NDT-3D node's,
    # B11 the VDB filter's; B10, the standalone probe
    # (``NdtMap.lookup_gaussians``), is on no main path since the fused
    # kernel took the NDT model's probe: its entries show its launches
    # summed over every main path
    by_path = {"node": node_counts, "large": large_counts, "fleet": fleet_counts,
               "mega": mega_counts, "windowed": win_counts,
               **{f"beam_node_{m}": c for m, c in beam_counts.items()},
               "long_range": long_counts, "beam_fleet": bfleet_counts,
               "prob_node": prob_counts, "shared_scan": shared_counts,
               "prob_fleet": pfleet_counts, "windowed_int8": int8_counts,
               "ndt_node": ndt_counts, "ndt_fleet": nfleet_counts, "ndt3d_node": ndt3_counts,
               "vdb": vdb_counts, **{f"raw_node_{m}": c for m, c in raw_counts.items()},
               **replay_counts, "omni_node": omni_counts, "stationary_node": still_counts,
               "large_residual": rlarge_counts, "fleet_residual": rfleet_counts,
               "sparse_node": sparse_counts, "winlut_fleet": wfleet_counts,
               "mega_sharded": sharded["mega_counts"], "fleet_sharded": sharded["fleet_counts"]}
    for path, c in by_path.items():
        for name in OFF_MAIN_PATHS:  # B3 and B6 go through their new entries
            check(c[name] == 0, f"{path}: {name} launched {c[name]} times")
        # every map of a main path fits the fused NDT kernel's cell index
        check(c[NDT_INDEXED] == c["B10-fused ndt_weights"],
              f"{path}: {c[NDT_INDEXED]} of {c['B10-fused ndt_weights']} fused NDT launches "
              f"by the cell index")
        # B2 once a resample, one launch: past one tile a filter the CDF kernel
        # then the search (the CDF once a search), at one tile the one-tile
        # entry and no CDF; the sorted positions' running sum at most once a
        # resample (once a multinomial one, once a residual one's two passes,
        # never a systematic one)
        check(c[B2_CDF] == c[B2_SEARCH],
              f"{path}: {c[B2_CDF]} CDF builds for {c[B2_SEARCH]} searches")
        check(c[B2_SEARCH] == 0 or c[B2_TILE] == 0,
              f"{path}: {c[B2_SEARCH]} searches and {c[B2_TILE]} one-tile launches")
        check(c[RUNNING_SUM] <= c[RESAMPLES],
              f"{path}: {c[RUNNING_SUM]} running sums for {c[RESAMPLES]} resamples")
        # every reweight of a main path composes its transform in the kernel
        reweights = sum(c[name] for name in REWEIGHT_KERNELS)
        check(c[REWEIGHT_STATES] == reweights,
              f"{path}: {c[REWEIGHT_STATES]} of {reweights} reweights through the states entry")
    resampled = mega_counts[B2_SEARCH] > 0
    timed = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
             "plain_device_ms", "library_device_ms", "shape")
    mega_drew = mega_counts[POOL_DRAW] > 0
    d_main = d_mega if mega_drew else d_big
    kernels = []
    for k, path in ((k_big, "windowed"), (r_mega if resampled else r_big,
                                          "mega" if resampled else "windowed"),
                    (rc_mega if resampled else rc_big, "mega" if resampled else "windowed"),
                    (r_main, "node"), (rs_fleet, "fleet"),
                    (d_main, "mega" if mega_drew else "windowed"), (p_big, None),
                    (c_fleet, "fleet"), (f_mega, "mega"), (w_big, None), (ws_big, "windowed"),
                    (wc_big, "windowed"), (i_big, None), (ws_int8, "windowed_int8"),
                    (l_fleet, "beam_fleet"), (l_node, "beam_node_windowed"),
                    (o_fleet, "beam_fleet"), (o_node, "beam_node_windowed"), (s_long, "long_range"),
                    (s_node, "beam_node_sphere_trace"), (c_build, "beam_fleet"),
                    (e_node, "beam_node_exact"),
                    (k_log_node, "prob_node"), (c_log_fleet, "prob_fleet"),
                    (g_shared, "shared_scan"),
                    (n_fleet, None), (n_3d, None), (f_node, "ndt_node"),
                    (f_fleet, "ndt_fleet"), (f_3d, "ndt3d_node"), (v_bench, "vdb")):
        entry = {key: k[key] for key in ("name", "route", "source", "replaces")}
        entry["launches"] = (by_path[path][k["name"]] if path
                             else sum(c[k["name"]] for c in by_path.values()))
        entry.update({key: k[key] for key in timed})
        if k is s_node:
            entry["other_shapes"] = [{key: s_wide[key] for key in timed}]
        if k is wc_big:  # the origin clamped at the map's edge; the winlut fleet's gate
            entry["other_shapes"] = [{key: wc_edge[key] for key in timed},
                                     {**{key: wc_fleet[key] for key in timed},
                                      "path": "winlut_fleet",
                                      "launches": by_path["winlut_fleet"][wc_fleet["name"]],
                                      "device_launches_seen": wc_fleet["device_launches_seen"]}]
        if k is d_main:  # the fleet's pools and the other single filter's
            entry["other_shapes"] = [{key: d[key] for key in timed}
                                     for d in (d_fleet, d_big if mega_drew else d_mega)]
        if k is p_big:
            entry["other_shapes"] = [{key: p[key] for key in timed} for p in (p_fleet, p_mega)]
        if k is rs_fleet:  # the node's, the sparse node's and the large residual filter's
            entry["other_shapes"] = [
                {**{key: r[key] for key in timed}, "path": path,
                 "launches": by_path[path][RUNNING_SUM]}
                for r, path in ((rs_node, "node"), (rs_sparse, "sparse_node"),
                                (rs_large, "large_residual"), (rs_mega, "mega_sharded"))]
        if k is r_main:  # the one-tile entry at the fleet's 64 x 4096
            entry["other_shapes"] = [{**{key: r_fleet[key] for key in timed}, "path": "fleet",
                                      "launches": by_path["fleet"][B2_TILE]}]
        if k is f_mega:  # the L2 branch of the same kernel
            entry["other_shapes"] = [{key: f_l2[key] for key in timed}]
        if k is f_fleet:  # the benchmark's shape
            entry["other_shapes"] = [{key: f_bench[key] for key in timed}]
        if k is c_build:  # the ray entry's other maps, the last through L2
            entry["device_ms_each"] = c_build["device_ms_each"]
            entry["other_shapes"] = [{key: c[key] for key in (*timed, "device_ms_each")}
                                     for c in (c_node, c_long, c_l2, c_record)]
        if k is e_node:
            entry.update(variants=e_node["variants"], device_ms_each=e_node["device_ms_each"],
                         other_shapes=[{key: e_l2[key] for key in
                                        (*timed, "variants", "device_ms_each")}])
        if "tf_entry_ms" in k:
            entry.update({key: k[key] for key in k if key.startswith("tf_entry_")})
        entry.update({key: k[key] for key in k if key.startswith("model_")})
        if any(k is x for x in (d_main, ws_big, ws_int8, wc_big)):
            entry["device_launches_seen"] = k["device_launches_seen"]
        entry.update({key: k[key] for key in ("launches_per_call", "library_note") if key in k})
        if k in (r_mega, r_big, r_main):
            entry.update({key: k[key] for key in (
                "cdf_device_ms", "search_device_ms", "old_path_ms", "old_path_device_ms",
                "old_cdf_device_ms")})
        entry["path"] = path
        entry["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
