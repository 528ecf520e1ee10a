// Kernel B2: the whole resample_take, from the weights to the donor rows.
//
// Replaces beluga_tpu/ops/pallas_resample.py:resample_take, its CDF build
// (:405-412: cumsum, divide by the total, cummax) and its search and donor
// copy (the pallas_call at :495; its small, blocked, huge and pipelined
// variants are schedules for the TPU's VMEM).  Input, for each of `batch`
// filters: weights f32[N], positions f32[M] and the particle state as
// planes f32[D, N].  Three entries, one kernel launch each:
//
// 1. The monotone CDF (beluga_cdf): cdf[k] = m[k] / T, where s is a
//    float32 inclusive prefix sum of the weights, m[k] = max of s[j] over
//    j <= k with w[j] > 0 (0 before the first live slot) and T = m[N-1]
//    (at least 1e-38).  Taking the running maximum over live slots only
//    makes every zero-weight slot's interval empty by construction:
//    m[k] == m[k-1] exactly, whatever order the sum was taken in.  The
//    maximum is exact in any order, and rounding is monotone, so max(s)/T
//    == max(s/T) and fl(o + max l) == max fl(o + l): the maximum can be
//    taken on local prefixes and offset afterwards.  The last live slot's
//    entry is T/T = 1 exactly.  Without `normalize` the kernel writes m
//    itself, the running sum that the sorted positions (the spacings of
//    ops/resample.py) and the sharded CDF (parallel/collectives.py) divide
//    themselves; both modes run the same code, so m / T there has the
//    normalized CDF's bits.
//
//    The sum is reduce-then-scan over tiles of kTile weights, one launch at
//    every length.  A block scans a tile (a thread owns kItems consecutive
//    weights and sums them in order; the threads' totals are scanned by
//    warp shuffles, then across warps), which gives the tile's sum A and
//    its largest live local prefix M.  A filter of one tile (the node's
//    2000, the fleets' 4096) is a block of its own and writes at once
//    (cdf_tile_kernel).  Past one tile (cdf_grid_kernel) every block
//    publishes its tile's (A, M), waits for the partials its entries need,
//    derives its tile's offset O, carry and the filter's total T from them
//    with the same code as every other block, and writes its entries: the
//    normalized CDF needs T and so every tile of its filter, the running
//    sum only the tiles before its own.  Every sum is taken in this fixed
//    order, the same association as the two-launch reduce-then-scan this
//    kernel replaced (up to 32 tiles and past 128: the same bits), so equal
//    inputs give equal bits on every launch.
//
//    The wait is on flags, not on a grid barrier: each tile's partials are
//    published with one 16-byte store, tagged with the call's epoch, and a
//    block reads the partials it needs by polling them (flags below).  A
//    flag costs one L2 round trip between the writer and the reader,
//    where cooperative_groups' grid barrier costs an atomic and a spin on
//    one counter, then another read of the partials (PERF.md §6);
//    the running sum's blocks wait only for the tiles before them, and no
//    flag needs a reset, so no second launch.  Thread block clusters share
//    partials faster still but hold at most 16 tiles, and their barriers
//    cost more than the flags at 2 and 3 tiles.  The launch is cooperative
//    all the same, so that every block is resident while others wait for
//    it: the grid holds every (filter, tile) where the card holds that many
//    blocks (2^21 weights: 512 tiles on 132 SMs at kGridBlocksPerSm), each
//    keeping its weights in registers across the wait; past that blocks
//    loop over tiles and read them again after the wait.  A refused
//    launch returns its error, which the wrapper raises.
// 2. The search and donor copy (beluga_resample_take) on a given CDF: for
//    each position u the donor is the first k with cdf[k] > u
//    (searchsorted side='right'), so a zero-weight slot is never chosen;
//    row q of out f32[M, D] gets a bit-exact copy of the donor's D values;
//    a position at or above cdf[N-1] (the padding value 1.5, or any
//    position when every weight is zero) gets a zero row.  A block takes
//    kChunk positions and brackets their donors with two 32-ary warp
//    searches (its smallest and largest position, ~log32(N) dependent
//    reads each); when the bracket holds at most kWindow CDF entries
//    (sorted positions: systematic, stratified and sorted multinomial) it
//    stages them in shared memory and each thread searches there;
//    otherwise (unsorted positions over a long CDF) each thread searches
//    the bracket in global memory.  Either way the answer is the same
//    first index.
// 3. The whole function where a filter fits one tile (N <= kTile:
//    beluga_resample_take_tile): each block scans its filter's weights into
//    shared memory with cdf_tile_kernel's code and block shape, so its CDF
//    has the CDF entry's bits and every block of a filter holds the same
//    one, then searches its positions there and copies the donors as entry
//    2 does: one launch where entries 1 and 2 took two, and no search
//    through global memory.
//
// What bounds it on an H100: the bytes.  The whole function must read the
// N weights, the M positions and D*N state values and write M*D values;
// the CDF (4N written, read back by the search) stays mostly in the 50 MB
// L2 at N = 2^21.  At the main paths' sizes a call is a few microseconds
// of dependent steps (a load, two block scans, a flag, a store), so what
// the design removes is launches and trips to memory: one launch a CDF
// (two past one tile before), the weights read once where the grid holds
// every tile, and at one tile no CDF launch and no bracket search.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// -- the scan ---------------------------------------------------------------

constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kScanThreads * kItems;  // weights a block scans

struct Carry {
  float offset;  // O_b, this tile's offset
  float before;  // C_b = max over live tiles j < b of fl(O_j + M_j) (0 if none)
  float total;   // T, the same over every live tile
};

struct ScanShared {
  float warp[2][kScanWarps];  // the warps' totals, one array a scan in turn
  Carry carry;                // the tile's, from the partials
};

// Kogge-Stone over the lanes of a warp: the inclusive sum (or maximum), in
// one fixed association.  Where only the first `span` lanes (a power of
// two) can hold values other than 0, the rounds past it are skipped: they
// would add nothing to those lanes.
__device__ __forceinline__ float warp_sum(float x, int span = 32) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= span) break;
    const float o = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = __fadd_rn(o, x);
  }
  return x;
}

__device__ __forceinline__ float warp_max(float y, int span = 32) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= span) break;
    const float o = __shfl_up_sync(kFull, y, d);
    if (lane >= d) y = fmaxf(o, y);
  }
  return y;
}

// The least power of two at least k (k <= 32).
__device__ __forceinline__ int span_of(int k) { return k <= 1 ? 1 : 1 << (32 - __clz(k - 1)); }

// The lane before's value of an inclusive scan (0 at lane 0).
__device__ __forceinline__ float exclusive(float inclusive) {
  const float e = __shfl_up_sync(kFull, inclusive, 1);
  return (threadIdx.x & 31) == 0 ? 0.0f : e;
}

struct Scanned {
  float before;  // exclusive prefix of the block's threads, in a fixed order
  float all;     // the block's total
};

// Block-wide exclusive prefix sum (kMax: maximum, 0 where empty) of x, in a
// fixed order: Kogge-Stone over each warp's lanes, then every warp runs the
// same Kogge-Stone over the warps' totals, so every block computes
// bit-equal results from equal inputs, with one barrier.  Every thread of
// the block must call it; calls alternate `slot` (the array a call writes
// is read only before the next call's barrier).
template <bool kMax>
__device__ __forceinline__ Scanned block_scan(float x, float* slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float in = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 31) slot[warp] = in;
  __syncthreads();
  const float w = lane < kScanWarps ? slot[lane] : 0.0f;
  const float win = kMax ? warp_max(w, kScanWarps) : warp_sum(w, kScanWarps);
  const float before = __shfl_sync(kFull, exclusive(win), warp);
  const float all = __shfl_sync(kFull, win, kScanWarps - 1);
  const float ex = exclusive(in);
  return {kMax ? fmaxf(before, ex) : __fadd_rn(before, ex), all};
}

// The weights of this thread (0 past `count`): kItems consecutive floats
// from w[at].
__device__ __forceinline__ void load_items(const float* __restrict__ w, int count, int at,
                                           float (&v)[kItems]) {
  if (at + kItems <= count && (reinterpret_cast<uintptr_t>(w + at) & 15) == 0) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(w + at));
    const float4 b = __ldg(reinterpret_cast<const float4*>(w + at + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] = at + i < count ? __ldg(w + at + i) : 0.0f;
}

// The tile's local scan, the same code in every entry: each weight's local
// prefix is l_i = fl(P + r_i), r the thread's running sum, P the thread's
// exclusive offset.  Per thread, `live` is fl(P + r of its last live slot),
// the largest local prefix of its live slots (0 if none), since l grows
// with i; the scan of `live` gives the largest of the threads before it
// and the tile's largest, M.
struct TileScan {
  float p;            // the thread's offset P
  float live_before;  // the largest live local prefix of the threads before
  float sum;          // the tile's sum A
  float live_max;     // the tile's largest live local prefix M
};

__device__ TileScan tile_scan(const float (&v)[kItems], ScanShared* sh) {
  float last_live = 0.0f;
  float run = 0.0f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    run = i == 0 ? v[0] : __fadd_rn(run, v[i]);
    if (v[i] > 0.0f) last_live = run;
  }
  // the offsets first; each thread's live maximum needs its offset
  const Scanned sums = block_scan<false>(run, sh->warp[0]);
  const float live = last_live > 0.0f ? __fadd_rn(sums.before, last_live) : 0.0f;
  const Scanned lives = block_scan<true>(live, sh->warp[1]);
  return {sums.before, lives.before, sums.all, lives.all};
}

// This thread's kItems CDF entries (undivided without `normalize`), stored
// at out[at...] below `count`: the running maximum of its live local
// prefixes fl(P + r_i), offset by the tile's O and joined with the carry.
// r_i is taken again from v in tile_scan's order, so it has tile_scan's
// bits.
__device__ __forceinline__ void store_entries(const float (&v)[kItems], float p,
                                              float live_before, Carry c, bool normalize,
                                              float* out, int count, int at) {
  const float denom = fmaxf(c.total, 1e-38f);
  float run = live_before;  // the largest live local prefix so far
  float r = 0.0f;
  float q[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    r = i == 0 ? v[0] : __fadd_rn(r, v[i]);
    if (v[i] > 0.0f) run = fmaxf(run, __fadd_rn(p, r));
    const float m = run > 0.0f ? fmaxf(c.before, __fadd_rn(c.offset, run)) : c.before;
    q[i] = normalize ? __fdiv_rn(m, denom) : m;
  }
  out += at;
  if (at + kItems <= count && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    reinterpret_cast<float4*>(out)[0] = make_float4(q[0], q[1], q[2], q[3]);
    reinterpret_cast<float4*>(out)[1] = make_float4(q[4], q[5], q[6], q[7]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (at + i < count) out[i] = q[i];
  }
}

// -- the partials of a filter of several tiles ------------------------------

// Tile b's offset, carry and the filter's total from its partials, by
// the whole block.  `read(j)` gives tile j's partials (A, M), or zeros for
// tiles the result does not depend on.  Every block runs this same code on
// the same partials, so every block derives the same O_j: a thread sums a
// run of `per` partials in order, the runs' totals are block-scanned, and
// each thread walks its run again from its offset (the run's first
// partial stays in a register; one a thread up to kScanThreads tiles).
// The carry is the exclusive maximum of the tiles' tops fl(O_j + M_j) over
// live tiles, T the maximum over all; the offset and carry depend only on
// the tiles before b.
template <class Read>
__device__ Carry block_carry(Read read, int tiles, int b, ScanShared* sh) {
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min(tiles, static_cast<int>(threadIdx.x) * per);
  const int hi = min(tiles, lo + per);
  const float2 first = lo < hi ? read(lo) : make_float2(0.0f, 0.0f);
  float sum = first.x;
  for (int j = lo + 1; j < hi; ++j) sum = __fadd_rn(sum, read(j).x);
  float off = block_scan<false>(sum, sh->warp[0]).before;
  float before = 0.0f, every = 0.0f, mine = 0.0f;
  for (int j = lo; j < hi; ++j) {
    const float2 p = j == lo ? first : read(j);
    if (j == b) mine = off;
    if (p.y > 0.0f) {
      const float top = __fadd_rn(off, p.y);
      every = fmaxf(every, top);
      if (j < b) before = fmaxf(before, top);
    }
    off = __fadd_rn(off, p.x);
  }
  const Scanned tops = block_scan<true>(every, sh->warp[1]);
  if (b >= lo && b < hi) sh->carry = {mine, fmaxf(tops.before, before), tops.all};
  __syncthreads();
  return sh->carry;
}

// Warp 0's form of block_carry for the few tiles of part[0, tiles) in
// shared memory: lane l sums a run of ceil(tiles / 32) partials in order,
// the runs' totals are scanned over the lanes, and each lane walks its run
// again from its offset (one partial a lane up to 32 tiles: block_carry's
// association).  The lane that holds tile b has its carry.
__device__ Carry warp_carry(const float2* part, int tiles, int b) {
  const int lane = threadIdx.x & 31;
  const int per = (tiles + 31) / 32;
  const int lo = min(tiles, lane * per);
  const int hi = min(tiles, lo + per);
  float sum = 0.0f;
  for (int j = lo; j < hi; ++j) sum = __fadd_rn(sum, part[j].x);
  const int span = span_of((tiles + per - 1) / per);  // the lanes with a run
  float off = exclusive(warp_sum(sum, span));
  float before = 0.0f, every = 0.0f, mine = 0.0f;
  for (int j = lo; j < hi; ++j) {
    const float2 p = part[j];
    if (j == b) mine = off;
    if (p.y > 0.0f) {
      const float top = __fadd_rn(off, p.y);
      every = fmaxf(every, top);
      if (j < b) before = fmaxf(before, top);
    }
    off = __fadd_rn(off, p.x);
  }
  const float tops = warp_max(every, span);
  return {mine, fmaxf(exclusive(tops), before), __shfl_sync(kFull, tops, span - 1)};
}

// Flags.  The partials travel as two tagged 64-bit words, (A, tag) and
// (M, tag), stored together by one relaxed 16-byte store and read together
// by one 16-byte load; a reader polls until both words carry the call's
// tag.  Filter f's scratch is 2 + 2 * tiles words: its epoch and a pad,
// then its tiles' pairs.  The call's tag is the epoch + 1; the block of the
// filter's last tile, which waits for every other tile's pair (and so
// knows every block of the filter has read the epoch), stores the tag as
// the next epoch.  No word is ever reset: a word of an earlier call
// carries an older tag.
__device__ __forceinline__ unsigned long long tagged(float x, unsigned tag) {
  return (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(x);
}

__device__ __forceinline__ unsigned long long get_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void put_epoch(unsigned long long* p, unsigned tag) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p),
               "l"(static_cast<unsigned long long>(tag))
               : "memory");
}

__device__ __forceinline__ void put_partials(unsigned long long* pair, float a, float m,
                                             unsigned tag) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};" ::"l"(pair), "l"(tagged(a, tag)),
               "l"(tagged(m, tag))
               : "memory");
}

// Tile j's partials (A, M) once its pair carries `tag`.
__device__ __forceinline__ float2 poll_partials(const unsigned long long* pairs, int j,
                                                unsigned tag) {
  unsigned long long a, m;
  do {
    asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(a), "=l"(m)
                 : "l"(pairs + 2 * j)
                 : "memory");
  } while (static_cast<unsigned>(a >> 32) != tag || static_cast<unsigned>(m >> 32) != tag);
  return make_float2(__uint_as_float(static_cast<unsigned>(a)),
                     __uint_as_float(static_cast<unsigned>(m)));
}

// -- entry 1: the CDF, one launch ------------------------------------------

// A filter of one tile: a block a filter, nothing to wait for.
__global__ void __launch_bounds__(kScanThreads) cdf_tile_kernel(
    const float* __restrict__ w, int n, bool normalize, float* __restrict__ cdf) {
  __shared__ ScanShared sh;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const int at = threadIdx.x * kItems;
  float v[kItems];
  load_items(w + base, n, at, v);
  const TileScan t = tile_scan(v, &sh);
  store_entries(v, t.p, t.live_before, {0.0f, 0.0f, t.live_max}, normalize, cdf + base, n, at);
}

// Filters of more tiles: `items` = tiles * filters (filter f's tile b is
// item f * tiles + b), a cooperative launch of gridDim.x <= items blocks.
// Up to kStage tiles the block's threads poll the partials into shared
// memory and warp 0 derives the carry (warp_carry); past that the threads
// poll their runs for block_carry.
constexpr int kGridBlocksPerSm = 4;  // 2^21 weights resident on 132 SMs
constexpr int kStage = 128;

__global__ void __launch_bounds__(kScanThreads, kGridBlocksPerSm) cdf_grid_kernel(
    const float* __restrict__ w, int n, int tiles, int items,
    unsigned long long* __restrict__ scratch, bool normalize, float* __restrict__ cdf) {
  __shared__ ScanShared sh;
  __shared__ float2 part[kStage];
  __shared__ unsigned s_tag;
  const size_t stride = 2 + 2 * static_cast<size_t>(tiles);
  const int at = threadIdx.x * kItems;
  float v[kItems];
  // every item's partials, tagged
  TileScan t = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int f = i / tiles, b = i - f * tiles, start = b * kTile;
    unsigned long long* words = scratch + f * stride;
    unsigned long long epoch = 0;
    if (threadIdx.x == 0) epoch = get_word(words);
    load_items(w + static_cast<size_t>(f) * n + start, n - start, at, v);
    if (threadIdx.x == 0) s_tag = static_cast<unsigned>(epoch) + 1;  // before the scan's barriers
    t = tile_scan(v, &sh);
    if (threadIdx.x == 0) put_partials(words + 2 + 2 * b, t.sum, t.live_max, s_tag);
  }
  // a block of its own for every item: its weights, scan and tag are still here
  const bool resident = items == static_cast<int>(gridDim.x);
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int f = i / tiles, b = i - f * tiles, start = b * kTile;
    const size_t base = static_cast<size_t>(f) * n + start;
    unsigned long long* words = scratch + f * stride;
    const unsigned long long* pairs = words + 2;
    if (!resident) {  // this item's tag is the one its pair carries
      if (threadIdx.x == 0) s_tag = static_cast<unsigned>(get_word(pairs + 2 * b) >> 32);
      load_items(w + base, n - start, at, v);
      t = tile_scan(v, &sh);
    }
    const unsigned tag = s_tag;
    const int limit = normalize ? tiles : b;  // the tiles this one's entries depend on
    Carry c;
    if (tiles <= kStage) {
      for (int j = threadIdx.x; j < tiles; j += kScanThreads) {
        part[j] = j < limit ? poll_partials(pairs, j, tag) : make_float2(0.0f, 0.0f);
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        const Carry mine = warp_carry(part, tiles, b);
        if (threadIdx.x == b / ((tiles + 31) / 32)) sh.carry = mine;
      }
      __syncthreads();
      c = sh.carry;
    } else {
      c = block_carry(
          [&](int j) { return j < limit ? poll_partials(pairs, j, tag) : make_float2(0.0f, 0.0f); },
          tiles, b, &sh);
    }
    // every wait on this filter's pairs is over (both branches end in a
    // barrier after the polls): its last tile passes the epoch on
    if (b == tiles - 1 && threadIdx.x == 0) put_epoch(words, tag);
    store_entries(v, t.p, t.live_before, c, normalize, cdf + base, n - start, at);
  }
}

// -- entry 2: search and donor copy on a CDF --------------------------------

constexpr int kSearchThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kSearchThreads * kPerThread;  // positions a block
constexpr int kWindow = 4096;                        // CDF entries staged

// First k in [lo, hi) with cdf[k] > u, else hi, by the whole warp: each
// round 32 lanes probe 32 evenly spaced entries and keep the span between
// the last probe at or below u and the first above it.
__device__ int warp_search(const float* __restrict__ cdf, int lo, int hi, float u) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int probe = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned above = __ballot_sync(kFull, __ldg(cdf + probe) > u);
    if (above == 0) return hi;  // lane 31 probed hi - 1
    const int f = __ffs(above) - 1;
    const int next_lo = f == 0 ? lo : min(lo + f * step - 1, hi - 1) + 1;
    hi = min(lo + (f + 1) * step - 1, hi - 1);  // cdf[hi] > u: the answer is at most hi
    lo = next_lo;
  }
  const int k = lo + lane;
  const unsigned above = __ballot_sync(kFull, k < hi && __ldg(cdf + k) > u);
  return above ? lo + __ffs(above) - 1 : hi;
}

// First k in [0, len) with c[k] > u, else len (c in global or shared memory).
template <bool kGlobal>
__device__ __forceinline__ int binary_search(const float* c, int len, float u) {
  int lo = 0;
  while (len > 0) {
    const int half = len >> 1;
    const int mid = lo + half;
    const float cm = kGlobal ? __ldg(c + mid) : c[mid];
    const bool right = !(cm > u);
    lo = right ? mid + 1 : lo;
    len = right ? len - half - 1 : half;
  }
  return lo;
}

// Row `row` f32[d] gets a bit-exact copy of donor k's values (planes
// f32[d, n]), or zeros when k == n (no donor).
__device__ __forceinline__ void copy_donor(const float* __restrict__ values, int n, int d, int k,
                                           float* __restrict__ row) {
  if (d == 4) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < n) {
      v.x = __ldg(values + k);
      v.y = __ldg(values + static_cast<size_t>(n) + k);
      v.z = __ldg(values + 2 * static_cast<size_t>(n) + k);
      v.w = __ldg(values + 3 * static_cast<size_t>(n) + k);
    }
    *reinterpret_cast<float4*>(row) = v;
    return;
  }
  for (int c = 0; c < d; ++c) {
    row[c] = k < n ? __ldg(values + static_cast<size_t>(c) * n + k) : 0.0f;
  }
}

__global__ void __launch_bounds__(kSearchThreads) resample_take_kernel(
    const float* __restrict__ cdf, int n, const float* __restrict__ positions, int m,
    const float* __restrict__ values, int d, float* __restrict__ out) {
  __shared__ float window[kWindow];
  __shared__ float red_min[kSearchThreads / 32], red_max[kSearchThreads / 32];
  __shared__ int bracket[2];
  const size_t f = blockIdx.y;
  cdf += f * n;
  values += f * d * n;
  out += f * d * m;
  positions += f * m;
  const int first = blockIdx.x * kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float u[kPerThread];
  float umin = CUDART_INF_F, umax = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int q = first + j * kSearchThreads + threadIdx.x;
    u[j] = q < m ? __ldg(positions + q) : 0.0f;
    if (q < m) {
      umin = fminf(umin, u[j]);
      umax = fmaxf(umax, u[j]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    umin = fminf(umin, __shfl_xor_sync(kFull, umin, off));
    umax = fmaxf(umax, __shfl_xor_sync(kFull, umax, off));
  }
  if (lane == 0) {
    red_min[warp] = umin;
    red_max[warp] = umax;
  }
  __syncthreads();
  umin = red_min[0];
  umax = red_max[0];
  for (int w = 1; w < kSearchThreads / 32; ++w) {
    umin = fminf(umin, red_min[w]);
    umax = fmaxf(umax, red_max[w]);
  }
  // every donor of this block lies in [lo, hi]
  if (warp < 2) {
    const int k = warp_search(cdf, 0, n, warp == 0 ? umin : umax);
    if (lane == 0) bracket[warp] = k;
  }
  __syncthreads();
  int lo = bracket[0], len = bracket[1] - bracket[0];
  if (len < 0) {  // a CDF that is not monotone: search all of it
    lo = 0;
    len = n;
  }
  const bool staged = len <= kWindow;
  if (staged) {
    for (int k = threadIdx.x; k < len; k += kSearchThreads) window[k] = __ldg(cdf + lo + k);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int q = first + j * kSearchThreads + threadIdx.x;
    if (q >= m) break;
    int k;
    if (!(u[j] >= umin && u[j] <= umax)) {
      k = binary_search<true>(cdf, n, u[j]);  // NaN: outside every bracket
    } else {
      k = lo + (staged ? binary_search<false>(window, len, u[j])
                       : binary_search<true>(cdf + lo, len, u[j]));
    }
    copy_donor(values, n, d, k, out + static_cast<size_t>(q) * d);
  }
}

// -- entry 3: the whole function at one tile a filter ------------------------

constexpr int kTakePerThread = 2;
constexpr int kTakeChunk = kScanThreads * kTakePerThread;  // positions a block

// n <= kTile.  The block's positions are loaded first, so that their reads
// overlap the weights' scan.
__global__ void __launch_bounds__(kScanThreads) resample_take_tile_kernel(
    const float* __restrict__ w, int n, const float* __restrict__ positions, int m,
    const float* __restrict__ values, int d, float* __restrict__ out) {
  __shared__ ScanShared sh;
  __shared__ __align__(16) float cdf[kTile];
  const size_t f = blockIdx.y;
  w += f * n;
  values += f * d * n;
  out += f * d * m;
  positions += f * m;
  const int first = blockIdx.x * kTakeChunk;
  float u[kTakePerThread];
#pragma unroll
  for (int j = 0; j < kTakePerThread; ++j) {
    const int q = first + j * kScanThreads + threadIdx.x;
    u[j] = q < m ? __ldg(positions + q) : 0.0f;
  }
  const int at = threadIdx.x * kItems;
  float v[kItems];
  load_items(w, n, at, v);
  const TileScan t = tile_scan(v, &sh);
  store_entries(v, t.p, t.live_before, {0.0f, 0.0f, t.live_max}, true, cdf, n, at);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTakePerThread; ++j) {
    const int q = first + j * kScanThreads + threadIdx.x;
    if (q >= m) break;
    copy_donor(values, n, d, binary_search<false>(cdf, n, u[j]),
               out + static_cast<size_t>(q) * d);
  }
}

// The launch's own error if it has one (clearing it, so that a later
// launch does not report it), else cudaGetLastError().
int launch_status(cudaError_t launched) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

}  // namespace

// The CDF tile size: a filter of more weights waits for the partials of
// its other tiles.
extern "C" int beluga_cdf_tile() { return kTile; }

// The co-resident blocks an SM of the CDF kernel's waiting form on the
// current device, into *out: a cooperative grid holds at most this times
// the SMs.
extern "C" int beluga_cdf_blocks_per_sm(int* out) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, cdf_grid_kernel, kScanThreads, 0));
}

// The monotone CDF of `batch` filters of n weights into cdf (with
// `normalize` 0, the running maximum m before the division) in one launch
// of `grid` blocks: with tiles = ceil(n / kTile) == 1 a plain launch of a
// block a filter (grid == batch), otherwise a cooperative one with grid <=
// tiles * batch and no more blocks than the card holds at once (else the
// launch is refused) and `scratch` u64[batch][2 + 2 * tiles], zero when
// first used and kept for the stream's later calls of the same tiles,
// unused when tiles == 1.  Returns the launch's error, or
// cudaGetLastError().
extern "C" int beluga_cdf(const void* w, int n, int batch, void* scratch, int normalize,
                          void* cdf, int grid, void* stream) {
  if (n == 0 || batch == 0) return 0;
  const float* wp = static_cast<const float*>(w);
  auto* words = static_cast<unsigned long long*>(scratch);
  bool norm = normalize != 0;
  float* out = static_cast<float*>(cdf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int tiles = (n + kTile - 1) / kTile;
  int items = tiles * batch;
  if (tiles == 1) {
    if (grid != batch) return static_cast<int>(cudaErrorInvalidValue);
    cdf_tile_kernel<<<grid, kScanThreads, 0, s>>>(wp, n, norm, out);
    return launch_status(cudaSuccess);
  }
  if (grid < 1 || grid > items) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&wp, &n, &tiles, &items, &words, &norm, &out};
  return launch_status(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cdf_grid_kernel),
                                                   dim3(grid), dim3(kScanThreads), args, 0, s));
}

// The search and donor copy on `stream` over `batch` filters; returns
// cudaGetLastError() of the launch.  `out` must be 16-byte aligned when
// d == 4 (PyTorch allocations are).
extern "C" int beluga_resample_take(const void* cdf, int n, const void* positions, int m,
                                    const void* values, int d, void* out, int batch,
                                    void* stream) {
  if (m == 0 || batch == 0) return 0;
  const dim3 grid((m + kChunk - 1) / kChunk, batch);
  resample_take_kernel<<<grid, kSearchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cdf), n, static_cast<const float*>(positions), m,
      static_cast<const float*>(values), d, static_cast<float*>(out));
  return launch_status(cudaSuccess);
}

// The whole function from the weights (n <= kTile, else
// cudaErrorInvalidValue) on `stream` over `batch` filters, one launch;
// `out` as for beluga_resample_take.
extern "C" int beluga_resample_take_tile(const void* w, int n, const void* positions, int m,
                                         const void* values, int d, void* out, int batch,
                                         void* stream) {
  if (m == 0 || batch == 0) return 0;
  if (n < 1 || n > kTile) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kTakeChunk - 1) / kTakeChunk, batch);
  resample_take_tile_kernel<<<grid, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), n, static_cast<const float*>(positions), m,
      static_cast<const float*>(values), d, static_cast<float*>(out));
  return launch_status(cudaSuccess);
}
