// Kernel R1: the Bresenham ray march of the beam model, in two entries that
// share one march.
//
// Replaces beluga_tpu/ops/raycast.py:cast_rays (the standard variant) and
// _cast_rays_supercover.  The JAX package marches every ray in lock-step
// inside a fori_loop of ceil(max_range / res) + 2 iterations; it is no
// Pallas kernel, but in eager PyTorch that loop costs ~20 launches per
// iteration.  Two entries:
//   - the ray entry (beluga_cast_rays) casts given rays, for
//     models/sensor/beam_lut.py:build_range_lut and every other caller;
//   - the exact beam-weights entry (beluga_beam_exact) is the whole of
//     beluga_tpu/models/sensor/beam.py:beam_weights, and beam_log_weights
//     with log_space: it composes world_to_grid @ state in lie.py's order,
//     rotates each beam (c bx - s by, s bx + c by), marches, takes the beam
//     mixture of beam_mixture.cuh with CUDA's erff (the reference's
//     jax.lax.erf, torch.erf on the card; not B8's polynomial), adds the
//     unmasked beams' pz^3 in beam order and, in log space, takes
//     log(max(w, 1e-30)).
//
// Semantics (raycasting.hpp:44-115, bresenham.hpp:34-230):
//   source cell  floor(src / res)
//   far cell     floor((src + max_range * dir) / res)
//   distance     res * hypot(dx, dy) from the source cell, centroid to
//                centroid, clamped to max_range; max_range on a miss
//   a ray that leaves the grid is a miss; a non-free source cell is a hit
//   at distance 0.
// Each ray carries the reference's integer state, (x, y, err) for the
// standard variant or (a, b, error) with the axis swap for the supercover
// (kModified) variant, and stops at the first blocked cell, on leaving the
// grid or at the far cell, or after num_steps steps.  Stopping early is
// exact: the reference's `done` freezes its carry.  Every cell index comes
// from __fmul_rn / __fadd_rn / __fdiv_rn, so nvcc contracts nothing into an
// FMA and no division goes through a reciprocal: the cells are the plain
// PyTorch version's bit for bit.
//
// What bounds it on an H100: neither bytes nor operations but issue slots
// and each ray's dependent chain (one read of the free mask a cell), and
// within a warp its longest ray.  The first form read a uint8 mask
// through L1/L2 on every step, one ray a thread, with a branchy step, and
// ran the range-LUT build at 11.8x its bound.  Design (each element taken
// back alone on the card; PERF.md, section 6):
//   - the free mask as a bit plane, 32 cells a word, each row padded to
//     whole words (18 KB at 384^2, 128 KB at 1024^2), packed once a map;
//   - each block copies the plane into shared memory by cp.async where it
//     fits beside the block's other arrays (227 KB), and reads it through
//     L1/L2 otherwise, so that a step is a shared-memory read and a bit test
//     (at the beam node the exact entry takes twice as long without it);
//   - one ray a thread, in a loop the thread leaves when its ray stops
//     (several rays a thread, advanced step by step together, measured
//     slower in both entries);
//   - a branch-light step: the inside test one unsigned compare a
//     coordinate, the word read only inside the map, the bit by one funnel
//     shift, the blocked, outside and last-cell tests one stop flag (a ray
//     counts down its cells: the line reaches the far cell at exactly step
//     max(dx, dy)), the Bresenham update by selects;
//   - 32 registers a thread (kCastMinBlocks, kExactMinBlocks), so that an SM
//     holds 2048 threads, with the standard line's step signs pinned in
//     registers under that cap (LineRay::init);
//   - the ray entry walks rays by grid stride on a persistent grid (each
//     block copies the plane once), its sources and directions read through
//     broadcast strides, so that the range-LUT build's K x H x W rays need
//     no copy of their inputs;
//   - the exact entry: a block scores P particles of one filter; its
//     prologue composes their poses and compacts the filter's unmasked
//     beams (bearing and range) into shared memory while the plane copy is
//     in flight; its (particle, unmasked beam) rays go to threads with the
//     lanes of a warp on one beam of adjacent particles (near-parallel rays
//     from nearby poses; adjacent beams of one particle measured slower);
//     each ray's pz^3 lands in a shared slot, and one
//     thread per particle adds its slots in beam order with __fadd_rn, so
//     that the sum is the plain version's operations in its order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_mixture.cuh"

// A block's dynamic shared memory: the plane's copy first (where it is staged)
extern __shared__ __align__(16) unsigned char r1_smem[];

namespace {

constexpr int kCastThreads = 512;
constexpr int kExactThreads = 512;
// blocks an SM must hold (__launch_bounds__): 4 of 512 threads caps a
// thread at 32 registers, so that the SM holds 2048 threads
constexpr int kCastMinBlocks = 4;
constexpr int kExactMinBlocks = 4;
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory a block may hold
constexpr int kMaxDims = 4;  // broadcast axes of the ray entry

// The free mask as bits: bit (x & 31) of word y * wpr + (x >> 5) is 1 where
// cell (x, y) is free; rows are padded to wpr words.
struct Plane {
  const uint32_t* bits;
  int h, w, wpr;
};

// Whether (x, y) lies on the map (*inside) and is free.  kShared reads the
// plane's copy in shared memory (pl.bits, from staged_plane), else the
// read-only path; nothing is read off the map.
template <bool kShared>
__device__ __forceinline__ bool free_cell(const Plane& pl, int x, int y, bool* inside) {
  const bool in = (static_cast<unsigned>(x) < static_cast<unsigned>(pl.w)) &
                  (static_cast<unsigned>(y) < static_cast<unsigned>(pl.h));
  *inside = in;
  uint32_t word = 0;
  if (in) {
    const int i = y * pl.wpr + (x >> 5);
    word = kShared ? pl.bits[i] : __ldg(pl.bits + i);
  }
  return __funnelshift_r(word, word, x) & 1u;  // bit x & 31
}

__device__ __forceinline__ float centroid_distance(float res, int da, int db, float max_range) {
  return fminf(__fmul_rn(res, hypotf(static_cast<float>(da), static_cast<float>(db))), max_range);
}

// The source and far cells of a ray, each coordinate a separate product,
// sum and IEEE division.
struct Ends {
  int x0, y0, x1, y1;
};

__device__ __forceinline__ Ends line_ends(float sx, float sy, float dx, float dy,
                                          float max_range, float res) {
  const float fx = __fadd_rn(sx, __fmul_rn(max_range, dx));
  const float fy = __fadd_rn(sy, __fmul_rn(max_range, dy));
  return Ends{static_cast<int>(floorf(__fdiv_rn(sx, res))),
              static_cast<int>(floorf(__fdiv_rn(sy, res))),
              static_cast<int>(floorf(__fdiv_rn(fx, res))),
              static_cast<int>(floorf(__fdiv_rn(fy, res)))};
}

// The standard Bresenham line (bresenham.hpp:34-95): one cell a step.  The
// line reaches the far cell at exactly step max(dx, dy), so instead of
// comparing each cell with the far cell (and the step with num_steps) a ray
// counts down the min(num_steps, max(dx, dy) + 1) cells it may visit.
struct LineRay {
  int x, y, err, dx, dy, sx, sy, left, x0, y0;

  __device__ __forceinline__ void init(const Ends& e, int num_steps) {
    x0 = x = e.x0;
    y0 = y = e.y0;
    dx = abs(e.x1 - x0);
    dy = abs(e.y1 - y0);
    sx = e.x1 >= x0 ? 1 : -1;
    sy = e.y1 >= y0 ? 1 : -1;
    err = dx - dy;
    left = min(num_steps, max(dx, dy) + 1);
    // keep the steps in registers: under the 32-register cap nvcc otherwise
    // rebuilds sy from the far cell at every step (39 instructions a step
    // for 36, measured slower on an H100)
    asm("" : "+r"(sx), "+r"(sy));
  }

  // Nothing to probe before the first step's cell, the source; a ray of no
  // steps is a miss.
  template <bool kShared>
  __device__ __forceinline__ bool start(const Plane&, bool* hit) {
    *hit = false;
    return left <= 0;
  }

  // One step at cell (x, y): stops there off the map (a miss), on a blocked
  // cell (a hit) or at its last cell, the far one (a miss); otherwise the
  // line advances.
  template <bool kShared>
  __device__ __forceinline__ bool step(const Plane& pl, bool* hit) {
    bool in;
    const bool fr = free_cell<kShared>(pl, x, y, &in);
    const bool stop = !fr | (--left == 0);
    *hit = in & !fr;
    const int e2 = 2 * err;
    const bool step_x = e2 > -dy, step_y = e2 < dx;
    if (!stop) {
      err += (step_y ? dx : 0) - (step_x ? dy : 0);
      x += step_x ? sx : 0;
      y += step_y ? sy : 0;
    }
    return stop;
  }

  __device__ __forceinline__ float distance(float res, float max_range) const {
    return centroid_distance(res, x - x0, y - y0, max_range);
  }
};

// The supercover line (bresenham.hpp:97-230, kModified): the driving axis a
// has the larger span; each primary step probes up to two intermediate cells
// (both on an exact corner crossing), then the diagonal cell.  A ray takes
// at most min(num_steps, aspan) primary steps (`left`).
struct CoverRay {
  int a, b, error, left, astep, bstep, daspan, dbspan, a0, b0;
  bool rev;

  __device__ __forceinline__ void init(const Ends& e, int num_steps) {
    const int xspan = abs(e.x1 - e.x0), yspan = abs(e.y1 - e.y0);
    const int xstep = e.x1 >= e.x0 ? 1 : -1, ystep = e.y1 >= e.y0 ? 1 : -1;
    rev = xspan < yspan;
    a0 = a = rev ? e.y0 : e.x0;
    b0 = b = rev ? e.x0 : e.y0;
    const int aspan = max(xspan, yspan);
    astep = rev ? ystep : xstep;
    bstep = rev ? xstep : ystep;
    daspan = 2 * aspan;
    dbspan = 2 * min(xspan, yspan);
    error = aspan;
    left = min(num_steps, aspan);
  }

  // Cell (ca, cb) when `cond`: whether it stops the ray (off the map or
  // blocked) and whether that is a hit.
  template <bool kShared>
  __device__ __forceinline__ bool probe(const Plane& pl, bool cond, int ca, int cb,
                                        bool* hit) const {
    bool in = false, fr = true;
    if (cond) fr = free_cell<kShared>(pl, rev ? cb : ca, rev ? ca : cb, &in);
    *hit = in & !fr;
    return !fr;
  }

  // The source cell, probed before the first step.
  template <bool kShared>
  __device__ __forceinline__ bool start(const Plane& pl, bool* hit) {
    return probe<kShared>(pl, true, a, b, hit);
  }

  template <bool kShared>
  __device__ __forceinline__ bool step(const Plane& pl, bool* hit) {
    if (left-- <= 0) {  // past the far cell, or out of steps: a miss
      *hit = false;
      return true;
    }
    const int a_new = a + astep;
    const int e1 = error + dbspan;
    const bool diag = e1 > daspan;
    const int b_new = diag ? b + bstep : b;
    const int e2 = diag ? e1 - daspan : e1;
    bool h1, h2, h3;
    const bool s1 = probe<kShared>(pl, diag & (e2 + error <= daspan), a_new, b, &h1);
    const bool s2 = probe<kShared>(pl, diag & (e2 + error >= daspan), a, b_new, &h2);
    const bool s3 = probe<kShared>(pl, true, a_new, b_new, &h3);
    // the first cell in emission order that stops the ray is the result
    const bool stop = s1 | s2 | s3;
    *hit = s1 ? h1 : (s2 ? h2 : h3);
    const int ca = s1 ? a_new : (s2 ? a : a_new);
    const int cb = s1 ? b : b_new;
    a = stop ? ca : a_new;
    b = stop ? cb : b_new;
    if (!stop) error = e2;
    return stop;
  }

  __device__ __forceinline__ float distance(float res, float max_range) const {
    return centroid_distance(res, a - a0, b - b0, max_range);
  }
};

// Marches a ray from its source until it stops; whether it stopped on a
// blocked cell.
template <class Ray, bool kShared>
__device__ __forceinline__ bool march(Ray& ray, const Plane& pl) {
  bool hit;
  if (ray.template start<kShared>(pl, &hit)) return hit;
  while (!ray.template step<kShared>(pl, &hit)) {
  }
  return hit;
}

// Starts copying `words` plane words into the start of dynamic shared memory
// without staging them in registers (cp.async, 16 bytes a thread a step,
// or one word where the source is not 16-byte aligned); cp_async_wait()
// before reading them.
__device__ __forceinline__ void copy_plane_async(const uint32_t* bits, int words) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(r1_smem);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(bits) & 15) == 0) {
    for (int v = threadIdx.x; v < words / 4; v += blockDim.x) {
      const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * v));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(bits + 4 * v));
    }
    done = words / 4 * 4;
  }
  for (int e = done + threadIdx.x; e < words; e += blockDim.x) dst[e] = __ldg(bits + e);
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The plane a kernel marches on: its copy at the start of dynamic shared
// memory, or the one in global memory.
template <bool kShared>
__device__ __forceinline__ Plane staged_plane(const Plane& pl) {
  Plane out = pl;
  if (kShared) out.bits = reinterpret_cast<const uint32_t*>(r1_smem);
  return out;
}

// Bytes of the plane's copy, rounded up to 16 so that what follows it in
// shared memory stays aligned.
__host__ __device__ __forceinline__ size_t plane_bytes(int h, int wpr) {
  return (static_cast<size_t>(h) * wpr * 4 + 15) / 16 * 16;
}

// -- the ray entry ---------------------------------------------------------------

struct CastArgs {
  Plane plane;
  const float* src;  // (x, y) pairs, each axis of the broadcast shape with its stride
  const float* dir;
  int nd;
  int size[kMaxDims];
  long long src_stride[kMaxDims], dir_stride[kMaxDims];  // in floats
  int n;  // rays, < 2^31
  float max_range, res;
  int num_steps;
  float* dist;
  uint8_t* hit;
};

// Ray i's source and direction through the broadcast strides (the
// outermost axis needs no division).
__device__ __forceinline__ void ray_inputs(const CastArgs& a, unsigned i, float2* s,
                                           float2* d) {
  long long so = 0, dof = 0;
#pragma unroll
  for (int k = kMaxDims - 1; k >= 1; --k) {
    if (k < a.nd) {
      const unsigned size = static_cast<unsigned>(a.size[k]);
      const unsigned q = i / size;
      const long long c = i - q * size;
      so += c * a.src_stride[k];
      dof += c * a.dir_stride[k];
      i = q;
    }
  }
  so += static_cast<long long>(i) * a.src_stride[0];
  dof += static_cast<long long>(i) * a.dir_stride[0];
  *s = make_float2(__ldg(a.src + so), __ldg(a.src + so + 1));
  *d = make_float2(__ldg(a.dir + dof), __ldg(a.dir + dof + 1));
}

// A persistent block copies the plane once, then casts rays by grid stride:
// adjacent lanes take adjacent rays.
template <class Ray, bool kShared>
__global__ void __launch_bounds__(kCastThreads, kCastMinBlocks) cast_rays_kernel(CastArgs a) {
  if (kShared) {
    copy_plane_async(a.plane.bits, a.plane.h * a.plane.wpr);
    cp_async_wait();
    __syncthreads();
  }
  const Plane pl = staged_plane<kShared>(a.plane);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < a.n;
       i += stride) {
    float2 s, d;
    ray_inputs(a, static_cast<unsigned>(i), &s, &d);
    Ray ray;
    ray.init(line_ends(s.x, s.y, d.x, d.y, a.max_range, a.res), a.num_steps);
    const bool hit = march<Ray, kShared>(ray, pl);
    a.dist[i] = hit ? ray.distance(a.res, a.max_range) : a.max_range;
    a.hit[i] = hit;
  }
}

// -- the exact beam-weights entry ------------------------------------------------

struct ExactArgs {
  Plane plane;
  const float* xy;   // states' xy [filters, n, 2]
  const float* rot;  // states' (cos, sin) [filters, n, 2]
  int n;
  float wx, wy, wc, ws;  // world_to_grid
  const float* points;   // [filters, nb, 2]
  const uint8_t* mask;   // [filters, nb]
  int nb;
  int per_block;    // P particles a block
  int slot_stride;  // a particle's row of pz^3 slots (odd: no bank conflicts)
  float res, max_range;
  int num_steps;
  beam::Mixture mix;
  float* out;  // [filters, n]
};

// Block (x, f) scores particles x * P, ..., x * P + P - 1 of filter f.
template <class Ray, bool kShared, bool kLog>
__global__ void __launch_bounds__(kExactThreads, kExactMinBlocks)
    beam_exact_kernel(ExactArgs a) {
  const int f = blockIdx.y;
  const int p0 = blockIdx.x * a.per_block;
  const int count = min(a.per_block, a.n - p0);
  const size_t off = kShared ? plane_bytes(a.plane.h, a.plane.wpr) : 0;
  float4* s_beam = reinterpret_cast<float4*>(r1_smem + off);  // [nb]: bx, by, z, -
  float4* s_pose = s_beam + a.nb;                           // [P]: x, y, cos, sin
  float* s_pz3 = reinterpret_cast<float*>(s_pose + a.per_block);  // [P][slot_stride]
  int* s_beams = reinterpret_cast<int*>(s_pz3 + a.per_block * a.slot_stride);
  if (kShared) copy_plane_async(a.plane.bits, a.plane.h * a.plane.wpr);  // in flight below

  // the poses in the grid frame, world_to_grid @ state in lie.py's order
  // (SE2 @ SE2: xy + rot.act(xy'), then rot @ rot')
  for (int q = threadIdx.x; q < count; q += blockDim.x) {
    const size_t p = static_cast<size_t>(f) * a.n + p0 + q;
    const float2 xy = __ldg(reinterpret_cast<const float2*>(a.xy) + p);
    const float2 rot = __ldg(reinterpret_cast<const float2*>(a.rot) + p);
    s_pose[q] = make_float4(
        __fadd_rn(a.wx, __fsub_rn(__fmul_rn(a.wc, xy.x), __fmul_rn(a.ws, xy.y))),
        __fadd_rn(a.wy, __fadd_rn(__fmul_rn(a.ws, xy.x), __fmul_rn(a.wc, xy.y))),
        __fsub_rn(__fmul_rn(a.wc, rot.x), __fmul_rn(a.ws, rot.y)),
        __fadd_rn(__fmul_rn(a.ws, rot.x), __fmul_rn(a.wc, rot.y)));
  }
  // the filter's unmasked beams, compacted in order by warp 0: the bearing
  // p / max(|p|, 1e-12) and the measured range |p| (beam_model.hpp:116-121)
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int total = 0;
    for (int b0 = 0; b0 < a.nb; b0 += 32) {
      const int b = b0 + lane;
      const size_t k = static_cast<size_t>(f) * a.nb + b;
      const bool on = b < a.nb && a.mask[k];
      const unsigned ballot = __ballot_sync(0xffffffffu, on);
      if (on) {
        const float px = a.points[2 * k], py = a.points[2 * k + 1];
        const float z = __fsqrt_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)));
        const float zc = z < 1e-12f ? 1e-12f : z;  // clamp_min: NaN stays NaN
        s_beam[total + __popc(ballot & ((1u << lane) - 1u))] =
            make_float4(__fdiv_rn(px, zc), __fdiv_rn(py, zc), z, 0.0f);
      }
      total += __popc(ballot);
    }
    if (lane == 0) *s_beams = total;
  }
  if (kShared) cp_async_wait();
  __syncthreads();

  const Plane pl = staged_plane<kShared>(a.plane);
  const int nbu = *s_beams;
  const int items = count * nbu;
  const float bmr = a.mix.v[beam::kBmr];
  for (int k = threadIdx.x; k < items; k += blockDim.x) {
    // a warp's lanes on one beam of adjacent particles
    const int q = k % count, b = k / count;
    const float4 pose = s_pose[q], bearing = s_beam[b];
    const float dx = __fsub_rn(__fmul_rn(pose.z, bearing.x), __fmul_rn(pose.w, bearing.y));
    const float dy = __fadd_rn(__fmul_rn(pose.w, bearing.x), __fmul_rn(pose.z, bearing.y));
    Ray ray;
    ray.init(line_ends(pose.x, pose.y, dx, dy, a.max_range, a.res), a.num_steps);
    const float z_mean = march<Ray, kShared>(ray, pl) ? ray.distance(a.res, a.max_range) : bmr;
    s_pz3[q * a.slot_stride + b] = beam::pz3<beam::CudaErf>(a.mix, bearing.z, z_mean);
  }
  __syncthreads();
  // each particle's sum, beam by beam in order, as the plain version adds
  for (int q = threadIdx.x; q < count; q += blockDim.x) {
    const float* row = s_pz3 + q * a.slot_stride;
    float acc = 0.0f;
    for (int b = 0; b < nbu; ++b) acc = __fadd_rn(acc, row[b]);
    if (kLog) acc = logf(acc < 1e-30f ? 1e-30f : acc);  // clamp_min: NaN stays NaN
    a.out[static_cast<size_t>(f) * a.n + p0 + q] = acc;
  }
}

// -- launchers ---------------------------------------------------------------------

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
  }
  return count;
}

// Lets `kernel` take up to kMaxSmem of dynamic shared memory (once).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <class Ray, bool kShared>
int launch_cast(const CastArgs& a, cudaStream_t stream) {
  auto kernel = cast_rays_kernel<Ray, kShared>;
  static bool configured = false;
  static size_t cached_smem = ~size_t{0};
  static int cached_per_sm = 1;
  const size_t smem_bytes = kShared ? plane_bytes(a.plane.h, a.plane.wpr) : 0;
  if (cudaError_t err = allow_smem(kernel, &configured)) return static_cast<int>(err);
  if (smem_bytes != cached_smem) {
    int per_sm = 0;
    if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kCastThreads, smem_bytes)) {
      return static_cast<int>(err);
    }
    cached_smem = smem_bytes;
    cached_per_sm = per_sm > 0 ? per_sm : 1;
  }
  const long long wanted = (a.n + kCastThreads - 1) / kCastThreads;
  const long long resident = static_cast<long long>(sm_count()) * cached_per_sm;
  const unsigned blocks = static_cast<unsigned>(wanted < resident ? wanted : resident);
  kernel<<<blocks, kCastThreads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class Ray, bool kShared, bool kLog>
int launch_exact(const ExactArgs& a, int filters, size_t smem_bytes, cudaStream_t stream) {
  auto kernel = beam_exact_kernel<Ray, kShared, kLog>;
  static bool configured = false;
  if (cudaError_t err = allow_smem(kernel, &configured)) return static_cast<int>(err);
  const dim3 grid((a.n + a.per_block - 1) / a.per_block, filters);
  kernel<<<grid, kExactThreads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <class Ray>
int dispatch_exact(const ExactArgs& a, int filters, bool log_space, cudaStream_t stream) {
  // the block's arrays beside the plane: beams, poses, pz^3 slots, the count
  const size_t rest = static_cast<size_t>(a.nb) * 16 + static_cast<size_t>(a.per_block) * 16 +
                      static_cast<size_t>(a.per_block) * a.slot_stride * 4 + 16;
  if (rest > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const size_t plane = plane_bytes(a.plane.h, a.plane.wpr);
  if (plane + rest <= kMaxSmem) {
    return log_space ? launch_exact<Ray, true, true>(a, filters, plane + rest, stream)
                     : launch_exact<Ray, true, false>(a, filters, plane + rest, stream);
  }
  return log_space ? launch_exact<Ray, false, true>(a, filters, rest, stream)
                   : launch_exact<Ray, false, false>(a, filters, rest, stream);
}

}  // namespace

// The ray entry over n rays: `bits` the int32 [h, wpr] plane (bit x & 31 of
// word (y, x >> 5) is 1 where cell (x, y) is free); src and dir float32
// (x, y) pairs read through a broadcast shape of nd <= 4 axes, `sizes`, and
// each one's strides in floats (host arrays; the pair's own stride is 1);
// writes dist float32[n] and hit uint8[n] in the shape's order.  variant 0
// is the standard Bresenham line, 1 the supercover.  Returns
// cudaGetLastError() of the launch.
extern "C" int beluga_cast_rays(const void* bits, int h, int w, int wpr, const void* src,
                                const void* dir, int nd, const long long* sizes,
                                const long long* src_strides, const long long* dir_strides,
                                int n, float max_range, float res, int num_steps,
                                int variant, void* dist, void* hit, void* stream) {
  if (n == 0) return 0;
  if (nd < 1 || nd > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  CastArgs a{};
  a.plane = Plane{static_cast<const uint32_t*>(bits), h, w, wpr};
  a.src = static_cast<const float*>(src);
  a.dir = static_cast<const float*>(dir);
  a.nd = nd;
  for (int k = 0; k < nd; ++k) {
    a.size[k] = static_cast<int>(sizes[k]);
    a.src_stride[k] = src_strides[k];
    a.dir_stride[k] = dir_strides[k];
  }
  a.n = n;
  a.max_range = max_range;
  a.res = res;
  a.num_steps = num_steps;
  a.dist = static_cast<float*>(dist);
  a.hit = static_cast<uint8_t*>(hit);
  auto s = static_cast<cudaStream_t>(stream);
  const bool shared = plane_bytes(h, wpr) <= kMaxSmem;
  if (variant == 1) {
    return shared ? launch_cast<CoverRay, true>(a, s) : launch_cast<CoverRay, false>(a, s);
  }
  return shared ? launch_cast<LineRay, true>(a, s) : launch_cast<LineRay, false>(a, s);
}

// The exact beam-weights entry over `filters` filters of n particles: the
// plane as above; xy and rot float32 [filters, n, 2] (the states, 8-byte
// aligned); world_to_grid's x, y, cos and sin (host floats); points float32
// [filters, nb, 2], mask uint8 [filters, nb]; the nine mixture floats of
// beam_mixture.cuh (host); writes out float32 [filters, n]: sum of pz^3
// over the unmasked beams, or log(max(that, 1e-30)) with log_space.
// Returns cudaGetLastError() of the launch.
extern "C" int beluga_beam_exact(const void* bits, int h, int w, int wpr, const void* xy,
                                 const void* rot, int n, int filters, const float* world,
                                 const void* points, const void* mask, int nb, float res,
                                 float max_range, int num_steps, int variant, int log_space,
                                 const float* mixture, void* out, void* stream) {
  if (n == 0 || filters == 0) return 0;
  ExactArgs a{};
  a.plane = Plane{static_cast<const uint32_t*>(bits), h, w, wpr};
  a.xy = static_cast<const float*>(xy);
  a.rot = static_cast<const float*>(rot);
  a.n = n;
  a.wx = world[0];
  a.wy = world[1];
  a.wc = world[2];
  a.ws = world[3];
  a.points = static_cast<const float*>(points);
  a.mask = static_cast<const uint8_t*>(mask);
  a.nb = nb;
  // P particles a block: about one ray for each thread
  const int per_block = kExactThreads / (nb > 0 ? nb : 1);
  a.per_block = per_block < 1 ? 1 : (per_block < n ? per_block : n);
  a.slot_stride = nb | 1;
  a.res = res;
  a.max_range = max_range;
  a.num_steps = num_steps;
  for (int k = 0; k < beam::kNumMixture; ++k) a.mix.v[k] = mixture[k];
  a.out = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return variant == 1 ? dispatch_exact<CoverRay>(a, filters, log_space != 0, s)
                      : dispatch_exact<LineRay>(a, filters, log_space != 0, s);
}
