// Kernel R1: the Bresenham ray march of the beam model, one thread per ray.
//
// Replaces beluga_tpu/ops/raycast.py:cast_rays (the standard variant) and
// _cast_rays_supercover.  The JAX package marches every ray in lock-step
// inside a fori_loop of ceil(max_range / res) + 2 iterations; it is no
// Pallas kernel, but in eager PyTorch that loop costs ~20 launches per
// iteration, ~40 000 per update at nav2's 100 m range on a 5 cm map.  Here
// each thread carries the reference's integer state, (x, y, err) for the
// standard variant or (a, b, error) with the axis swap for the supercover
// (kModified) variant, and stops at the first blocked cell, on leaving the
// grid or at the far cell, or after num_steps steps.  Stopping early is
// exact: the reference's `done` freezes its carry.
//
// Semantics (raycasting.hpp:44-115, bresenham.hpp:34-230):
//   source cell  floor(src / res)
//   far cell     floor((src + max_range * dir) / res)
//   distance     res * hypot(dx, dy) from the source cell, centroid to
//                centroid, clamped to max_range; max_range on a miss
//   a ray that leaves the grid is a miss; a non-free source cell is a hit
//   at distance 0.
// Every cell index comes from __fmul_rn / __fadd_rn / __fdiv_rn, so nvcc
// contracts nothing into an FMA and no division goes through a reciprocal:
// the cells are the plain PyTorch version's bit for bit.
//
// What bounds it on an H100: neither bytes nor operations but the
// dependent chain of one ray, one L2 read of the uint8 free mask (147 KB at
// 384^2, 1 MB at 1024^2, resident in L2) per step.  The byte bound counts
// 16 B in and 5 B out per ray.  Design, simple first: one thread per ray,
// 256 threads a block, the mask read through the read-only path; rays of
// one warp diverge in length, and the warp runs as long as its longest ray.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Grid {
  const uint8_t* __restrict__ free;  // [h, w], 1 = free
  int h, w;
};

__device__ __forceinline__ bool inside(const Grid& g, int x, int y) {
  return x >= 0 && x < g.w && y >= 0 && y < g.h;
}

__device__ __forceinline__ bool blocked_cell(const Grid& g, int x, int y) {
  return __ldg(g.free + static_cast<size_t>(y) * g.w + x) == 0;
}

__device__ __forceinline__ float centroid_distance(float res, int da, int db, float max_range) {
  return fminf(__fmul_rn(res, hypotf(static_cast<float>(da), static_cast<float>(db))), max_range);
}

__global__ void standard_kernel(Grid g, const float* __restrict__ src,
                                const float* __restrict__ dir, int64_t n, float max_range,
                                float res, int num_steps, float* __restrict__ dist_out,
                                uint8_t* __restrict__ hit_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float sx = src[2 * i], sy = src[2 * i + 1];
  const float fx = __fadd_rn(sx, __fmul_rn(max_range, dir[2 * i]));
  const float fy = __fadd_rn(sy, __fmul_rn(max_range, dir[2 * i + 1]));
  const int x0 = static_cast<int>(floorf(__fdiv_rn(sx, res)));
  const int y0 = static_cast<int>(floorf(__fdiv_rn(sy, res)));
  const int x1 = static_cast<int>(floorf(__fdiv_rn(fx, res)));
  const int y1 = static_cast<int>(floorf(__fdiv_rn(fy, res)));
  const int dx = abs(x1 - x0), dy = abs(y1 - y0);
  const int sx_step = x1 >= x0 ? 1 : -1, sy_step = y1 >= y0 ? 1 : -1;
  int x = x0, y = y0, err = dx - dy;
  float dist = max_range;
  bool hit = false;
  for (int s = 0; s < num_steps; ++s) {
    if (!inside(g, x, y)) break;  // a miss
    if (blocked_cell(g, x, y)) {
      dist = centroid_distance(res, x - x0, y - y0, max_range);
      hit = true;
      break;
    }
    if (x == x1 && y == y1) break;
    const int e2 = 2 * err;
    const bool step_x = e2 > -dy, step_y = e2 < dx;
    if (step_x) {
      err -= dy;
      x += sx_step;
    }
    if (step_y) {
      err += dx;
      y += sy_step;
    }
  }
  dist_out[i] = dist;
  hit_out[i] = hit;
}

// One candidate cell of the supercover march, in emission order: returns
// true when the ray stops there (blocked: a hit; outside: a miss).
__device__ __forceinline__ bool probe(const Grid& g, bool rev, int ca, int cb, int a0, int b0,
                                      float res, float max_range, float* dist, bool* hit) {
  const int x = rev ? cb : ca, y = rev ? ca : cb;
  if (!inside(g, x, y)) return true;
  if (blocked_cell(g, x, y)) {
    *dist = centroid_distance(res, ca - a0, cb - b0, max_range);
    *hit = true;
    return true;
  }
  return false;
}

__global__ void supercover_kernel(Grid g, const float* __restrict__ src,
                                  const float* __restrict__ dir, int64_t n, float max_range,
                                  float res, int num_steps, float* __restrict__ dist_out,
                                  uint8_t* __restrict__ hit_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float sx = src[2 * i], sy = src[2 * i + 1];
  const float fx = __fadd_rn(sx, __fmul_rn(max_range, dir[2 * i]));
  const float fy = __fadd_rn(sy, __fmul_rn(max_range, dir[2 * i + 1]));
  const int x0 = static_cast<int>(floorf(__fdiv_rn(sx, res)));
  const int y0 = static_cast<int>(floorf(__fdiv_rn(sy, res)));
  const int x1 = static_cast<int>(floorf(__fdiv_rn(fx, res)));
  const int y1 = static_cast<int>(floorf(__fdiv_rn(fy, res)));
  const int xspan = abs(x1 - x0), yspan = abs(y1 - y0);
  const int xstep = x1 >= x0 ? 1 : -1, ystep = y1 >= y0 ? 1 : -1;
  // the driving axis a has the larger span (bresenham.hpp:101-107)
  const bool rev = xspan < yspan;
  const int a0 = rev ? y0 : x0, b0 = rev ? x0 : y0;
  const int aspan = max(xspan, yspan);
  const int astep = rev ? ystep : xstep, bstep = rev ? xstep : ystep;
  const int daspan = 2 * aspan, dbspan = 2 * min(xspan, yspan);
  float dist = max_range;
  bool hit = false;
  // the source cell, then one primary step per iteration
  if (!probe(g, rev, a0, b0, a0, b0, res, max_range, &dist, &hit)) {
    int a = a0, b = b0, error = aspan;
    for (int s = 0; s < num_steps && s + 1 <= aspan; ++s) {
      const int a_new = a + astep;
      const int e1 = error + dbspan;
      const bool diag = e1 > daspan;
      const int b_new = diag ? b + bstep : b;
      const int e2 = diag ? e1 - daspan : e1;
      // intermediate cells (bresenham.hpp:141-156): on e2 + error == daspan
      // both are emitted (an exact corner crossing)
      if (diag && e2 + error <= daspan &&
          probe(g, rev, a_new, b, a0, b0, res, max_range, &dist, &hit))
        break;
      if (diag && e2 + error >= daspan &&
          probe(g, rev, a, b_new, a0, b0, res, max_range, &dist, &hit))
        break;
      if (probe(g, rev, a_new, b_new, a0, b0, res, max_range, &dist, &hit)) break;
      a = a_new;
      b = b_new;
      error = e2;
    }
  }
  dist_out[i] = dist;
  hit_out[i] = hit;
}

}  // namespace

// R1 over n rays: src and dir are float32 [n, 2] (grid-local meters, unit
// directions), free the uint8 [h, w] free mask; writes dist float32[n] and
// hit uint8[n].  variant 0 is the standard Bresenham line, 1 the
// supercover.  Returns cudaGetLastError() of the launch.
extern "C" int beluga_cast_rays(const void* free, int h, int w, const void* src,
                                const void* dir, int64_t n, float max_range, float res,
                                int num_steps, int variant, void* dist, void* hit,
                                void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  const Grid g{static_cast<const uint8_t*>(free), h, w};
  auto s = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<float*>(dist);
  auto* o = static_cast<uint8_t*>(hit);
  const auto* p = static_cast<const float*>(src);
  const auto* q = static_cast<const float*>(dir);
  if (variant == 1) {
    supercover_kernel<<<blocks, threads, 0, s>>>(g, p, q, n, max_range, res, num_steps, d, o);
  } else {
    standard_kernel<<<blocks, threads, 0, s>>>(g, p, q, n, max_range, res, num_steps, d, o);
  }
  return static_cast<int>(cudaGetLastError());
}
