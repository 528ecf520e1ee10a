// The beam model's Thrun table 6.2 mixture (beam_model.hpp:125-147), shared
// by kernels B7 (beam_lut.cu) and B8 (beam.cu).
//
// Per beam with measured range z and expected range z_mean:
//   eta_hit   = 2 / (erf((bmr - z_mean) / (sqrt2 sigma)) - erf(-z_mean / (sqrt2 sigma)))
//   pz        = z_hit eta_hit n_const exp(-0.5 d d),   d = (z - z_mean) / sigma
//   eta_short = 1 / (1 - exp(-lam z_mean))
//   pz       += z < z_mean ? z_short lam eta_short exp(-lam z) : 0
//   pz       += z < bmr ? z_rand / bmr : z_max
// and the weight adds pz^3.  erf is the Abramowitz & Stegun 7.1.26
// polynomial of beluga_tpu/ops/pallas_beam.py:_erf, not CUDA's erff.
// Every product, sum and division is a round-to-nearest intrinsic in the
// reference's order, so nvcc contracts nothing and the plain PyTorch
// version (same operations, same order, expf) gives the same bits.

#pragma once

#include <cuda_runtime.h>

namespace beam {

// the mixture's scalars; products of scalars only (sqrt2 sigma, n_const,
// z_short lam, z_rand / bmr) are computed once on the host in float32
enum {
  kBmr, kZHit, kZMax, kS2Sig, kSigma, kNConst, kNegLam, kShortCoef, kRandCoef, kNumMixture
};

struct Mixture {
  float v[kNumMixture];
};

__device__ __forceinline__ float poly_erf(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(p, ax)));
  float poly = __fadd_rn(__fmul_rn(a5, t), a4);
  poly = __fadd_rn(__fmul_rn(poly, t), a3);
  poly = __fadd_rn(__fmul_rn(poly, t), a2);
  poly = __fadd_rn(__fmul_rn(poly, t), a1);
  poly = __fmul_rn(poly, t);
  const float y = __fsub_rn(1.0f, __fmul_rn(poly, expf(__fmul_rn(-ax, ax))));
  // jnp.sign: -1, 0 or 1, NaN for NaN
  const float sign = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
  return __fmul_rn(sign, y);
}

// pz^3 of one beam
__device__ __forceinline__ float pz3(const Mixture& m, float z, float z_mean) {
  const float* s = m.v;
  const float eta_hit =
      __fdiv_rn(2.0f, __fsub_rn(poly_erf(__fdiv_rn(__fsub_rn(s[kBmr], z_mean), s[kS2Sig])),
                                poly_erf(__fdiv_rn(-z_mean, s[kS2Sig]))));
  const float d = __fdiv_rn(__fsub_rn(z, z_mean), s[kSigma]);
  float pz = __fmul_rn(__fmul_rn(__fmul_rn(s[kZHit], eta_hit), s[kNConst]),
                       expf(__fmul_rn(__fmul_rn(-0.5f, d), d)));
  if (z < z_mean) {
    const float eta_short =
        __fdiv_rn(1.0f, __fsub_rn(1.0f, expf(__fmul_rn(s[kNegLam], z_mean))));
    pz = __fadd_rn(pz, __fmul_rn(__fmul_rn(s[kShortCoef], eta_short),
                                 expf(__fmul_rn(s[kNegLam], z))));
  } else {
    pz = __fadd_rn(pz, 0.0f);
  }
  pz = __fadd_rn(pz, z < s[kBmr] ? s[kRandCoef] : s[kZMax]);
  return __fmul_rn(__fmul_rn(pz, pz), pz);
}

}  // namespace beam
