// Shared device helpers of the hand-written stencil kernels: the paired
// 6th-order first and second derivatives and the 12-point bidiagonal mixed
// derivative of the zghost template, and the per-block maximum of the CFL
// 1/dt of every template.
//
// The sums use round-to-nearest intrinsics (no FMA contraction) in the
// JAX package's term order (pencil_tpu/ops/stencil.py:145-184, :277-328),
// so constant fields give exactly zero derivatives and the sums match the
// plain PyTorch versions.
#pragma once

#define NG 3           // ghost width of the 6th-order stencil

// sum_o w_o*(f[+o] - f[-o])
__device__ __forceinline__ float d1(const float* p, int st, const float* w) {
  float acc = __fmul_rn(w[0], __fsub_rn(p[st], p[-st]));
  acc = __fadd_rn(acc, __fmul_rn(w[1], __fsub_rn(p[2 * st], p[-2 * st])));
  acc = __fadd_rn(acc, __fmul_rn(w[2], __fsub_rn(p[3 * st], p[-3 * st])));
  return acc;
}

// sum_o w_o*((f[+o] + f[-o]) - 2 f[0])
__device__ __forceinline__ float d2(const float* p, int st, const float* w) {
  const float c2 = 2.0f * p[0];
  float acc = __fmul_rn(w[0], __fsub_rn(__fadd_rn(p[st], p[-st]), c2));
  acc = __fadd_rn(acc, __fmul_rn(w[1],
        __fsub_rn(__fadd_rn(p[2 * st], p[-2 * st]), c2)));
  acc = __fadd_rn(acc, __fmul_rn(w[2],
        __fsub_rn(__fadd_rn(p[3 * st], p[-3 * st]), c2)));
  return acc;
}

// 12-point bidiagonal mixed derivative along strides s1 < s2 (axis order),
// taps (o,o,+), (-o,o,-), (-o,-o,+), (o,-o,-) for o = 1, 2, 3.
__device__ __forceinline__ float dmix(const float* p, int s1, int s2,
                                      const float* wm) {
  float acc = 0.0f;
#pragma unroll
  for (int o = 1; o <= 3; ++o) {
    const float* w = wm + 4 * (o - 1);
    const int a = o * s1, b = o * s2;
    const float t0 = __fmul_rn(w[0], p[a + b]);
    acc = (o == 1) ? t0 : __fadd_rn(acc, t0);
    acc = __fadd_rn(acc, __fmul_rn(w[1], p[-a + b]));
    acc = __fadd_rn(acc, __fmul_rn(w[2], p[-a - b]));
    acc = __fadd_rn(acc, __fmul_rn(w[3], p[a - b]));
  }
  return acc;
}

// Block maximum of v over NT threads, written by thread 0 to *out: warp
// shuffles, then one warp over the warp maxima.
template <int NT>
__device__ __forceinline__ void block_max_store(float v, float* out) {
  __shared__ float red[NT / 32];
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    v = tid < NT / 32 ? red[tid] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (tid == 0) *out = v;
  }
}
