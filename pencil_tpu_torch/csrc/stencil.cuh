// Shared device helpers of the hand-written stencil kernels
// (csrc/fused_rhs.cu): the ghost width of the 6th-order stencil and the
// per-block maximum of the CFL 1/dt.
#pragma once

#define NG 3           // ghost width of the 6th-order stencil

// Block maximum of v over NT threads, written by thread 0 to *out: warp
// shuffles, then one warp over the warp maxima.  Each TAG has a red[] of
// its own: where two kernels of a library share one, ptxas lays it out
// after their other shared variables, which moves every shared offset of
// a kernel that had it to itself.
template <int NT, int TAG = 0>
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
