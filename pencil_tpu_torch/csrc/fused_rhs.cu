// Fused RHS kernels of the flagship step: forced isothermal MHD (uu, lnrho,
// aa; 6th-order central differences; 2N-RK orders 1-4) on a fully periodic
// grid.
//
// These replace the Pallas kernels of pencil_tpu/ops/fused_rhs.py that the
// flagship step launches (model.py:650-703), one template instance each:
//
//   K1  pc_rhs_first           <- `kernel` + `_dma_tile_wrap` (wrap mode):
//                                 df = RHS(f), per-block max of the CFL 1/dt
//   K2  pc_rhs_tail_defer      <- `kernel_tail(defer_prev=True)`:
//                                 f1 = f0 + cprev*df1 rebuilt in shared
//                                 memory, df2 = alpha*df1 + RHS(f1),
//                                 f2 = f1 + bdt*df2
//   K3  pc_rhs_tail_last       <- `kernel_tail(last=True, with_kick=...)`:
//                                 f3 = f2 + bdt*(alpha*df2 + RHS(f2)) plus the
//                                 helical forcing kick on uu; df3 never written
//   K3' pc_rhs_tail_mid        <- the middle substeps of 2N-RK4, which the
//                                 JAX step builds as `kernel_upd` with the
//                                 `_dma_tile_wrap` fetch (:331, call :677):
//                                 df <- alpha*df_prev + RHS(f), written over
//                                 df_prev; f <- f + bdt*df
//   K2L pc_rhs_tail_defer_last <- `kernel_tail(defer_prev=True, last=True,
//                                 with_kick=...)`, the one tail substep of
//                                 2N-RK2: K2's rebuilt f1 and K3's update
//   K8  pc_rhs_*_fake          <- the `PC_FAKE_RHS` branch of `body`
//                                 (:127-133): K1, K2 and K3's loads and
//                                 stores with RHS(f) = f*1.0000001, dt1 = 0
//
// What bounds them on an H100: every kernel is a stencil over all 7 fields.
// Device memory moves (nc + nvar)*4 B in and nvar*4 B (K2, K3': 2*nvar*4 B)
// out per point, 56-112 B, which at 3.35 TB/s is ~0.3-0.6 ms per kernel at
// 256^3; the ~900 operations per point take ~0.22 ms at 67 TFLOP/s, so
// device memory is the bound.  The per-point RHS reads ~420 shared-memory
// values (21 first, 18 second and 12 mixed derivatives of the
// paired/bidiagonal stencils), so shared-memory traffic and latency, not
// device memory, are the expected limit of this first version; K8 measures
// what the tile load and the stores alone cost.  Design: each block loads
// its (TX, TY, TZ) tile plus the 3-cell halo of all fields into shared
// memory once, with periodic index wrap in place of the TPU's wrapped DMAs
// and z rolls; one thread per point, consecutive threads on consecutive z
// (the contiguous axis), so the tile loads coalesce.  Outputs go to buffers
// no block reads halos from (blocks run in any order, so an aliased write
// would race), except the df of K3', which overwrites df_prev: each point reads
// df_prev only at itself, and every df_prev load precedes the first store.
//
// Parity: the stencil sums (stencil.cuh) use round-to-nearest intrinsics
// (no FMA contraction) in the JAX package's term order, so constant fields
// give exactly zero derivatives and the sums match the plain PyTorch
// version.

#include <cuda_runtime.h>
#include <stddef.h>

#include "stencil.cuh"

#define NC 7           // ux uy uz lnrho ax ay az (registry order)
#define TX 4
#define TY 4
#define TZ 16
#define SX (TX + 2 * NG)
#define SY (TY + 2 * NG)
#define SZ (TZ + 2 * NG)
#define SVOL (SX * SY * SZ)
#define NTHREADS (TX * TY * TZ)
#define SMEM_BYTES (NC * SVOL * (int)sizeof(float))

enum { UX = 0, LNRHO = 3, AX = 4 };

__device__ __forceinline__ int wrap_index(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Host-filled constants, passed by value as the kernel parameter.  The
// layout is mirrored by ctypes in ops/fused_rhs.py.
struct PcParams {
  int nx, ny, nz, isothermal;
  float w1[3];     // first derivative, paired weights o = 1..3
  float w2[3];     // second derivative, paired weights o = 1..3
  float wm[12];    // bidiagonal mixed derivative, signed, JAX tap order
  float inv[3];    // 1/dx, 1/dy, 1/dz
  float invsq[3];  // their squares, rounded in f32
  float nu, eta;
  float cs20, gm1, lnrho0;   // cs2 = cs20*exp(gm1*(lnrho - lnrho0))
  float dxyz2, cdt, dif;     // dif = max(nu, eta)*dxyz2/cdtv
  float x0, y0, dx, dy;      // node coordinates for the kick
};

// The flagship RHS at one point.  `s` points at field 0 of this point in
// the shared tile; field c is at s + c*SVOL.  Term order follows the JAX
// modules (density, hydro, viscosity, magnetic) so that the plain version
// and this kernel sum in the same order.
template <bool WANT_DT1>
__device__ __forceinline__ void flagship_rhs(const float* s, const PcParams& P,
                                             float r[NC], float& dt1) {
  const int st[3] = {SY * SZ, SZ, 1};
  const float u[3] = {s[0], s[SVOL], s[2 * SVOL]};
  const float lnrho = s[LNRHO * SVOL];

  float uij[3][3];   // du_i/dx_j
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      uij[i][j] = __fmul_rn(d1(s + (UX + i) * SVOL, st[j], P.w1), P.inv[j]);
  float gl[3];       // grad lnrho
#pragma unroll
  for (int a = 0; a < 3; ++a)
    gl[a] = __fmul_rn(d1(s + LNRHO * SVOL, st[a], P.w1), P.inv[a]);
  const float divu = (uij[0][0] + uij[1][1]) + uij[2][2];

  // density: -u.grad(lnrho) - div u
  r[LNRHO] = -((u[0] * gl[0] + u[1] * gl[1]) + u[2] * gl[2]) - divu;

  // hydro: -(u.grad)u - cs2 grad(lnrho)
  const float cs2 = P.isothermal
      ? P.cs20 : P.cs20 * expf(P.gm1 * (lnrho - P.lnrho0));
  float duu[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ugu = (u[0] * uij[a][0] + u[1] * uij[a][1]) + u[2] * uij[a][2];
    duu[a] = -ugu + (-cs2) * gl[a];
  }

  // viscosity 'nu-const': nu*(del2 u + grad(div u)/3 + 2 S.grad(lnrho))
  const float div3 = divu / 3.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* ua = s + (UX + a) * SVOL;
    float sgl = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float sab = 0.5f * (uij[a][b] + uij[b][a]);
      if (a == b) sab = sab - div3;
      sgl = (b == 0) ? sab * gl[0] : sgl + sab * gl[b];
    }
    const float dd[3] = {__fmul_rn(d2(ua, st[0], P.w2), P.invsq[0]),
                         __fmul_rn(d2(ua, st[1], P.w2), P.invsq[1]),
                         __fmul_rn(d2(ua, st[2], P.w2), P.invsq[2])};
    const float del2 = (dd[0] + dd[1]) + dd[2];
    float gdiv = dd[a];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j == a) continue;
      const int lo = a < j ? a : j, hi = a < j ? j : a;
      const float m = dmix(s + (UX + j) * SVOL, st[lo], st[hi], P.wm);
      gdiv = gdiv + __fmul_rn(__fmul_rn(m, P.inv[lo]), P.inv[hi]);
    }
    duu[a] = duu[a] + P.nu * ((del2 + (1.0f / 3.0f) * gdiv) + 2.0f * sgl);
  }

  // magnetic: B = curl A, dA/dt = u x B + eta del2 A, du += (J x B)/rho
  float aij[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      aij[i][j] = __fmul_rn(d1(s + (AX + i) * SVOL, st[j], P.w1), P.inv[j]);
  const float bb[3] = {aij[2][1] - aij[1][2], aij[0][2] - aij[2][0],
                       aij[1][0] - aij[0][1]};
  float jj[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* aa = s + (AX + a) * SVOL;
    const float dd[3] = {__fmul_rn(d2(aa, st[0], P.w2), P.invsq[0]),
                         __fmul_rn(d2(aa, st[1], P.w2), P.invsq[1]),
                         __fmul_rn(d2(aa, st[2], P.w2), P.invsq[2])};
    const float del2 = (dd[0] + dd[1]) + dd[2];
    float gdiv = dd[a];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j == a) continue;
      const int lo = a < j ? a : j, hi = a < j ? j : a;
      const float m = dmix(s + (AX + j) * SVOL, st[lo], st[hi], P.wm);
      gdiv = gdiv + __fmul_rn(__fmul_rn(m, P.inv[lo]), P.inv[hi]);
    }
    jj[a] = gdiv - del2;
    const int b1 = (a + 1) % 3, b2 = (a + 2) % 3;
    const float uxb = u[b1] * bb[b2] - u[b2] * bb[b1];
    r[AX + a] = P.eta > 0.0f ? uxb + P.eta * del2 : uxb;
  }
  const float rho1 = expf(-lnrho);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int b1 = (a + 1) % 3, b2 = (a + 2) % 3;
    const float jxb = jj[b1] * bb[b2] - jj[b2] * bb[b1];
    r[UX + a] = duu[a] + jxb * rho1;
  }

  if (WANT_DT1) {
    // CFL (JAX timestep.py:49-100): the wave-speed root joins the
    // advection linearly; advective and diffusive classes combine as RSS
    float adv = (fabsf(u[0]) * P.inv[0] + fabsf(u[1]) * P.inv[1])
                + fabsf(u[2]) * P.inv[2];
    const float b0 = bb[0] * P.inv[0], b1 = bb[1] * P.inv[1],
                b2 = bb[2] * P.inv[2];
    const float va2 = ((b0 * b0 + b1 * b1) + b2 * b2) * rho1;
    adv = adv + sqrtf(cs2 * P.dxyz2 + va2);
    const float dt1a = adv / P.cdt;
    dt1 = P.dif == 0.0f ? dt1a : sqrtf(dt1a * dt1a + P.dif * P.dif);
  }
}

// One template for every kernel: FIRST is substep 1; otherwise DEFER
// rebuilds f1 = f0 + cprev*df1 in the tile and LAST skips the df store.
// FAKE puts f*1.0000001 in place of the RHS (the K8 memory floor).  coef =
// [alpha, beta*dt, cprev] and kick = [k(3), phase, f_re(3), f_im(3), N*dt,
// 0] live on the device, so no launch needs a host copy of dt.  dfin and
// dfout may be one buffer (K3'): each thread reads and writes only its own
// point of them, and loads all of its df_prev before its first store.
template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool FAKE>
__global__ void __launch_bounds__(NTHREADS, 2)
pc_flagship(const PcParams P, const float* __restrict__ fa, const float* dfin,
            const float* __restrict__ coef, const float* __restrict__ kick,
            const float* __restrict__ zc, float* dfout,
            float* __restrict__ faout, float* __restrict__ dt1blk) {
  extern __shared__ float tile[];
  const int tid = threadIdx.x;
  const int tz = tid % TZ, ty = (tid / TZ) % TY, tx = tid / (TZ * TY);
  const int bx = blockIdx.z * TX, by = blockIdx.y * TY, bz = blockIdx.x * TZ;
  const size_t N = (size_t)P.nx * P.ny * P.nz;

  // tile + halo -> shared memory, periodic wrap on every axis
  const float cprev = DEFER ? coef[2] : 0.0f;
  for (int e = tid; e < SVOL; e += NTHREADS) {
    const int iz = e % SZ, iy = (e / SZ) % SY, ix = e / (SZ * SY);
    const size_t g =
        ((size_t)wrap_index(bx + ix - NG, P.nx) * P.ny
         + wrap_index(by + iy - NG, P.ny)) * P.nz
        + wrap_index(bz + iz - NG, P.nz);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float v = fa[c * N + g];
      if (DEFER) v = __fadd_rn(v, __fmul_rn(cprev, dfin[c * N + g]));
      tile[c * SVOL + e] = v;
    }
  }
  __syncthreads();

  const int gx = bx + tx, gy = by + ty, gz = bz + tz;
  const bool active = gx < P.nx && gy < P.ny && gz < P.nz;
  const float* s = tile + ((tx + NG) * SY + (ty + NG)) * SZ + (tz + NG);
  float r[NC];
  float dt1 = 0.0f;
  if (active) {
    if constexpr (FAKE) {
#pragma unroll
      for (int c = 0; c < NC; ++c) r[c] = __fmul_rn(s[c * SVOL], 1.0000001f);
    } else {
      flagship_rhs<FIRST>(s, P, r, dt1);
    }
  }
  const size_t g = ((size_t)gx * P.ny + gy) * P.nz + gz;

  if (FIRST) {
    if (active) {
#pragma unroll
      for (int c = 0; c < NC; ++c) dfout[c * N + g] = r[c];
    }
    block_max_store<NTHREADS>(
        dt1, dt1blk + (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                 + blockIdx.x);
    return;
  }
  if (!active) return;

  const float alpha = coef[0], bdt = coef[1];
  float dfp[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dfp[c] = dfin[c * N + g];
  float fnew[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float dfn = __fadd_rn(__fmul_rn(alpha, dfp[c]), r[c]);
    if (!LAST) dfout[c * N + g] = dfn;
    fnew[c] = __fadd_rn(s[c * SVOL], __fmul_rn(bdt, dfn));
  }
  if (KICK) {
    // helical kick in angle-addition form (JAX fused_rhs.py:441-466):
    // theta = k.x + phase = A + B + C with A, B, C on one axis each
    const float xg = __fadd_rn(P.x0, __fmul_rn(P.dx, (float)gx));
    const float yg = __fadd_rn(P.y0, __fmul_rn(P.dy, (float)gy));
    const float A = __fadd_rn(__fmul_rn(kick[0], xg), kick[3]);
    const float B = __fmul_rn(kick[1], yg);
    const float C = __fmul_rn(kick[2], zc[gz]);
    float sA, cA, sB, cB, sC, cC;
    sincosf(A, &sA, &cA);
    sincosf(B, &sB, &cB);
    sincosf(C, &sC, &cC);
    const float Pc = cA * cB - sA * sB;   // cos(A+B)
    const float Qs = sA * cB + cA * sB;   // sin(A+B)
    const float amp = kick[10];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a = kick[4 + i], b = kick[7 + i];
      const float U = a * cC - b * sC, V = a * sC + b * cC;
      fnew[UX + i] = fnew[UX + i] + amp * (Pc * U - Qs * V);
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) faout[c * N + g] = fnew[c];
}

template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool FAKE>
static int launch(const PcParams* p, const float* fa, const float* dfin,
                  const float* coef, const float* kick, const float* zc,
                  float* dfout, float* faout, float* dt1blk, void* stream) {
  auto kern = pc_flagship<FIRST, DEFER, LAST, KICK, FAKE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p->nz + TZ - 1) / TZ, (p->ny + TY - 1) / TY,
                  (p->nx + TX - 1) / TX);
  kern<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      *p, fa, dfin, coef, kick, zc, dfout, faout, dt1blk);
  return (int)cudaGetLastError();
}

// The substep-1 kernel and the three tail kinds, real or fake.
template <bool FAKE>
static int first(const PcParams* p, const float* fa, float* df,
                 float* dt1blk, void* stream) {
  return launch<true, false, false, false, FAKE>(
      p, fa, nullptr, nullptr, nullptr, nullptr, df, nullptr, dt1blk, stream);
}

template <bool FAKE>
static int tail_defer(const PcParams* p, const float* fa, const float* df1,
                      const float* coef, float* df2, float* f2,
                      void* stream) {
  return launch<false, true, false, false, FAKE>(
      p, fa, df1, coef, nullptr, nullptr, df2, f2, nullptr, stream);
}

// a null kick is an unforced run
template <bool DEFER, bool FAKE>
static int tail_last(const PcParams* p, const float* fa, const float* dfin,
                     const float* coef, const float* kick, const float* zc,
                     float* f, void* stream) {
  if (kick)
    return launch<false, DEFER, true, true, FAKE>(
        p, fa, dfin, coef, kick, zc, nullptr, f, nullptr, stream);
  return launch<false, DEFER, true, false, FAKE>(
      p, fa, dfin, coef, nullptr, zc, nullptr, f, nullptr, stream);
}

extern "C" {

// Tile shape, so the caller can size the per-block dt1 buffer.
int pc_tile_shape(int* out) {
  out[0] = TX;
  out[1] = TY;
  out[2] = TZ;
  return 0;
}

// K1: replaces `kernel` + `_dma_tile_wrap` (pencil_tpu/ops/fused_rhs.py).
int pc_rhs_first(const PcParams* p, const float* fa, float* df,
                 float* dt1blk, void* stream) {
  return first<false>(p, fa, df, dt1blk, stream);
}

// K2: replaces `kernel_tail(defer_prev=True)` (pencil_tpu/ops/fused_rhs.py).
int pc_rhs_tail_defer(const PcParams* p, const float* fa, const float* df1,
                      const float* coef, float* df2, float* f2,
                      void* stream) {
  return tail_defer<false>(p, fa, df1, coef, df2, f2, stream);
}

// K3: replaces `kernel_tail(last=True, with_kick)` (pencil_tpu/ops/
// fused_rhs.py); kick may be null (unforced runs).
int pc_rhs_tail_last(const PcParams* p, const float* fa, const float* df2,
                     const float* coef, const float* kick, const float* zc,
                     float* f3, void* stream) {
  return tail_last<false, false>(p, fa, df2, coef, kick, zc, f3, stream);
}

// K3': replaces the 2N-RK4 middle substeps' `kernel_upd` with the wrap
// fetch (pencil_tpu/ops/fused_rhs.py).  df may be df_prev's own buffer.
int pc_rhs_tail_mid(const PcParams* p, const float* fa, const float* df_prev,
                    const float* coef, float* df, float* f, void* stream) {
  return launch<false, false, false, false, false>(
      p, fa, df_prev, coef, nullptr, nullptr, df, f, nullptr, stream);
}

// K2L: replaces `kernel_tail(defer_prev=True, last=True, with_kick)`
// (pencil_tpu/ops/fused_rhs.py); kick may be null.
int pc_rhs_tail_defer_last(const PcParams* p, const float* fa,
                           const float* df1, const float* coef,
                           const float* kick, const float* zc, float* f,
                           void* stream) {
  return tail_last<true, false>(p, fa, df1, coef, kick, zc, f, stream);
}

// K8: the `PC_FAKE_RHS` branch of `body` (pencil_tpu/ops/fused_rhs.py) in
// K1, K2 and K3, with the same arguments as those.
int pc_rhs_first_fake(const PcParams* p, const float* fa, float* df,
                      float* dt1blk, void* stream) {
  return first<true>(p, fa, df, dt1blk, stream);
}

int pc_rhs_tail_defer_fake(const PcParams* p, const float* fa,
                           const float* df1, const float* coef, float* df2,
                           float* f2, void* stream) {
  return tail_defer<true>(p, fa, df1, coef, df2, f2, stream);
}

int pc_rhs_tail_last_fake(const PcParams* p, const float* fa,
                          const float* df2, const float* coef,
                          const float* kick, const float* zc, float* f3,
                          void* stream) {
  return tail_last<false, true>(p, fa, df2, coef, kick, zc, f3, stream);
}

}  // extern "C"
