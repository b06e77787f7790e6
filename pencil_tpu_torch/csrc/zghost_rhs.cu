// Fused RHS kernels of stratified convection on a z-ghosted stack: the
// conv-slab module set (ideal gas with entropy, lnrho, hydro, constant
// gravity, 'nu-const' viscosity with viscous heating, K-const conduction,
// gaussian heating and cooling layers; 6th-order central differences;
// 2N-RK3) with a non-periodic z axis.
//
// These replace the zghost-mode Pallas kernels of
// pencil_tpu/ops/fused_rhs.py (model.py:704-775), one template instance
// each:
//
//   K6  pc_rhs_zg      <- `kernel_zg` + `_fetch_zg`/`_halo_tile`/
//                         `_window_halo`: df = RHS(f) and the per-block
//                         max of the CFL 1/dt
//   K7  pc_rhs_zg_upd  <- `kernel_zg_upd`: df <- alpha*df_prev + RHS(f),
//                         f <- f_interior + beta*dt*df
//
// The input is the stack ghosted in all three axes by fill_ghosts
// (periodic wrap in x and y, the physical BCs in z), so a block loads its
// (TX, TY, TZ) tile plus the 3-cell halo of all 5 fields into shared
// memory with no index wrap.  The TPU-only layout (the z-in-sublane halo
// windows, YS/ypad, the lane-aligned body/halo split) has no counterpart.
//
// What bounds them on an H100: like K1-K3, each is a stencil over every
// field.  Device memory moves (5 in + 5 out) * 4 B per point for K6 and
// (5 + 5 + 10) * 4 B for K7 (df_prev read, df and f written), ~40-80 B,
// ~0.2-0.4 ms at 256^3 at 3.35 TB/s.  The per-point RHS reads ~270 shared
// values (15 first, 15 second and 6 mixed derivatives) and evaluates four
// expf, so shared-memory bandwidth and latency, not device memory, are the
// expected limit of this first version.  One thread per point,
// consecutive threads on consecutive z (the contiguous axis), so the tile
// loads coalesce.  K7 reads df_prev only at its own point and writes the
// new df over it in place (the JAX alias {4: 0}); f goes to a fresh
// buffer, since other blocks read their halos from the input stack.
//
// Parity: stencil sums in the JAX term order with round-to-nearest
// intrinsics (stencil.cuh); the pointwise physics follows the order of the
// JAX modules (density, hydro, gravity, viscosity, entropy).  The heating
// and cooling profiles depend on z alone and come in as f32 vectors that
// the plain version also reads, so only expf/sqrtf of fields differ from
// XLA.  Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stddef.h>

#include "stencil.cuh"

#define NC 5           // ux uy uz lnrho ss (registry order)
#define TX 4
#define TY 4
#define TZ 16
#define SX (TX + 2 * NG)
#define SY (TY + 2 * NG)
#define SZ (TZ + 2 * NG)
#define SVOL (SX * SY * SZ)
#define NTHREADS (TX * TY * TZ)
#define SMEM_BYTES (NC * SVOL * (int)sizeof(float))

enum { UX = 0, LNRHO = 3, SS = 4 };
enum { FIRST_ZG = 0, UPD_ZG = 1 };

// Host-filled constants, passed by value as the kernel parameter.  The
// layout is mirrored by ctypes in ops/fused_rhs.py (ZgParams).  Each float
// is the f32 rounding of the Python float the plain version multiplies by.
struct ZgParams {
  int nx, ny, nz;
  int has_visc, has_cond, has_cool, has_heat;
  float w1[3];     // first derivative, paired weights o = 1..3
  float w2[3];     // second derivative, paired weights o = 1..3
  float wm[12];    // bidiagonal mixed derivative, signed, JAX tap order
  float inv[3];    // 1/dx, 1/dy, 1/dz
  float invsq[3];  // their squares, rounded in f32
  float nu, two_nu, third;   // viscosity; 2*nu (heating); 1/3
  float gravz;
  float cs20, gm1, g_cp, cp, gamma, lnrho0, lnTT0;
  float hcond0;              // K-const conduction
  float cool, cs2c;          // cooling layer: cool*prof_c*(cs2-cs2c)/cs2c
  float heat_norm;           // heating layer: L/norm * prof_h
  float dxyz2, cdt, cdtv;
};

// The conv-slab RHS at one point.  `s` points at field 0 of this point in
// the shared tile; field c is at s + c*SVOL.  `iz` is the interior z index
// (the profiles' index).
template <bool WANT_DT1>
__device__ __forceinline__ void convslab_rhs(const float* s, int iz,
                                             const ZgParams& P,
                                             const float* prof_c,
                                             const float* prof_h,
                                             float r[NC], float& dt1) {
  const int st[3] = {SY * SZ, SZ, 1};
  const float u[3] = {s[0], s[SVOL], s[2 * SVOL]};
  const float lnrho = s[LNRHO * SVOL];
  const float ss = s[SS * SVOL];

  float uij[3][3];   // du_i/dx_j
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      uij[i][j] = __fmul_rn(d1(s + (UX + i) * SVOL, st[j], P.w1), P.inv[j]);
  float gl[3], gs[3];   // grad lnrho, grad ss
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    gl[a] = __fmul_rn(d1(s + LNRHO * SVOL, st[a], P.w1), P.inv[a]);
    gs[a] = __fmul_rn(d1(s + SS * SVOL, st[a], P.w1), P.inv[a]);
  }
  const float divu = (uij[0][0] + uij[1][1]) + uij[2][2];

  // density: -u.grad(lnrho) - div u
  r[LNRHO] = -((u[0] * gl[0] + u[1] * gl[1]) + u[2] * gl[2]) - divu;

  // equation of state
  const float dlnrho = lnrho - P.lnrho0;
  const float cs2 = P.cs20 * expf(P.g_cp * ss + P.gm1 * dlnrho);
  const float lnTT = (P.lnTT0 + P.g_cp * ss) + P.gm1 * dlnrho;
  const float rho1 = expf(-lnrho);
  const float TT1 = expf(-lnTT);

  // hydro: -(u.grad)u - cs2 (grad lnrho + grad ss/cp); gravity on z
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ugu = (u[0] * uij[a][0] + u[1] * uij[a][1]) + u[2] * uij[a][2];
    r[UX + a] = -ugu + (-cs2) * (gl[a] + gs[a] / P.cp);
  }
  r[UX + 2] = r[UX + 2] + P.gravz;

  // viscosity 'nu-const': nu*(del2 u + grad(div u)/3 + 2 S.grad(lnrho)),
  // and the heating 2 nu S^2 for the entropy equation
  float sij2 = 0.0f;
  if (P.has_visc) {
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
        sij2 = (a == 0 && b == 0) ? sab * sab : sij2 + sab * sab;
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
      r[UX + a] = r[UX + a] + P.nu * ((del2 + P.third * gdiv) + 2.0f * sgl);
    }
  }

  // entropy: -u.grad(ss) + conduction + viscous heating - cooling + heating
  float ds = -((u[0] * gs[0] + u[1] * gs[1]) + u[2] * gs[2]);
  float chi = 0.0f;
  if (P.has_cond) {
    float glnTT2 = 0.0f, d2l = 0.0f, d2s = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float g = P.gm1 * gl[a] + P.g_cp * gs[a];
      glnTT2 = (a == 0) ? g * g : glnTT2 + g * g;
      const float l2 = __fmul_rn(d2(s + LNRHO * SVOL, st[a], P.w2),
                                 P.invsq[a]);
      const float s2 = __fmul_rn(d2(s + SS * SVOL, st[a], P.w2), P.invsq[a]);
      d2l = (a == 0) ? l2 : d2l + l2;
      d2s = (a == 0) ? s2 : d2s + s2;
    }
    const float del2lnTT = P.gm1 * d2l + P.g_cp * d2s;
    const float krho1 = P.hcond0 * rho1;
    ds = ds + krho1 * (del2lnTT + glnTT2);
    chi = (krho1 / P.cp) * P.gamma;
  }
  if (P.has_visc) ds = ds + (P.two_nu * sij2) * TT1;
  if (P.has_cool)
    ds = ds - ((((rho1 * TT1) * P.cool) * prof_c[iz]) * (cs2 - P.cs2c))
                  / P.cs2c;
  if (P.has_heat) ds = ds + ((P.heat_norm * prof_h[iz]) * rho1) * TT1;
  r[SS] = ds;

  if (WANT_DT1) {
    // CFL (JAX timestep.py:49-100): the sound-speed root joins the
    // advection linearly; advective and diffusive classes combine as RSS,
    // the diffusivity being max(nu, chi) at this point
    float adv = (fabsf(u[0]) * P.inv[0] + fabsf(u[1]) * P.inv[1])
                + fabsf(u[2]) * P.inv[2];
    adv = adv + sqrtf(cs2 * P.dxyz2);
    const float dt1a = adv / P.cdt;
    if (P.has_visc || P.has_cond) {
      const float maxdiffus = P.has_visc ? (P.has_cond ? fmaxf(P.nu, chi)
                                                       : P.nu)
                                         : chi;
      const float dif = (maxdiffus * P.dxyz2) / P.cdtv;
      dt1 = sqrtf(dt1a * dt1a + dif * dif);
    } else {
      dt1 = dt1a;
    }
  }
}

// One template for both kernels.  coef = [alpha, beta*dt] lives on the
// device, so no launch needs a host copy of dt.  dfin and dfout may be the
// same buffer (UPD_ZG): each thread reads and writes only its own point.
template <int MODE>
__global__ void __launch_bounds__(NTHREADS, 2)
pc_convslab(const ZgParams P, const float* __restrict__ fg,
            const float* __restrict__ prof_c,
            const float* __restrict__ prof_h, const float* dfin,
            const float* __restrict__ coef, float* dfout,
            float* __restrict__ faout, float* __restrict__ dt1blk) {
  extern __shared__ float tile[];
  const int tid = threadIdx.x;
  const int tz = tid % TZ, ty = (tid / TZ) % TY, tx = tid / (TZ * TY);
  const int bx = blockIdx.z * TX, by = blockIdx.y * TY, bz = blockIdx.x * TZ;
  const int MX = P.nx + 2 * NG, MY = P.ny + 2 * NG, MZ = P.nz + 2 * NG;
  const size_t MG = (size_t)MX * MY * MZ;
  const size_t N = (size_t)P.nx * P.ny * P.nz;

  // tile + halo -> shared memory; the stack is ghosted, so the halo of
  // interior point (x, y, z) is at ghosted (x .. x + 2g, ...): no wrap
  for (int e = tid; e < SVOL; e += NTHREADS) {
    const int iz = e % SZ, iy = (e / SZ) % SY, ix = e / (SZ * SY);
    const int X = bx + ix, Y = by + iy, Z = bz + iz;
    const size_t g = ((size_t)X * MY + Y) * MZ + Z;
    if (X < MX && Y < MY && Z < MZ) {
#pragma unroll
      for (int c = 0; c < NC; ++c) tile[c * SVOL + e] = fg[c * MG + g];
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) tile[c * SVOL + e] = 0.0f;
    }
  }
  __syncthreads();

  const int gx = bx + tx, gy = by + ty, gz = bz + tz;
  const bool active = gx < P.nx && gy < P.ny && gz < P.nz;
  const float* s = tile + ((tx + NG) * SY + (ty + NG)) * SZ + (tz + NG);
  float r[NC];
  float dt1 = 0.0f;
  if (active)
    convslab_rhs<MODE == FIRST_ZG>(s, gz, P, prof_c, prof_h, r, dt1);
  const size_t g = ((size_t)gx * P.ny + gy) * P.nz + gz;

  if (MODE == FIRST_ZG) {
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
  // every df_prev load before the first df store: dfin and dfout may be
  // one buffer, so a load placed after a store could not be hoisted above
  // it, and the five round trips to device memory would run in series
  float dfp[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) dfp[c] = dfin[c * N + g];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float dfn = __fadd_rn(__fmul_rn(alpha, dfp[c]), r[c]);
    dfout[c * N + g] = dfn;
    faout[c * N + g] = __fadd_rn(s[c * SVOL], __fmul_rn(bdt, dfn));
  }
}

template <int MODE>
static int launch(const ZgParams* p, const float* fg, const float* prof_c,
                  const float* prof_h, const float* dfin, const float* coef,
                  float* dfout, float* faout, float* dt1blk, void* stream) {
  auto kern = pc_convslab<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p->nz + TZ - 1) / TZ, (p->ny + TY - 1) / TY,
                  (p->nx + TX - 1) / TX);
  kern<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      *p, fg, prof_c, prof_h, dfin, coef, dfout, faout, dt1blk);
  return (int)cudaGetLastError();
}

extern "C" {

// Tile shape, so the caller can size the per-block dt1 buffer.
int pc_zg_tile_shape(int* out) {
  out[0] = TX;
  out[1] = TY;
  out[2] = TZ;
  return 0;
}

// K6: replaces `kernel_zg` (pencil_tpu/ops/fused_rhs.py).
int pc_rhs_zg(const ZgParams* p, const float* fg, const float* prof_c,
              const float* prof_h, float* df, float* dt1blk, void* stream) {
  return launch<FIRST_ZG>(p, fg, prof_c, prof_h, nullptr, nullptr, df,
                          nullptr, dt1blk, stream);
}

// K7: replaces `kernel_zg_upd` (pencil_tpu/ops/fused_rhs.py).  df may be
// df_prev's own buffer.
int pc_rhs_zg_upd(const ZgParams* p, const float* fg, const float* prof_c,
                  const float* prof_h, const float* df_prev,
                  const float* coef, float* df, float* fa, void* stream) {
  return launch<UPD_ZG>(p, fg, prof_c, prof_h, df_prev, coef, df, fa,
                        nullptr, stream);
}

}  // extern "C"
