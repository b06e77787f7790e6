// Fused RHS kernels of the sheared, rotating MHD box: isothermal MHD (uu,
// lnrho, aa) with Coriolis, the shearing-box terms, 'nu-const' + 'nu-shock'
// + 'hyper3-simplified' viscosity, resistivity and hyper-resistivity, and
// lnrho hyper-diffusion, reading the shock profile from the 8th slot
// (6th-order central differences; 2N-RK orders 1-4) on a fully periodic
// grid whose x faces are shear-periodic, and the same physics without the
// Shear module on a plain periodic grid (the shocked periodic box).
//
// These replace the Pallas kernels of pencil_tpu/ops/fused_rhs.py that
// carry an aux slot (model.py:576-730), one template instance each:
//
//   K4  pc_rhs_zroll          <- `kernel` + `_dma_tile` (zroll mode): df =
//                                RHS(f) and the per-block max of the CFL
//                                1/dt
//   K5  pc_rhs_zroll_upd      <- `kernel_upd` (with the `_dma_tile` fetch):
//                                df <- alpha*df_prev + RHS(f),
//                                f <- f_interior + beta*dt*df
//   K1s pc_rhs_wrap_shock     <- `kernel` + `_dma_tile_wrap` with the shock
//                                slot (wrap mode, an aux module, no Shear)
//   K5w pc_rhs_wrap_shock_upd <- `kernel_upd` + `_dma_tile_wrap`
//
// K4/K5 read the 8-slot stack ghosted in x and y by fill_ghosts (the x
// ghost slabs already Fourier-shifted by +-deltay), z unghosted:
// (8, nx+6, ny+6, nz).  K1s/K5w (WRAP) read the unghosted state
// (8, nx, ny, nz) after the shock pre-pass, with periodic index wrap on all
// three axes, and compile the shear terms out.  A block loads its (TX, TY,
// TZ) tile plus the 3-cell halo of all 8 slots into shared memory, in place
// of the TPU's sublane-aligned or wrapped DMA slabs and z rolls.  The
// TPU-only pieces (ypad, extra_hi, GY = 8, the NSLOT DMA pipeline) have no
// counterpart.
//
// What bounds them on an H100: like K1-K3 each is a stencil over every
// field.  Device memory moves 8 in + 7 out = 60 B per point for K4/K1s and
// 8 + 7 + 14 = 116 B for K5/K5w (df_prev read, df and f written), ~1-2 GB
// at 256^3, ~0.3-0.6 ms at 3.35 TB/s (K4/K5 a little more: their input
// carries the x/y ghosts).  The per-point RHS reads ~650 shared
// values (24 first, 18 second, 12 mixed and 21 sixth derivatives), so, as
// for K1-K3, shared-memory traffic and latency, not device memory, are the
// expected limit of this first version.  One thread per point, consecutive
// threads on consecutive z (the contiguous axis), so the tile loads
// coalesce.  70.4 KB of shared memory per 256-thread block: two blocks fit
// on an SM.  K5/K5w read df_prev only at their own point and write the new
// df over it in place (the JAX alias {2: 0}); f goes to a fresh buffer,
// since other blocks read their halos from the input stack.
//
// Parity: stencil sums in the JAX term order with round-to-nearest
// intrinsics (stencil.cuh); the pointwise physics follows the order of the
// JAX modules (density, hydro, shear, viscosity, magnetic) and, within
// viscosity, nu-const, then nu-shock, then hyper3; without Shear its terms
// are left out and aa's tendency starts at the magnetic module's, as in
// the JAX sums.  The node coordinate x of the shear terms follows the JAX
// tile rule x0 + dx/2 + i*dx in f32.  Built without --use_fast_math.

#include <cuda_runtime.h>
#include <stddef.h>

#include "stencil.cuh"

#define NC 8           // ux uy uz lnrho ax ay az shock (registry order)
#define NVAR 7
#define TX 4
#define TY 4
#define TZ 16
#define SX (TX + 2 * NG)
#define SY (TY + 2 * NG)
#define SZ (TZ + 2 * NG)
#define SVOL (SX * SY * SZ)
#define NTHREADS (TX * TY * TZ)
#define SMEM_BYTES (NC * SVOL * (int)sizeof(float))

enum { UX = 0, LNRHO = 3, AX = 4, SHOCK = 7 };
enum { FIRST_ZR = 0, UPD_ZR = 1 };

__device__ __forceinline__ int wrap_index(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// Host-filled constants, passed by value as the kernel parameter.  The
// layout is mirrored by ctypes in ops/fused_rhs.py (ZrParams).  Each float
// is the f32 rounding of the value the plain version multiplies by; a
// coefficient of 0 switches its term off, as the JAX modules' `> 0` tests.
struct ZrParams {
  int nx, ny, nz, isothermal;
  float w1[3];     // first derivative, paired weights o = 1..3
  float w2[3];     // second derivative, paired weights o = 1..3
  float w6[3];     // 6th difference, paired weights o = 1..3
  float wm[12];    // bidiagonal mixed derivative, signed, JAX tap order
  float inv[3];    // 1/dx, 1/dy, 1/dz
  float invsq[3];  // their squares, rounded in f32
  float inv6[3];   // their 6th powers, x^2 * x^4 in f32
  float nu, nu_shock, nu3;   // viscosity flavours
  float eta, eta3;           // resistivity, hyper-resistivity
  float diff3;               // lnrho hyper-diffusion
  float om[3];               // Omega vector (Coriolis off when all 0)
  float S;                   // shear rate, background flow S*x in y
                             // (0 without Shear)
  float cs20, gm1, lnrho0;   // cs2 = cs20*exp(gm1*(lnrho - lnrho0))
  float dxyz2, cdt, cdtv;
  float dif3;                // max(nu3, eta3, diff3)*dxyz6/cdtv3
  float x0, dx;              // first x node and spacing
};

// sum_a d6_a(f)*inv_a^6, the del6 of one field at one point
__device__ __forceinline__ float del6(const float* p, const int st[3],
                                      const ZrParams& P) {
  float acc = __fmul_rn(d6(p, st[0], P.w6), P.inv6[0]);
  acc = __fadd_rn(acc, __fmul_rn(d6(p, st[1], P.w6), P.inv6[1]));
  acc = __fadd_rn(acc, __fmul_rn(d6(p, st[2], P.w6), P.inv6[2]));
  return acc;
}

// del2 (per component) and grad(div) of the vector at `v` (component c at
// v + c*SVOL): the flagship kernel's sums (fused_rhs.cu).
__device__ __forceinline__ void del2_graddiv(const float* v, const int st[3],
                                             const ZrParams& P, float del2[3],
                                             float gdiv[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* va = v + a * SVOL;
    const float dd[3] = {__fmul_rn(d2(va, st[0], P.w2), P.invsq[0]),
                         __fmul_rn(d2(va, st[1], P.w2), P.invsq[1]),
                         __fmul_rn(d2(va, st[2], P.w2), P.invsq[2])};
    del2[a] = (dd[0] + dd[1]) + dd[2];
    float g = dd[a];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j == a) continue;
      const int lo = a < j ? a : j, hi = a < j ? j : a;
      const float m = dmix(v + j * SVOL, st[lo], st[hi], P.wm);
      g = g + __fmul_rn(__fmul_rn(m, P.inv[lo]), P.inv[hi]);
    }
    gdiv[a] = g;
  }
}

// The shear-box RHS at one point.  `s` points at slot 0 of this point in
// the shared tile; slot c is at s + c*SVOL.  `x` is the point's x node,
// read only with SHEAR (the Shear module's terms).
template <bool WANT_DT1, bool SHEAR>
__device__ __forceinline__ void shearbox_rhs(const float* s, float x,
                                             const ZrParams& P,
                                             float r[NVAR], float& dt1) {
  const int st[3] = {SY * SZ, SZ, 1};
  const float u[3] = {s[0], s[SVOL], s[2 * SVOL]};
  const float lnrho = s[LNRHO * SVOL];

  float uij[3][3], aij[3][3];   // du_i/dx_j, dA_i/dx_j
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      uij[i][j] = __fmul_rn(d1(s + (UX + i) * SVOL, st[j], P.w1), P.inv[j]);
      aij[i][j] = __fmul_rn(d1(s + (AX + i) * SVOL, st[j], P.w1), P.inv[j]);
    }
  float gl[3];       // grad lnrho
#pragma unroll
  for (int a = 0; a < 3; ++a)
    gl[a] = __fmul_rn(d1(s + LNRHO * SVOL, st[a], P.w1), P.inv[a]);
  const float divu = (uij[0][0] + uij[1][1]) + uij[2][2];

  // density: -u.grad(lnrho) - div u [+ D3 del6 lnrho]
  float rl = -((u[0] * gl[0] + u[1] * gl[1]) + u[2] * gl[2]) - divu;
  if (P.diff3 > 0.0f) rl = rl + P.diff3 * del6(s + LNRHO * SVOL, st, P);

  // hydro: -(u.grad)u - cs2 grad(lnrho) - 2 Omega x u
  const float cs2 = P.isothermal
      ? P.cs20 : P.cs20 * expf(P.gm1 * (lnrho - P.lnrho0));
  float duu[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ugu = (u[0] * uij[a][0] + u[1] * uij[a][1]) + u[2] * uij[a][2];
    duu[a] = -ugu + (-cs2) * gl[a];
  }
  if (P.om[0] != 0.0f || P.om[1] != 0.0f || P.om[2] != 0.0f) {
    const float c[3] = {
        __fsub_rn(__fmul_rn(P.om[1], u[2]), __fmul_rn(P.om[2], u[1])),
        __fsub_rn(__fmul_rn(P.om[2], u[0]), __fmul_rn(P.om[0], u[2])),
        __fsub_rn(__fmul_rn(P.om[0], u[1]), __fmul_rn(P.om[1], u[0]))};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      duu[a] = __fadd_rn(duu[a], __fmul_rn(-2.0f, c[a]));
  }

  // shear: -S x d/dy on every evolved field, duy -= S ux, dAx -= S Ay
  const float muy0 = SHEAR ? -__fmul_rn(P.S, x) : 0.0f;
  float ra[3];
  if (SHEAR) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      duu[a] = __fadd_rn(duu[a], __fmul_rn(muy0, uij[a][1]));
      ra[a] = __fmul_rn(muy0, aij[a][1]);
    }
    rl = __fadd_rn(rl, __fmul_rn(muy0, gl[1]));
    duu[1] = __fadd_rn(duu[1], __fmul_rn(-P.S, u[0]));
    ra[0] = __fadd_rn(ra[0], __fmul_rn(-P.S, s[(AX + 1) * SVOL]));
  }
  r[LNRHO] = rl;

  // viscosity: nu (del2 u + grad(div u)/3 + 2 S.grad(lnrho)), then
  // nu_sh [shock (grad(div u) + div u grad lnrho) + div u grad shock],
  // then nu3 del6 u
  {
    float del2u[3], gdivu[3];
    del2_graddiv(s + UX * SVOL, st, P, del2u, gdivu);
    const float shock = s[SHOCK * SVOL];
    float gsh[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      gsh[a] = P.nu_shock > 0.0f
          ? __fmul_rn(d1(s + SHOCK * SVOL, st[a], P.w1), P.inv[a]) : 0.0f;
    const float div3 = divu / 3.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      bool any = false;
      float fv = 0.0f;
      if (P.nu > 0.0f) {
        float sgl = 0.0f;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          float sab = 0.5f * (uij[a][b] + uij[b][a]);
          if (a == b) sab = sab - div3;
          sgl = (b == 0) ? sab * gl[0] : sgl + sab * gl[b];
        }
        fv = P.nu * ((del2u[a] + (1.0f / 3.0f) * gdivu[a]) + 2.0f * sgl);
        any = true;
      }
      if (P.nu_shock > 0.0f) {
        const float t = P.nu_shock
            * (shock * (gdivu[a] + divu * gl[a]) + divu * gsh[a]);
        fv = any ? fv + t : t;
        any = true;
      }
      if (P.nu3 > 0.0f) {
        const float t = P.nu3 * del6(s + (UX + a) * SVOL, st, P);
        fv = any ? fv + t : t;
        any = true;
      }
      if (any) duu[a] = __fadd_rn(duu[a], fv);
    }
  }

  // magnetic: B = curl A, dA/dt += u x B + eta del2 A + eta3 del6 A,
  // du += (J x B)/rho
  const float bb[3] = {aij[2][1] - aij[1][2], aij[0][2] - aij[2][0],
                       aij[1][0] - aij[0][1]};
  float jj[3];
  {
    float del2a[3], gdiva[3];
    del2_graddiv(s + AX * SVOL, st, P, del2a, gdiva);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      jj[a] = gdiva[a] - del2a[a];
      const int b1 = (a + 1) % 3, b2 = (a + 2) % 3;
      float out = u[b1] * bb[b2] - u[b2] * bb[b1];
      if (P.eta > 0.0f) out = out + P.eta * del2a[a];
      if (P.eta3 > 0.0f) out = out + P.eta3 * del6(s + (AX + a) * SVOL, st, P);
      r[AX + a] = SHEAR ? __fadd_rn(ra[a], out) : out;
    }
  }
  const float rho1 = expf(-lnrho);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int b1 = (a + 1) % 3, b2 = (a + 2) % 3;
    const float jxb = jj[b1] * bb[b2] - jj[b2] * bb[b1];
    r[UX + a] = __fadd_rn(duu[a], jxb * rho1);
  }

  if (WANT_DT1) {
    // CFL (JAX timestep.py:49-100): linear advection plus the background
    // shear flow, the wave-speed root joining linearly; advective and
    // diffusive classes combine as RSS, the diffusivity being
    // max(nu, nu_sh*shock, eta) at this point plus the constant del6 rate
    float adv = (fabsf(u[0]) * P.inv[0] + fabsf(u[1]) * P.inv[1])
                + fabsf(u[2]) * P.inv[2];
    if (SHEAR) adv = __fadd_rn(adv, __fmul_rn(fabsf(muy0), P.inv[1]));
    const float b0 = bb[0] * P.inv[0], b1 = bb[1] * P.inv[1],
                b2 = bb[2] * P.inv[2];
    const float va2 = ((b0 * b0 + b1 * b1) + b2 * b2) * rho1;
    adv = adv + sqrtf(cs2 * P.dxyz2 + va2);
    const float dt1a = adv / P.cdt;
    const bool has_dif = P.nu > 0.0f || P.nu_shock > 0.0f || P.eta > 0.0f;
    float md = 0.0f;
    if (P.nu > 0.0f) md = P.nu;
    if (P.nu_shock > 0.0f) md = fmaxf(md, P.nu_shock * s[SHOCK * SVOL]);
    if (P.eta > 0.0f) md = fmaxf(md, P.eta);
    float dif = has_dif ? (md * P.dxyz2) / P.cdtv : 0.0f;
    if (P.dif3 > 0.0f) dif = has_dif ? dif + P.dif3 : P.dif3;
    dt1 = (has_dif || P.dif3 > 0.0f) ? sqrtf(dt1a * dt1a + dif * dif) : dt1a;
  }
}

// One template for the four kernels: MODE is substep 1 or a later one;
// WRAP reads the unghosted stack with index wrap and has no Shear module.
// coef = [alpha, beta*dt] lives on the device, so no launch needs a host
// copy of dt.  dfin and dfout may be the same buffer (UPD_ZR): each thread
// reads and writes only its own point.
template <int MODE, bool WRAP>
__global__ void __launch_bounds__(NTHREADS, 2)
pc_shearbox(const ZrParams P, const float* __restrict__ fg,
            const float* dfin, const float* __restrict__ coef, float* dfout,
            float* __restrict__ faout, float* __restrict__ dt1blk) {
  extern __shared__ float tile[];
  const int tid = threadIdx.x;
  const int tz = tid % TZ, ty = (tid / TZ) % TY, tx = tid / (TZ * TY);
  const int bx = blockIdx.z * TX, by = blockIdx.y * TY, bz = blockIdx.x * TZ;
  const int MX = P.nx + 2 * NG, MY = P.ny + 2 * NG;
  const size_t MG = (size_t)MX * MY * P.nz;
  const size_t N = (size_t)P.nx * P.ny * P.nz;

  // tile + halo -> shared memory.  WRAP: every axis wraps.  Otherwise x
  // and y are ghosted in the stack, so the halo of interior point (x, y) is
  // at ghosted (x .. x + 2g, y .. y + 2g), and z wraps
  for (int e = tid; e < SVOL; e += NTHREADS) {
    const int iz = e % SZ, iy = (e / SZ) % SY, ix = e / (SZ * SY);
    const int X = bx + ix, Y = by + iy;
    if (WRAP) {
      const size_t g =
          ((size_t)wrap_index(X - NG, P.nx) * P.ny
           + wrap_index(Y - NG, P.ny)) * P.nz
          + wrap_index(bz + iz - NG, P.nz);
#pragma unroll
      for (int c = 0; c < NC; ++c) tile[c * SVOL + e] = fg[c * N + g];
    } else if (X < MX && Y < MY) {
      const size_t g = ((size_t)X * MY + Y) * P.nz
                       + wrap_index(bz + iz - NG, P.nz);
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
  const float x = WRAP ? 0.0f : __fadd_rn(P.x0, __fmul_rn(P.dx, (float)gx));
  float r[NVAR];
  float dt1 = 0.0f;
  if (active) shearbox_rhs<MODE == FIRST_ZR, !WRAP>(s, x, P, r, dt1);
  const size_t g = ((size_t)gx * P.ny + gy) * P.nz + gz;

  if (MODE == FIRST_ZR) {
    if (active) {
#pragma unroll
      for (int c = 0; c < NVAR; ++c) dfout[c * N + g] = r[c];
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
  // it, and the round trips to device memory would run in series
  float dfp[NVAR];
#pragma unroll
  for (int c = 0; c < NVAR; ++c) dfp[c] = dfin[c * N + g];
#pragma unroll
  for (int c = 0; c < NVAR; ++c) {
    const float dfn = __fadd_rn(__fmul_rn(alpha, dfp[c]), r[c]);
    dfout[c * N + g] = dfn;
    faout[c * N + g] = __fadd_rn(s[c * SVOL], __fmul_rn(bdt, dfn));
  }
}

template <int MODE, bool WRAP>
static int launch(const ZrParams* p, const float* fg, const float* dfin,
                  const float* coef, float* dfout, float* faout,
                  float* dt1blk, void* stream) {
  auto kern = pc_shearbox<MODE, WRAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p->nz + TZ - 1) / TZ, (p->ny + TY - 1) / TY,
                  (p->nx + TX - 1) / TX);
  kern<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      *p, fg, dfin, coef, dfout, faout, dt1blk);
  return (int)cudaGetLastError();
}

extern "C" {

// Tile shape, so the caller can size the per-block dt1 buffer.
int pc_zr_tile_shape(int* out) {
  out[0] = TX;
  out[1] = TY;
  out[2] = TZ;
  return 0;
}

// K4: replaces `kernel` + `_dma_tile` (pencil_tpu/ops/fused_rhs.py, zroll).
int pc_rhs_zroll(const ZrParams* p, const float* fg, float* df,
                 float* dt1blk, void* stream) {
  return launch<FIRST_ZR, false>(p, fg, nullptr, nullptr, df, nullptr,
                                 dt1blk, stream);
}

// K5: replaces `kernel_upd` (pencil_tpu/ops/fused_rhs.py).  df may be
// df_prev's own buffer.
int pc_rhs_zroll_upd(const ZrParams* p, const float* fg,
                     const float* df_prev, const float* coef, float* df,
                     float* fa, void* stream) {
  return launch<UPD_ZR, false>(p, fg, df_prev, coef, df, fa, nullptr,
                               stream);
}

// K1s: replaces `kernel` + `_dma_tile_wrap` with the shock slot
// (pencil_tpu/ops/fused_rhs.py, wrap mode with an aux module); fa is the
// unghosted 8-slot state.
int pc_rhs_wrap_shock(const ZrParams* p, const float* fa, float* df,
                      float* dt1blk, void* stream) {
  return launch<FIRST_ZR, true>(p, fa, nullptr, nullptr, df, nullptr, dt1blk,
                                stream);
}

// K5w: replaces `kernel_upd` + `_dma_tile_wrap` (pencil_tpu/ops/
// fused_rhs.py).  df may be df_prev's own buffer.
int pc_rhs_wrap_shock_upd(const ZrParams* p, const float* fa,
                          const float* df_prev, const float* coef, float* df,
                          float* f, void* stream) {
  return launch<UPD_ZR, true>(p, fa, df_prev, coef, df, f, nullptr, stream);
}

}  // extern "C"
