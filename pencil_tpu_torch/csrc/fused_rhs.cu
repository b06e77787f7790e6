// Fused RHS kernels of the flagship step: forced isothermal MHD (uu, lnrho,
// aa; 6th-order central differences; 2N-RK orders 1-4) on a fully periodic
// grid, with optional Coriolis.  Built with -DPC_MAG=0 the same template
// gives the hydro instances (K1h, K2h, K3h, K3'h, K2Lh): forced hydro
// turbulence on the 4 fields uu, lnrho, with the magnetic terms, the
// Alfven speed in the CFL and K8 compiled out.
//
// These replace the Pallas kernels of pencil_tpu/ops/fused_rhs.py that the
// flagship step launches (model.py:650-703), one template instance each
// (the JAX kernels trace whatever module set they are built for, so the
// same calls serve both sets):
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
// What bounds them on an H100: every kernel is a stencil over all 7 fields
// (hydro: 4).  Device memory moves (nc + nvar)*4 B in and nvar*4 B (K2,
// K3': 2*nvar*4 B) out per point, 56-112 B (hydro 32-64 B), which at 3.35
// TB/s is ~0.3-0.6 ms (0.16-0.32 ms) per kernel at 256^3; the ~900 (~460)
// operations per point take ~0.22 (~0.11) ms at 67 TFLOP/s, so device
// memory is the bound.  Beyond it sit the ~280 shared-memory reads
// and ~1,300 issued instructions per point of the RHS, and, for a design
// that reloads halos, the traffic from L2 into shared memory; K8 measures
// what the loads and the stores alone cost.
//
// Design: a block owns a column of TY x TZ = 8 x 32 points in (y, z), one
// thread per point with a warp along 32 consecutive z (the contiguous
// axis: coalesced rows, stencil reads free of bank conflicts), and marches
// along x over a segment of MX planes.  It keeps the 2*NG + 1 planes
// x-3 .. x+3 of all NC fields, each with its y/z halo, in a ring of shared-
// memory slots, so each step loads one new plane and the halo costs
// (14*38)/(8*32) * (MX+6)/MX = 2.3x the points instead of the 8.6x of a
// 4x4x16 tile.  The loads are cp.async copies PD planes ahead of the
// planes the stencil needs, so they overlap the compute of the current
// plane; wrapped addresses are computed once per block (z) and once per
// row (x, y), never per element, and the aligned body of a row goes in
// 16-byte copies when nz % 4 == 0.  The x taps come from ring slots (the
// *_ring helpers of stencil.cuh, same sums as d1/d2/dmix).  DEFER lands df1
// of each incoming plane in a staging slot and rebuilds f1 = f0 + cprev*df1
// in the ring slot once per element; a thread keeps its own point's df1 of
// the next planes in registers, so df1 is read from device memory once.
// The other tails copy each point's own df_prev (no halo) with the same
// cp.async groups into a small ring, so no step waits on a global load.
// One 256-thread block per SM (141-188 KB of shared memory; hydro 81-105
// KB), 8 warps.
// Outputs go to buffers no block reads halos from (blocks run in any
// order, so an aliased write would race), except the df of K3', which
// overwrites df_prev: each point reads df_prev only at itself, and its
// copy of a plane's df_prev lands before it stores there.
//
// Parity: the stencil sums (stencil.cuh) use round-to-nearest intrinsics
// (no FMA contraction) in the JAX package's term order, so constant fields
// give exactly zero derivatives and the sums match the plain PyTorch
// version.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "stencil.cuh"

#ifndef PC_MAG
#define PC_MAG 1       // 0: the hydro instances, no aa fields
#endif
#define NC (PC_MAG ? 7 : 4)   // ux uy uz lnrho [ax ay az] (registry order)
#ifndef PC_MX
#define PC_MX 64       // planes of a block's x segment
#endif
#define MX PC_MX
#define TY 8
#define TZ 32
#define NTHREADS (TY * TZ)
#ifndef PC_PD
#define PC_PD 2        // planes in flight beyond those the stencil needs
#endif
#define PD PC_PD
#define NR (2 * NG + 1 + PD)   // ring slots
#define PY (TY + 2 * NG)       // rows of a plane: y with its halo
#define PZ 40                  // row pitch; z = bz + i sits at ZOFF + i
#define ZOFF 4                 // so the row body is 16-byte aligned
#define FPL (PY * PZ)          // one field of a plane
#define SLOT (NC * FPL)        // one plane of all fields
#define NROWS (NC * PY)

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
  float om[3];               // Omega; -2 Omega x u when not all zero
};

// Derivatives along axis j of the ring layout: x (j = 0) from the ring
// slots at offsets xo, y and z at the fixed strides st[1], st[2].
__device__ __forceinline__ float dj1(const float* p, int j, const int* st,
                                     const int* xo, const float* w) {
  return j == 0 ? d1_ring(p, xo, w) : d1(p, st[j], w);
}

__device__ __forceinline__ float dj2(const float* p, int j, const int* st,
                                     const int* xo, const float* w) {
  return j == 0 ? d2_ring(p, xo, w) : d2(p, st[j], w);
}

__device__ __forceinline__ float djmix(const float* p, int lo, int hi,
                                       const int* st, const int* xo,
                                       const float* wm) {
  return lo == 0 ? dmix_ring(p, xo, st[hi], wm)
                 : dmix(p, st[lo], st[hi], wm);
}

// The flagship RHS at one point.  `s` points at field 0 of this point in
// the ring slot of its plane; field c is at s + c*FPL, the x taps at the
// offsets xo.  Term order follows the JAX modules (density, hydro with its
// Coriolis force, viscosity, magnetic) so that the plain version and this
// kernel sum in the same order.  ROT adds -2 Omega x u (a template flag,
// so that the instances without rotation carry no trace of it).
template <bool WANT_DT1, bool ROT>
__device__ __forceinline__ void flagship_rhs(const float* s, const int* xo,
                                             const PcParams& P, float r[NC],
                                             float& dt1) {
  const int st[3] = {0, PZ, 1};
  const float u[3] = {s[0], s[FPL], s[2 * FPL]};
  const float lnrho = s[LNRHO * FPL];

  float uij[3][3];   // du_i/dx_j
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      uij[i][j] = __fmul_rn(dj1(s + (UX + i) * FPL, j, st, xo, P.w1),
                            P.inv[j]);
  float gl[3];       // grad lnrho
#pragma unroll
  for (int a = 0; a < 3; ++a)
    gl[a] = __fmul_rn(dj1(s + LNRHO * FPL, a, st, xo, P.w1), P.inv[a]);
  const float divu = (uij[0][0] + uij[1][1]) + uij[2][2];

  // density: -u.grad(lnrho) - div u
  r[LNRHO] = -((u[0] * gl[0] + u[1] * gl[1]) + u[2] * gl[2]) - divu;

  // hydro: -(u.grad)u - cs2 grad(lnrho) - 2 Omega x u
  const float cs2 = P.isothermal
      ? P.cs20 : P.cs20 * expf(P.gm1 * (lnrho - P.lnrho0));
  float duu[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ugu = (u[0] * uij[a][0] + u[1] * uij[a][1]) + u[2] * uij[a][2];
    duu[a] = -ugu + (-cs2) * gl[a];
  }
  if constexpr (ROT) {
    const float c[3] = {
        __fsub_rn(__fmul_rn(P.om[1], u[2]), __fmul_rn(P.om[2], u[1])),
        __fsub_rn(__fmul_rn(P.om[2], u[0]), __fmul_rn(P.om[0], u[2])),
        __fsub_rn(__fmul_rn(P.om[0], u[1]), __fmul_rn(P.om[1], u[0]))};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      duu[a] = __fadd_rn(duu[a], __fmul_rn(-2.0f, c[a]));
  }

  // viscosity 'nu-const': nu*(del2 u + grad(div u)/3 + 2 S.grad(lnrho))
  const float div3 = divu / 3.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* ua = s + (UX + a) * FPL;
    float sgl = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float sab = 0.5f * (uij[a][b] + uij[b][a]);
      if (a == b) sab = sab - div3;
      sgl = (b == 0) ? sab * gl[0] : sgl + sab * gl[b];
    }
    const float dd[3] = {__fmul_rn(dj2(ua, 0, st, xo, P.w2), P.invsq[0]),
                         __fmul_rn(dj2(ua, 1, st, xo, P.w2), P.invsq[1]),
                         __fmul_rn(dj2(ua, 2, st, xo, P.w2), P.invsq[2])};
    const float del2 = (dd[0] + dd[1]) + dd[2];
    float gdiv = dd[a];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j == a) continue;
      const int lo = a < j ? a : j, hi = a < j ? j : a;
      const float m = djmix(s + (UX + j) * FPL, lo, hi, st, xo, P.wm);
      gdiv = gdiv + __fmul_rn(__fmul_rn(m, P.inv[lo]), P.inv[hi]);
    }
    duu[a] = duu[a] + P.nu * ((del2 + (1.0f / 3.0f) * gdiv) + 2.0f * sgl);
  }

#if PC_MAG
  // magnetic: B = curl A, dA/dt = u x B + eta del2 A, du += (J x B)/rho
  float aij[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      aij[i][j] = __fmul_rn(dj1(s + (AX + i) * FPL, j, st, xo, P.w1),
                            P.inv[j]);
  const float bb[3] = {aij[2][1] - aij[1][2], aij[0][2] - aij[2][0],
                       aij[1][0] - aij[0][1]};
  float jj[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* aa = s + (AX + a) * FPL;
    const float dd[3] = {__fmul_rn(dj2(aa, 0, st, xo, P.w2), P.invsq[0]),
                         __fmul_rn(dj2(aa, 1, st, xo, P.w2), P.invsq[1]),
                         __fmul_rn(dj2(aa, 2, st, xo, P.w2), P.invsq[2])};
    const float del2 = (dd[0] + dd[1]) + dd[2];
    float gdiv = dd[a];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j == a) continue;
      const int lo = a < j ? a : j, hi = a < j ? j : a;
      const float m = djmix(s + (AX + j) * FPL, lo, hi, st, xo, P.wm);
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
#else
#pragma unroll
  for (int a = 0; a < 3; ++a) r[UX + a] = duu[a];
#endif

  if (WANT_DT1) {
    // CFL (JAX timestep.py:49-100): the wave-speed root joins the
    // advection linearly; advective and diffusive classes combine as RSS
    float adv = (fabsf(u[0]) * P.inv[0] + fabsf(u[1]) * P.inv[1])
                + fabsf(u[2]) * P.inv[2];
#if PC_MAG
    const float b0 = bb[0] * P.inv[0], b1 = bb[1] * P.inv[1],
                b2 = bb[2] * P.inv[2];
    const float va2 = ((b0 * b0 + b1 * b1) + b2 * b2) * rho1;
    adv = adv + sqrtf(cs2 * P.dxyz2 + va2);
#else
    adv = adv + sqrtf(cs2 * P.dxyz2);
#endif
    const float dt1a = adv / P.cdt;
    dt1 = P.dif == 0.0f ? dt1a : sqrtf(dt1a * dt1a + P.dif * P.dif);
  }
}

// ---- the plane loader -----------------------------------------------------
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// What one thread copies of each row (one field, one y, the 38 z of the
// column with its halo) it takes, fixed for the block: rows r0, r0 +
// rstep, ...; copy k takes z index zk to row position dk (dk < 0: none).
// With `vec` a half-warp takes a row: 8 lanes copy its 32-float body in
// 16-byte pieces, 6 lanes its 3 + 3 halo floats; otherwise a warp takes a
// row in 4-byte pieces.  Every wrap is done here, once.
struct RowCopy {
  int r0, rstep, z0, d0, z1, d1;
  bool v16;        // copy 0 is 16 bytes
};

__device__ __forceinline__ RowCopy row_copy_plan(int bz, int nz, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  RowCopy rc;
  rc.z1 = 0;
  rc.d1 = -1;
  if (vec) {
    const int h = lane & 15;
    rc.r0 = 2 * warp + (lane >> 4);
    rc.rstep = NTHREADS / 16;
    rc.v16 = h < TZ / 4;
    if (h < TZ / 4) {                   // the body, no wrap (bz + TZ <= nz)
      rc.z0 = bz + 4 * h;
      rc.d0 = ZOFF + 4 * h;
    } else if (h < TZ / 4 + 2 * NG) {   // the low, then the high halo
      const int k = h - TZ / 4;
      const int i = k < NG ? k - NG : TZ + k - NG;
      rc.z0 = wrap_index(bz + i, nz);
      rc.d0 = ZOFF + i;
    } else {
      rc.z0 = 0;
      rc.d0 = -1;
    }
  } else {
    rc.r0 = warp;
    rc.rstep = NTHREADS / 32;
    rc.v16 = false;
    rc.z0 = wrap_index(bz - NG + lane, nz);
    rc.d0 = ZOFF - NG + lane;
    if (32 + lane < TZ + 2 * NG) {
      rc.z1 = wrap_index(bz - NG + 32 + lane, nz);
      rc.d1 = ZOFF - NG + 32 + lane;
    }
  }
  return rc;
}

// Shared memory of an instance, in floats: the ring; with DEFER, NS
// staging slots of df1's planes; in the other tails, NQ slots of each
// thread's own df_prev (no halo) of the planes in flight.  Past ~196 KB
// the SM's L1 shrinks to 28 KB and the copies slow down (PD = 3 and padded
// builds measured 2-25 % slower), so PD = 2 keeps every instance below.
#define NS PD
#define NQ (PD + NG + 1)
template <bool FIRST, bool DEFER>
constexpr int smem_floats() {
  return NR * SLOT + (DEFER ? NS * SLOT : 0)
         + (!FIRST && !DEFER ? NQ * NC * NTHREADS : 0);
}

// 227 KB is what one block may use on Hopper; the static yrow and
// block_max_store's red[] take the last few bytes
static_assert(4 * smem_floats<false, true>() + 256 <= 232448, "DEFER ring");
static_assert(4 * smem_floats<false, false>() + 256 <= 232448, "tail ring");
static_assert(SLOT % 4 == 0 && PZ % 4 == 0 && ZOFF % 4 == 0,
              "16-byte rows");

// One template for every kernel: FIRST is substep 1; otherwise DEFER
// rebuilds f1 = f0 + cprev*df1 in the ring and LAST skips the df store.
// FAKE puts f*1.0000001 in place of the RHS (the K8 memory floor); ROT
// adds the Coriolis force (launch() picks it where P.om is not 0).  coef =
// [alpha, beta*dt, cprev] and kick = [k(3), phase, f_re(3), f_im(3), N*dt,
// 0] live on the device, so no launch needs a host copy of dt.  dfin and
// dfout may be one buffer (K3'): each thread reads and writes only its own
// point of them, and copies its df_prev of a plane before it stores there.
// `vec`: nz % 4 == 0 and fa (and, with DEFER, dfin) 16-byte aligned.
//
// Plane l of the block is x = x0 - NG + l, l = 0 .. np + 2 NG - 1, in ring
// slot l % NR (staging slot l % NS); computing plane j (x0 + j) reads
// planes j .. j + 2 NG.  Each step waits for plane j + 2 NG, then a barrier
// makes it visible and frees the slot of plane j - 1 (with DEFER, the
// plane's f1 is rebuilt by all threads and a second barrier follows); the
// step issues plane j + 2 NG + PD into that slot and computes.  cp.async
// groups are committed one per plane, empty past the end, so the count to
// wait for is always PD - 1.  (Rebuilding, each thread, only the elements
// it copied, before a single barrier, measured 17-20 % slower on K2.)
template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool FAKE, bool ROT>
__global__ void __launch_bounds__(NTHREADS, 1)
pc_flagship(const PcParams P, const float* __restrict__ fa, const float* dfin,
            const float* __restrict__ coef, const float* __restrict__ kick,
            const float* __restrict__ zc, float* dfout,
            float* __restrict__ faout, float* __restrict__ dt1blk, int vec) {
  constexpr bool OWN = !FIRST && !DEFER;   // df_prev at the point, staged
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* stage = smem + NR * SLOT;     // DEFER
  float* ownq = smem + NR * SLOT;      // OWN: [NQ][NC][NTHREADS]
  __shared__ int yrow[PY];             // wrapped y of each row, times nz
  const int tid = threadIdx.x;
  const int tz = tid % TZ, ty = tid / TZ;
  const int x0 = blockIdx.z * MX, by = blockIdx.y * TY, bz = blockIdx.x * TZ;
  const int gy = by + ty, gz = bz + tz;
  const bool active = gy < P.ny && gz < P.nz;
  const int np = min(MX, P.nx - x0);   // planes computed
  const int nl = np + 2 * NG;          // planes loaded
  const size_t N = (size_t)P.nx * P.ny * P.nz;
  const size_t plane = (size_t)P.ny * P.nz;
  if (tid < PY) yrow[tid] = wrap_index(by - NG + tid, P.ny) * P.nz;
  const RowCopy rc = row_copy_plan(bz, P.nz, vec && bz + TZ <= P.nz);
  __syncthreads();

  auto issue = [&](int l) {
    if (l < nl) {
      const size_t xoff = (size_t)wrap_index(x0 - NG + l, P.nx) * plane;
      float* slot = ring + (l % NR) * SLOT;
      float* stg = stage + (l % NS) * SLOT;
      for (int r = rc.r0; r < NROWS; r += rc.rstep) {
        const int c = r / PY, iy = r - c * PY;
        const size_t g = c * N + xoff + yrow[iy];
        const int d = c * FPL + iy * PZ;
        if (rc.d0 >= 0) {
          if (rc.v16) {
            cp_async16(slot + d + rc.d0, fa + g + rc.z0);
            if (DEFER) cp_async16(stg + d + rc.d0, dfin + g + rc.z0);
          } else {
            cp_async4(slot + d + rc.d0, fa + g + rc.z0);
            if (DEFER) cp_async4(stg + d + rc.d0, dfin + g + rc.z0);
          }
        }
        if (rc.d1 >= 0) {
          cp_async4(slot + d + rc.d1, fa + g + rc.z1);
          if (DEFER) cp_async4(stg + d + rc.d1, dfin + g + rc.z1);
        }
      }
      if (OWN && active && l >= NG && l < np + NG) {
        const size_t g = xoff + (size_t)gy * P.nz + gz;
        float* o = ownq + (l % NQ) * NC * NTHREADS + tid;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          cp_async4(o + c * NTHREADS, dfin + c * N + g);
      }
    }
    cp_async_commit();
  };

  // DEFER, once plane l has landed: this thread's own df1 of it onto the
  // end of q, which holds planes j + NG .. j + 2 NG in step j (q[0]: the
  // df1 of the plane computed), then f1 = f0 + cprev*df1 over the plane's
  // slot, shared by all threads
  const int own = (ty + NG) * PZ + ZOFF + tz;
  const float cprev = DEFER ? coef[2] : 0.0f;
  float q[NG + 1][NC];
  auto rebuild = [&](int l) {
    const float* stg = stage + (l % NS) * SLOT;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int k = 0; k < NG; ++k) q[k][c] = q[k + 1][c];
      q[NG][c] = stg[c * FPL + own];
    }
    float4* s4 = reinterpret_cast<float4*>(ring + (l % NR) * SLOT);
    const float4* d4 = reinterpret_cast<const float4*>(stg);
    for (int e = tid; e < SLOT / 4; e += NTHREADS) {
      float4 v = s4[e];
      const float4 d = d4[e];
      v.x = __fadd_rn(v.x, __fmul_rn(cprev, d.x));
      v.y = __fadd_rn(v.y, __fmul_rn(cprev, d.y));
      v.z = __fadd_rn(v.z, __fmul_rn(cprev, d.z));
      v.w = __fadd_rn(v.w, __fmul_rn(cprev, d.w));
      s4[e] = v;
    }
  };

  if (DEFER) {
    // PD planes in flight at a time: a staging slot frees when its plane
    // is rebuilt
    for (int l = 0; l < PD; ++l) issue(l);
    for (int l = 0; l < 2 * NG; ++l) {
      cp_async_wait<PD - 1>();
      __syncthreads();
      rebuild(l);
      __syncthreads();
      issue(l + PD);
    }
  } else {
    for (int l = 0; l < 2 * NG + PD; ++l) issue(l);
  }

  const float* s0 = ring + own;
  float dt1max = 0.0f;
  for (int j = 0; j < np; ++j) {
    cp_async_wait<PD - 1>();
    __syncthreads();
    if (DEFER) {
      rebuild(j + 2 * NG);
      __syncthreads();
    }
    issue(j + 2 * NG + PD);

    // this plane's slot, and its x neighbours' offsets from it
    const int sc = (j + NG) % NR;
    int xo[2 * NG + 1];
#pragma unroll
    for (int k = 0; k <= 2 * NG; ++k) xo[k] = ((j + k) % NR - sc) * SLOT;
    const float* s = s0 + sc * SLOT;
    const int gx = x0 + j;
    float r[NC];
    float dt1 = 0.0f;
    if (!active) continue;
    if constexpr (FAKE) {
#pragma unroll
      for (int c = 0; c < NC; ++c) r[c] = __fmul_rn(s[c * FPL], 1.0000001f);
    } else {
      flagship_rhs<FIRST, ROT>(s, xo, P, r, dt1);
    }
    const size_t g = ((size_t)gx * P.ny + gy) * P.nz + gz;

    if (FIRST) {
#pragma unroll
      for (int c = 0; c < NC; ++c) dfout[c * N + g] = r[c];
      dt1max = fmaxf(dt1max, dt1);
      continue;
    }

    const float alpha = coef[0], bdt = coef[1];
    float dfp[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dfp[c] = DEFER ? q[0][c]
                     : ownq[((j + NG) % NQ * NC + c) * NTHREADS + tid];
    float fnew[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float dfn = __fadd_rn(__fmul_rn(alpha, dfp[c]), r[c]);
      if (!LAST) dfout[c * N + g] = dfn;
      fnew[c] = __fadd_rn(s[c * FPL], __fmul_rn(bdt, dfn));
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
  if (FIRST)
    block_max_store<NTHREADS>(
        dt1max, dt1blk + (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                    + blockIdx.x);
}

template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool FAKE, bool ROT>
static int launch_as(const PcParams* p, const float* fa, const float* dfin,
                     const float* coef, const float* kick, const float* zc,
                     float* dfout, float* faout, float* dt1blk, void* stream) {
  auto kern = pc_flagship<FIRST, DEFER, LAST, KICK, FAKE, ROT>;
  const int smem = 4 * smem_floats<FIRST, DEFER>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = p->nz % 4 == 0 && (uintptr_t)fa % 16 == 0
                  && (!DEFER || (uintptr_t)dfin % 16 == 0);
  const dim3 grid((p->nz + TZ - 1) / TZ, (p->ny + TY - 1) / TY,
                  (p->nx + MX - 1) / MX);
  kern<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      *p, fa, dfin, coef, kick, zc, dfout, faout, dt1blk, vec);
  return (int)cudaGetLastError();
}

// The instance with the Coriolis force where Omega is not 0 (K8 has none).
template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool FAKE>
static int launch(const PcParams* p, const float* fa, const float* dfin,
                  const float* coef, const float* kick, const float* zc,
                  float* dfout, float* faout, float* dt1blk, void* stream) {
  if constexpr (!FAKE) {
    if (p->om[0] != 0.0f || p->om[1] != 0.0f || p->om[2] != 0.0f)
      return launch_as<FIRST, DEFER, LAST, KICK, false, true>(
          p, fa, dfin, coef, kick, zc, dfout, faout, dt1blk, stream);
  }
  return launch_as<FIRST, DEFER, LAST, KICK, FAKE, false>(
      p, fa, dfin, coef, kick, zc, dfout, faout, dt1blk, stream);
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

// Registers, local (spill) bytes per thread, static and dynamic shared
// memory per block, and resident blocks per SM of one instance (without
// rotation).
template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool FAKE>
static int attrs(int* out) {
  auto kern = pc_flagship<FIRST, DEFER, LAST, KICK, FAKE, false>;
  const int smem = 4 * smem_floats<FIRST, DEFER>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kern);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        NTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = smem;
  out[4] = blocks;
  return 0;
}

extern "C" {

// The per-block extent (x, y, z) = (MX, TY, TZ), so the caller can size
// the per-block dt1 buffer: one value per block of the launch grid.
int pc_tile_shape(int* out) {
  out[0] = MX;
  out[1] = TY;
  out[2] = TZ;
  return 0;
}

// attrs() of instance `which`: 0 K1, 1 K8-K1, 2 K2, 3 K8-K2, 4/5 K3 with
// and without the kick, 6/7 K8-K3 with and without, 8 K3', 9/10 K2L with
// and without the kick.  The hydro build has no K8 (1, 3, 6, 7).
int pc_flagship_attrs(int which, int* out) {
  switch (which) {
    case 0: return attrs<true, false, false, false, false>(out);
    case 2: return attrs<false, true, false, false, false>(out);
    case 4: return attrs<false, false, true, true, false>(out);
    case 5: return attrs<false, false, true, false, false>(out);
#if PC_MAG
    case 1: return attrs<true, false, false, false, true>(out);
    case 3: return attrs<false, true, false, false, true>(out);
    case 6: return attrs<false, false, true, true, true>(out);
    case 7: return attrs<false, false, true, false, true>(out);
#endif
    case 8: return attrs<false, false, false, false, false>(out);
    case 9: return attrs<false, true, true, true, false>(out);
    case 10: return attrs<false, true, true, false, false>(out);
    default: return (int)cudaErrorInvalidValue;
  }
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

#if PC_MAG
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
#endif  // PC_MAG

}  // extern "C"
