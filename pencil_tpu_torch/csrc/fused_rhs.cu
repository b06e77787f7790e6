// Fused RHS kernels of the flagship step: forced isothermal MHD (uu, lnrho,
// aa; 6th-order central differences; 2N-RK orders 1-4) on a fully periodic
// grid, with optional Coriolis.  Built with -DPC_MAG=0 the same template
// gives the hydro instances (K1h, K2h, K3h, K3'h, K2Lh): forced hydro
// turbulence on the 4 fields uu, lnrho, with the magnetic terms, the
// Alfven speed in the CFL and K8 compiled out.  Built with -DPC_ENT=1 it
// gives the non-isothermal instances, with an entropy field ss between
// lnrho and aa (the registry order): K1e, K2e, K3e, K3'e, K2Le on the 8
// fields uu, lnrho, ss, aa, and with -DPC_MAG=0 as well K1he ... K2Lhe on
// the 5 fields uu, lnrho, ss.  They add the ideal-gas cs2(lnrho, ss), the
// pressure force of grad ss, Ds/Dt = -u.grad ss, 'chi-const' and 'K-const'
// conduction, viscous and Ohmic heating, and the conductive rate in the
// CFL; with PC_ENT=0 all of that compiles out.  Each of these four builds
// has an instance with the flag H3 of every kernel: del6 hyper-diffusion
// of u, A and lnrho ('hyper3-simplified', eta_hyper3, diffrho_hyper3) and
// its constant rate in the CFL, picked on the host where a hyper
// coefficient is not 0 (forced turbulence with a long inertial range).
// Built with -DPC_SHOCK=1 it
// gives the shocked periodic box's K1s (pc_rhs_first) and K5w
// (pc_rhs_tail_mid): the MHD fields with the shock profile as an 8th,
// read-only slot, and its terms (nu-shock, the shock diffusivity in the
// CFL, and in the instances with the flag H3 del6 hyper-diffusion of u, A
// and lnrho); with -DPC_MAG=0 as well K1sh and K5wh, supersonic hydro
// turbulence on the 5 slots uu, lnrho, shock.  With -DPC_SHEAR=1 it gives
// the shear box's K4 and K5, which read the stack ghosted in x and y by
// the shear-periodic fill, (nc, nx+6, ny+6, nz), and add the Shear
// module's terms: with -DPC_SHOCK=1 on the 8 slots uu, lnrho, aa, shock
// (K4, K5), without it on the 7 fields uu, lnrho, aa (K4n, K5n), and
// with -DPC_MAG=0 on uu, lnrho, shock (K4h, K5h) or uu, lnrho (K4hn,
// K5hn).  With -DPC_ENT=1 the shock and shear builds take an entropy
// field too: with -DPC_MAG=0 K1she, K5whe on uu, lnrho, ss, shock
// (non-isothermal supersonic turbulence), K4he, K5he and K4hne, K5hne the
// hydro shear box with ss, with and without the shock slot; with aa K1se,
// K5wse on the 9 slots uu, lnrho, ss, aa, shock (non-isothermal MHD shock
// turbulence), K4e, K5e and K4ne, K5ne the MHD shear box with ss, with and
// without the shock slot (9 slots, 8 fields); they add the entropy terms
// of the periodic entropy builds, the shock's viscous heat nu_sh shock
// (div u)^2, with aa the Ohmic heat after it, and the shear's -S x
// dss/dy.  These builds replace the
// `kernel` / `kernel_upd` calls of the
// zroll fetch and of the wrap fetch with an aux slot (model.py:576-730)
// and have no DEFER, LAST, KICK or FAKE instance: the shock pre-pass
// rebuilds the slot between substeps, and the shear box kicks after the
// step.  They join their terms in the Pallas kernels' order, each join
// rounded on its own (PC_JOINS), shock slot or not.  Built with -DPC_ZG=1
// (with -DPC_MAG=0 -DPC_ENT=1) it gives stratified convection's K6
// (pc_rhs_first) and K7 (pc_rhs_tail_mid) on the 5 fields uu, lnrho, ss:
// the entropy-hydro terms with K-const conduction and viscous heating
// compiled in and the cooling and heating layers, whose profiles depend on
// z alone; z has physical boundaries.  Its march
// reads the body rows from the interior stack, x and y wrapped as in the
// periodic builds, and the three z-ghost cells below z = 0 and above z =
// nz - 1 from two slabs (5, nx, ny, NG), zlo and zhi, that a z-only ghost
// fill cut (the split of JAX's `_fetch_zg`): only the halo lanes of the
// blocks at the two z ends read a slab.  No DEFER, LAST, KICK or FAKE
// instance either.  Built with -DPC_ENT=1 -DPC_ZG=1 (PC_MAG left at 1) it
// gives magnetoconvection's K6m and K7m on the 8 fields uu, lnrho, ss, aa
// and their slabs (8, nx, ny, NG): the z-ghosted terms with the MHD ones
// of the wrap builds (u x B + eta del2 A, the Lorentz force, Ohmic heating,
// the Alfven speed in the CFL), eta and the Ohmic heat compiled in as the
// conduction is.  Both z-ghosted builds have a Coriolis (ROT) instance of
// each kernel, the rotating conv-slab's, and one with the flag CHI, which
// adds 'chi-const' conduction beside K-const (its rate chi gamma is part
// of the constant maxdif of the CFL), with and without rotation, and
// instances with the flag H3, the del6 terms of the periodic builds (their
// +-3 taps in z are what the slabs hold), with and without CHI and
// rotation: eight instances of each kernel.  Built with -DPC_ZG=1
// -DPC_SHEAR=1 (and -DPC_ENT=1, with or without -DPC_MAG=0) they give the
// stratified shearing box's K6s and K7s on uu, lnrho, ss and, with aa,
// K6ms and K7ms: the same z-ghosted terms and instances plus the Shear
// module's, joined as the shear builds join theirs (PC_JOINS).  Their
// body is the stack ghosted in x and y by the shear-periodic fill, (nc,
// nx+6, ny+6, nz), read at ghosted offsets as the shear builds read it,
// and their slabs are the z ghosts of that ghosted stack, (nc, nx+6,
// ny+6, NG), so the z ghosts beside the shifted x faces are the z BCs
// applied to those faces, as JAX's 3-axis fill gives them.  Built with
// -DPC_ZG=1 without -DPC_ENT (with or without -DPC_MAG=0, with or without
// -DPC_SHEAR=1) they give the isothermal stratified layer's K6i/K7i (uu,
// lnrho), K6mi/K7mi (uu, lnrho, aa), K6si/K7si and K6msi/K7msi (the same
// with Shear, the stratified isothermal shearing box): the z-ghosted
// march and Shear terms on the periodic builds' isothermal terms, no
// conduction, heating or layers.  Their CFL rate is the periodic builds'
// constant one; they have ROT and H3 instances, no CHI.  Built with
// -DPC_ZG=1 -DPC_ENT=1 -DPC_SHOCK=1 (with or without -DPC_MAG=0) they give
// stratified convection's and magnetoconvection's K6k/K7k and K6mk/K7mk
// with the shock profile as a read-only 6th or 9th slot, its z ghosts in
// the slabs beside the other fields' (the slot's own z BC, 's'): the
// z-ghosted terms plus nu-shock (the shock viscous force and heat, the
// shock diffusivity in the CFL) and, in their SHK instances, the shock
// diffusivities, joined as the shock builds join theirs (PC_JOINS).  They
// have ROT, CHI and UPW instances and a SHK twin of each, no H3 (del6
// beside the slot is refused on the host): sixteen instances a kernel.
//
// Every build but K8 adds gravity on uz: g_z(z), any z profile of the
// Gravity module, read from a vector of nz floats (ZgIn.grav).  A
// thread's z is fixed along its x-march, so the vector costs one load a
// thread before the march and one add a point; without gravity the
// pointer is null and the add is of -0, which leaves every sum bit for
// bit as it is without the term (one add in every instance, no
// compile-time flag: PERF.md §6 has the registers and times beside the
// builds without the term).  Every build but K8 also adds the continuous
// forcing (the Forcing module's lforcing_cont) to du/dt last, read at the
// point from a field (3, nx, ny, nz) (ZgIn.fcont), each plane's values
// loaded while the plane before it is computed (loaded before the RHS of
// their own plane, K1 and K3 ran 17-23 % over the unforced ones), behind
// a test of the pointer, which is uniform: where the forcing is off the
// pointer is null and none of it runs (adds of -0 and loads under a
// per-thread predicate measured 2-3 % on K1 and K2; PERF.md §6).  Every
// MHD build adds the imposed uniform field B_ext to B = curl A where B is
// formed (PcParams.bext, -0 in a component that is 0: three adds of a
// parameter, within the noise of the parent), so that u x B, J x B/rho
// and the Alfven speed read it, as the JAX Pencils.bb gives it.  Every
// build has instances with the flag UPW (picked on the host where an lupw
// flag is on, never beside H3): the 5th-order upwinding of the advection
// of lnrho, u and ss (the reference's der6_upwind), each field behind a
// uniform test of its own flag.  The shock builds have instances with the
// flag SHK (picked where a shock diffusivity is not 0, beside each of
// their other instances) that add the shock diffusivities of lnrho, A and
// ss (diffrho_shock, eta_shock, chi_shock), each behind a uniform test of
// its coefficient: the three tests in every instance cost K1se 4.5 % with
// the coefficients at 0 (PERF.md §6).  Every H3 instance weights the del6
// of u and of lnrho by weights of their own (PcParams.h6u, h6l: 1/dx^6 of
// 'hyper3-simplified', or dline_1/60 of the mesh flavour, 'hyper3-mesh'
// and diffrho_hyper3_mesh, whose coefficient is then c pi^-5), A's by
// 1/dx^6, and its first kernels add the mesh flavours' constant rate
// (PcParams.hmesh, 0 without them) to the advective CFL after the
// wave-speed root.  SAFI (the shear flow's advection as a shift between
// substeps, on the host) needs no instance: the shear builds take the
// flow's x nodes at 0 (PcParams.x0, dx), so its advection terms and CFL
// rate add 0.  Every instance also takes Viscosity's other flavours
// and Density's diffrho as parameters: 'nu-simplified', 'rho-nu-const',
// the bulk zeta and diffrho in every build, 'shock-simple' in the builds
// with the shock slot, 'nu-cspeed' in the z-ghosted builds with ss and,
// in the H3 instances, the anisotropic del6 'hyper3_nu-const_aniso' (its
// del6 the H3 term with nu3 = 1 and the weights nu3_j/dx_j^6, its
// advective part sum_j u_{i,j} dlnrho_j nu3_j).  Behind one uniform test
// of PcParams.visx (any of them on), after a plane's outputs are stored,
// visx_rhs forms their terms and heat, reading the ring anew, the outputs
// are stored again with them, and visx_dt1 joins their largest per-point
// CFL rate (visx_rate) to the instance's diffusive maximum; not taken,
// the instance runs its march of before up to its stores (untaken, the
// terms tested inside the RHS measured 4-13 % slower, added between the
// RHS and the stores 3-6 %: both split the schedule; PERF.md §6).
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
//   K6  pc_rhs_first (PC_ZG)   <- `kernel_zg` + `_fetch_zg` (:317, :301)
//   K7  pc_rhs_tail_mid (PC_ZG) <- `kernel_zg_upd` (:349): df written over
//                                 df_prev, f = f + bdt*df
//   K6m, K7m                    <- the same two, traced with Magnetic
//   K6s, K7s, K6ms, K7ms        <- the same two, traced with Shear (and
//                                 Magnetic): `_fetch_zg` of the 3-axis fill
//                                 with the shifted x faces
//   K6i, K7i, K6mi, K7mi,       <- the same two, traced without Entropy (and
//   K6si, K7si, K6msi, K7msi      with Magnetic, with Shear)
//
// What bounds them on an H100: every kernel is a stencil over all 7 fields
// (hydro: 4).  Device memory moves (nc + nvar)*4 B in and nvar*4 B (K2,
// K3': 2*nvar*4 B) out per point, 56-112 B (hydro 32-64 B; with the
// entropy field 64-128 B and 40-80 B), which at 3.35 TB/s is ~0.3-0.6 ms
// (0.16-0.32 ms; 0.32-0.64 and 0.20-0.40 ms) per kernel at 256^3; the ~800
// (~440; ~980 and ~620) operations per point take ~0.20 ms at 67 TFLOP/s,
// so by the roofline device memory is the bound.  The shock builds read
// 8 slots and write 7 fields (K1s, K4: 60 B a point, K4's ghosted input a
// little more; K5w, K5: 116 B) in 0.30-0.59 ms, and do ~850 operations a
// point (K4, K5 with del6 of 7 fields: ~1,190, 0.30 ms).  The z-ghosted
// build reads 5 fields and the slabs (0.5 B a point at 256^3) and writes
// 5 (K6: 40.5 B, 0.21 ms) or reads df_prev and writes 10 (K7: 80.5 B,
// 0.41 ms), ~750 operations a point; with aa (K6m: 64.75 B, 0.32 ms; K7m:
// 128.75 B, 0.64 ms) ~1,070.  That rate
// assumes that every instruction is an FMA, and what these kernels are
// held by comes before it: the instructions they issue.  Counted in the
// SASS (sass_counts.py), K1 issues 1,169 instructions per point at 256^3,
// of which 628 FP32, 249 shared-memory loads and 213 integer and address
// arithmetic (K3: 1,215; K2: 1,333; K1s 1,301, K5w 1,346, K4 1,488, K5
// 1,523, K6 990, K7 989; before the redesign of this phase K1 issued
// 1,658: 832 FP32, 298 loads); 132 SMs x 4 schedulers x 32 lanes
// at 1.98 GHz issue them in 0.59 ms, above the 0.28 ms of its bytes, and
// the shared-memory loads alone (one warp's worth per SM and clock) take
// 0.50 ms.  The kernels reach ~0.6 instructions per scheduler and
// clock: with one 256-thread block per SM a scheduler has two warps to
// cover the latency of a shared load (~23 clocks) and of the dependent
// sums.  K8 measures what the loads and the stores alone cost.
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
// plane.  All threads issue a plane's copies right after the step's
// barrier, so what the copies cost is their instructions and the latency
// of the chain that forms their addresses: each row's offsets (the field,
// the wrapped y) sit in a table in shared memory, every wrap of z is done
// once per thread, the wrapped x and the slots are carried from plane to
// plane, and a row's copies are predicated straight-line code (no branch
// per row), the aligned body in 16-byte pieces when nz % 4 == 0.  DEFER
// lands df1 of each incoming plane in a staging slot and rebuilds f1 = f0
// + cprev*df1 in the ring slot once per element; a thread keeps its own
// point's df1 of the next planes in registers, so df1 is read from device
// memory once.  The other tails copy each point's own df_prev (no halo)
// with the same cp.async groups into a small ring, so no step waits on a
// global load.
//
// The shear build's source is the stack ghosted in x and y: its rows and
// planes sit at ghosted offsets without a wrap (z still wraps), and its
// outputs and df_prev keep the unghosted layout.
//
// The RHS phase is built to issue less.  A thread marches along x, so the
// seven x taps of each field at its point are values it has already read:
// it keeps them in registers, moves them one plane on per step and reads
// one new tap per field (1 shared load where there were 7; the y, z and
// diagonal taps still come from the ring).  The stencil sums use FMAs and
// factor the diagonal pairs (see sum1, sum2, summix).  Of the forcing
// kick's phase theta = A(x) + B(y) + C(z), sin and cos of every A, B and C
// are formed once per launch by a pre-pass (pc_kick_phases); a block reads
// its planes' into shared memory and a thread its row's and its own
// before the march, where the rotated amplitudes U, V are formed too, so
// that a point pays two angle additions and no sincosf.  Outputs go
// through one pointer per buffer that moves a plane on per step.
// One 256-thread block per SM (141-188 KB of shared memory; hydro 81-105
// KB; with the entropy field 161-197 KB and 101-132 KB; the shock builds
// 161-183 KB: a 9-slot ring of 8-slot planes and, in the update, the own
// df_prev queue of 7 fields; with ss and aa 161-186 KB: 9-slot planes in
// a ring of 8 (PD = 1), or 8-slot ones in 9, and an 8-field queue), 8
// warps, up to 255 registers a thread; the
// 4-field K1, whose ring is 81 KB, runs two blocks per SM at 128
// registers.  Splitting a point's RHS over two warp
// groups (512 threads: the uu and lnrho terms, the aa terms, four floats
// handed over through shared memory at a named barrier) was built and
// measured: at 128 registers a thread K2, K3 and K2L spill, and K1, which
// does not, is still 5 % slower than one group with 255.
// Outputs go to buffers no block reads halos from (blocks run in any
// order, so an aliased write would race), except the df of K3' (K5, K5w,
// K7), which overwrites df_prev: each point reads df_prev only at itself,
// and its copy of a plane's df_prev lands (cp.async.wait_group at the top
// of the step that computes the plane) before it stores there.
//
// Parity: the stencil sums form their differences first, round to nearest
// and follow the JAX package's term order up to the FMA and the factored
// diagonal pairs, so constant fields give exactly zero derivatives and the
// sums match the plain PyTorch version within 1e-6 of a field's maximum.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "stencil.cuh"

#ifndef PC_MAG
#define PC_MAG 1       // 0: the hydro instances, no aa fields
#endif
#ifndef PC_ENT
#define PC_ENT 0       // 1: the non-isothermal instances, with the ss field
#endif
#ifndef PC_SHOCK
#define PC_SHOCK 0     // 1: the shock slot and its terms (K1s, K5w)
#endif
#ifndef PC_SHEAR
#define PC_SHEAR 0     // 1: the shear box's ghosted source and terms (K4, K5)
#endif
#ifndef PC_ZG
#define PC_ZG 0        // 1: the conv-slab's z-ghosted source, terms (K6, K7;
#endif                 //    with PC_MAG K6m, K7m; without PC_ENT K6i ...)
#if PC_ZG && PC_SHOCK && (PC_SHEAR || !PC_ENT)
#error "the z-ghosted builds with a shock slot are the conv-slab's (PC_ENT)"
#endif
// the builds with the DEFER, LAST and KICK instances: a shear build, with
// or without the shock slot, runs its first kernel and the update only
#define PC_TAILS (!PC_SHOCK && !PC_SHEAR && !PC_ZG)
// the shock and shear builds join their terms in the order of the Pallas
// zroll and wrap kernels they replace, each join rounded on its own (the
// z-ghosted shear builds too, in the order of the zghost kernel traced
// with Shear: gravity, shear, viscosity, magnetic, entropy)
#define PC_JOINS (PC_SHOCK || PC_SHEAR)
// rows of the source's y: the shear builds' source is ghosted in y
#define SRC_NY(ny) ((ny) + (PC_SHEAR ? 2 * NG : 0))
// ux uy uz lnrho [ss] [ax ay az] [shock] (registry order)
#define NC (4 + PC_ENT + (PC_MAG ? 3 : 0) + PC_SHOCK)
#define NV (NC - PC_SHOCK)     // evolved fields: the shock slot is only read
#ifndef PC_MX
#define PC_MX 64       // planes of a block's x segment
#endif
#define MX PC_MX
#define TY 8
#define TZ 32
#define NTHREADS (TY * TZ)     // one thread per point of the column
// planes in flight beyond those the stencil needs: 2, or 1 for a 9-slot
// ring, whose update at 2 holds 206 KB, past the ~196 KB carve-out
// (measured 9-11 % slower than at 1 on an NVIDIA H100 80GB HBM3 at
// 700 W; the first kernel the same)
#ifndef PC_PD
#define PC_PD (NC >= 9 ? 1 : 2)
#endif
#define PD PC_PD
#define NX (2 * NG + 1)        // x taps of the stencil
#define NR (NX + PD)           // ring slots
#define PY (TY + 2 * NG)       // rows of a plane: y with its halo
#define PZ 40                  // row pitch; z = bz + i sits at ZOFF + i
#define ZOFF 4                 // so the row body is 16-byte aligned
#define FPL (PY * PZ)          // one field of a plane
#define SLOT (NC * FPL)        // one plane of all fields
#define NROWS (NC * PY)

enum { UX = 0, LNRHO = 3, SS = 4, AX = 4 + PC_ENT, SHOCK = NV };

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
  // node coordinates: of the kick, and in the shear builds x0 and dx of
  // the shear flow S x (0 under SAFI, which shifts the fields between
  // substeps instead: the flow's advection terms and CFL rate then add 0,
  // while the stretching terms keep S)
  float x0, y0, dx, dy;
  float om[3];               // Omega; -2 Omega x u when not all zero
  // the entropy instances (PC_ENT): cs2 = cs20*exp(g_cp*ss + gm1*(lnrho -
  // lnrho0)), lnT = lnTT0 + g_cp*ss + gm1*(lnrho - lnrho0)
  float g_cp, cp, gamma, lnTT0;
  float cpchi;               // cp*chi of 'chi-const', 0 when off
  float hcond0;              // K of 'K-const', 0 when off
  float two_nu, eta_heat;    // heating: 2 nu S^2, eta J^2 (0: none)
  float maxdif, cdtv;        // K-const: dif = max(maxdif, K gamma/(rho cp))
                             //          * dxyz2 / cdtv at each point
  // the shock builds (PC_SHOCK), each 0 where its term is off: nu-shock,
  // del6 hyper-diffusion of u, A and lnrho and its constant CFL rate
  // max(nu3, eta3, diff3)*dxyz6/cdtv3, and (PC_SHEAR) the shear rate S of
  // the background flow S*x along y
  float nu_shock, nu3, eta3, diff3, dif3;
  float w6[3];     // 6th difference, paired weights o = 1..3
  float inv6[3];   // 1/dx^6, 1/dy^6, 1/dz^6 as x^2*x^4 in f32
  float S;
  // the z-ghosted builds with ss (PC_ZG, PC_ENT): the cooling layer
  // cool*prof_c*(cs2 - cs2c)/(cs2c rho T) and the heating layer
  // heat_norm*prof_h/(rho T)
  float cool, cs2c, heat_norm;
  // the imposed uniform field B_ext of the MHD builds, added to curl A
  // (-0 in a component that is 0)
  float bext[3];
  // the shock builds' shock diffusivities, each 0 where its term is off:
  // of lnrho (diffrho_shock), of A (eta_shock, with A) and of ss
  // (chi_shock, with ss), and gamma*chi_shock, its CFL rate per shock
  float diffrho_shock, eta_shock, chi_shock, gchi_shock;
  // upwinding (the UPW instances): 1/(60 dx_a) in f32, and whether it acts
  // on lnrho, on u and on ss (lupw_lnrho, lupw_uu, lupw_ss)
  float upw_inv[3];
  int upw[3];
  // the del6 weights of u and of lnrho per axis: inv6 of
  // 'hyper3-simplified', dline_1/60 of the mesh flavour ('hyper3-mesh',
  // diffrho_hyper3_mesh, whose coefficient nu3 or diff3 is then c pi^-5;
  // A's del6, which has no mesh flavour, takes inv6); and the constant
  // root of the mesh flavours' rates, which the H3 instances add to the
  // advective CFL (0 without them)
  float h6u[3], h6l[3];
  float hmesh;
  // the z-ghosted builds with ss: the CHI instances' conduction term is
  // A (del2 lnT + sum_a (kp_rho dlnrho_a + kp_T dlnT_a) dlnT_a), with A =
  // cpchi exp(kq_rho lnrho + kq_T lnT) clipped to [kmin, kmax] where kmax
  // > 0 and the CFL rate A gamma/cp at each point, where kexp is set
  // ('kramers': cpchi = K0; 'chi-cspeed': cp chi); without kexp it is
  // chi-const's cpchi (del2 lnT + grad lnT.(grad lnT + grad lnrho)), its
  // rate chi gamma in maxdif
  float kq_rho, kq_T, kp_rho, kp_T, kmin, kmax;
  int kexp;
  // and every instance of theirs: Newtonian cooling cp_g (T - ttref)/
  // (tau_cool T) (cp_g = cp/gamma) and the uniform heating and cooling
  // (heat_uniform - cool_uniform rho cp T)/(rho T), each 0 where off
  float tau_cool, ttref, cp_g, heat_uniform, cool_uniform;
  // Viscosity's other flavours and Density's diffrho, every instance,
  // behind one uniform test of visx (any of them on; not taken, every
  // instance computes what it did without them), each 0 where it is off:
  // 'nu-simplified' nu_s, 'rho-nu-const' nu_r, 'rho-nu-const-bulk' zeta,
  // diffrho, and where the build has their inputs 'shock-simple' nu_ss
  // (the shock slot), 'nu-cspeed' nu_t with its exponent nu_c (the
  // z-ghosted builds with ss) and the anisotropic nu3_j of
  // 'hyper3_nu-const_aniso' (the H3 instances, whose del6 of u then has
  // nu3 = 1 and the weights nu3_j/dx_j^6); the constant rates of nu_s and
  // diffrho are in maxdif and dif, the anisotropic del6's in dif3
  int visx;
  float nu_s, nu_r, zeta, diffrho, nu_ss, nu_t, nu_c;
  float nua[3];
};

enum { H6U, H6L, H6A };

// The z inputs beside the stack: of the z-ghosted builds the z-halo slabs
// (NC, nx, ny, NG) below z = 0 and above z = nz - 1 and, with PC_ENT, the
// cooling and heating profiles (nz; zeros where a layer is off), which the
// other builds pass as null; of every build gravity g_z(z) (nz), null
// without gravity, and the continuous forcing (3, nx, ny, nz), the
// layout of df, null where it is off; of the z-ghosted builds with ss
// K(z) and dK/dz(z) of 'K-profile' (2, nz), null where it is off.
struct ZgIn {
  const float* zlo;
  const float* zhi;
  const float* prof_c;
  const float* prof_h;
  const float* grav;
  const float* fcont;
  const float* kprof;
};

// ---- the template's own stencil sums --------------------------------------
// The paired sums of the JAX stencils (pencil_tpu/ops/stencil.py:145-184,
// :277-328) on values instead of addresses, so that
// the x taps can come from registers, and with fewer instructions: each
// weighted term joins its sum by one FMA, and the four taps of a diagonal
// offset, whose weights are +-one value, are summed before that value
// multiplies them: 6, 10 and 12 instructions for d1, d2 and dmix instead
// of 8, 12 and 23.  Differences are still formed first, so a constant
// field gives exactly zero; the rounding differs from sums in the JAX
// order by less than 1e-6 of a field's maximum.

// sum_o w_o*(p_o - m_o)
__device__ __forceinline__ float sum1(float p1, float m1, float p2, float m2,
                                      float p3, float m3, const float* w) {
  float acc = __fmul_rn(w[0], __fsub_rn(p1, m1));
  acc = __fmaf_rn(w[1], __fsub_rn(p2, m2), acc);
  return __fmaf_rn(w[2], __fsub_rn(p3, m3), acc);
}

// sum_o w_o*((p_o + m_o) - 2 c)
__device__ __forceinline__ float sum2(float c, float p1, float m1, float p2,
                                      float m2, float p3, float m3,
                                      const float* w) {
  const float c2 = 2.0f * c;
  float acc = __fmul_rn(w[0], __fsub_rn(__fadd_rn(p1, m1), c2));
  acc = __fmaf_rn(w[1], __fsub_rn(__fadd_rn(p2, m2), c2), acc);
  return __fmaf_rn(w[2], __fsub_rn(__fadd_rn(p3, m3), c2), acc);
}

// The 12-point bidiagonal mixed derivative: hi[o] and lo[o] point at this
// point's field o + 1 steps up and down the first axis, s2 is the stride
// of the second; taps (o,o,+), (-o,o,-), (-o,-o,+), (o,-o,-), whose
// weights are wm[4 o] times +1, -1, +1, -1.
__device__ __forceinline__ float summix(const float* const* hi,
                                        const float* const* lo, int s2,
                                        const float* wm) {
  float acc = 0.0f;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const int b = (o + 1) * s2;
    const float t = __fadd_rn(__fsub_rn(hi[o][b], lo[o][b]),
                              __fsub_rn(lo[o][-b], hi[o][-b]));
    acc = (o == 0) ? __fmul_rn(wm[0], t) : __fmaf_rn(wm[4 * o], t, acc);
  }
  return acc;
}

// Derivatives of one field along axis j: p points at the field at this
// point in its ring slot, x holds its NX taps along x (x[NG]: the point),
// y and z sit at the fixed strides PZ and 1.
__device__ __forceinline__ float dj1(const float* p, const float* x, int j,
                                     const float* w) {
  if (j == 0) return sum1(x[4], x[2], x[5], x[1], x[6], x[0], w);
  const int st = j == 1 ? PZ : 1;
  return sum1(p[st], p[-st], p[2 * st], p[-2 * st], p[3 * st], p[-3 * st],
              w);
}

__device__ __forceinline__ float dj2(const float* p, const float* x, int j,
                                     const float* w) {
  if (j == 0) return sum2(x[NG], x[4], x[2], x[5], x[1], x[6], x[0], w);
  const int st = j == 1 ? PZ : 1;
  return sum2(x[NG], p[st], p[-st], p[2 * st], p[-2 * st], p[3 * st],
              p[-3 * st], w);
}

// mixed derivative along axes lo < hi; the x neighbours' planes sit at the
// offsets xo from this plane's slot (xo[NG] = 0)
__device__ __forceinline__ float djmix(const float* p, int lo, int hi,
                                       const int* xo, const float* wm) {
  if (lo == 0) {
    const float* const up[3] = {p + xo[4], p + xo[5], p + xo[6]};
    const float* const dn[3] = {p + xo[2], p + xo[1], p + xo[0]};
    return summix(up, dn, hi == 1 ? PZ : 1, wm);
  }
  const float* const up[3] = {p + PZ, p + 2 * PZ, p + 3 * PZ};
  const float* const dn[3] = {p - PZ, p - 2 * PZ, p - 3 * PZ};
  return summix(up, dn, 1, wm);
}

// del6 of one field at one point: the 6th difference has the even paired
// form of the second derivative (weights 15, -6, 1), so dj2 with w6 sums it,
// differences first; the three axes join in the JAX order, each weighted
// by field F's own weights (F = H6U, H6L: P.h6u, P.h6l, 1/dx_a^6 or
// dline_1/60 of the mesh flavour; H6A: P.inv6)
template <int F>
__device__ __forceinline__ float del6(const float* p, const float* x,
                                      const PcParams& P) {
  const float* h = F == H6U ? P.h6u : F == H6L ? P.h6l : P.inv6;
  float acc = __fmul_rn(dj2(p, x, 0, P.w6), h[0]);
  acc = __fadd_rn(acc, __fmul_rn(dj2(p, x, 1, P.w6), h[1]));
  return __fadd_rn(acc, __fmul_rn(dj2(p, x, 2, P.w6), h[2]));
}

// The 5th-order upwinding of the advection of one field at one point (JAX
// Pencils.ugrad(upwind=True), reference der6_upwind):
// sum_a |u_a| d6_a f/(60 dx_a), the 6th difference of each axis as del6
// forms it, the three axes joined in the JAX order
__device__ __forceinline__ float upwind(const float* p, const float* x,
                                        const float* u, const PcParams& P) {
  float acc = __fmul_rn(__fmul_rn(fabsf(u[0]), dj2(p, x, 0, P.w6)),
                        P.upw_inv[0]);
  acc = __fmaf_rn(__fmul_rn(fabsf(u[1]), dj2(p, x, 1, P.w6)), P.upw_inv[1],
                  acc);
  return __fmaf_rn(__fmul_rn(fabsf(u[2]), dj2(p, x, 2, P.w6)),
                   P.upw_inv[2], acc);
}

// ---- Viscosity's other flavours and diffrho (PcParams.visx) -------------
// Derivatives of one field along axis j with its x taps read from the ring
// (the planes at the offsets xo; xo[NG] = 0), as dj1 and dj2 form them
// from the registers: the terms below recompute what they read, so that
// the RHS before them keeps none of its values for them
__device__ __forceinline__ float djr1(const float* p, const int* xo, int j,
                                      const float* w) {
  if (j == 0)
    return sum1(p[xo[4]], p[xo[2]], p[xo[5]], p[xo[1]], p[xo[6]], p[xo[0]],
                w);
  const int st = j == 1 ? PZ : 1;
  return sum1(p[st], p[-st], p[2 * st], p[-2 * st], p[3 * st], p[-3 * st],
              w);
}

__device__ __forceinline__ float djr2(const float* p, const int* xo, int j,
                                      const float* w) {
  if (j == 0)
    return sum2(p[0], p[xo[4]], p[xo[2]], p[xo[5]], p[xo[1]], p[xo[6]],
                p[xo[0]], w);
  const int st = j == 1 ? PZ : 1;
  return sum2(p[0], p[st], p[-st], p[2 * st], p[-2 * st], p[3 * st],
              p[-3 * st], w);
}

// The largest diffusive CFL rate of the flavours at this point (visx
// taken): the constant nu_s and diffrho, nu_r/rho, zeta/rho and, where
// the build has them, nu_ss shock and mu_T = nu_t exp(nu_c lnT)
__device__ __forceinline__ float visx_rate(const PcParams& P,
                                           float (*xt)[NX]) {
  const float lnrho = xt[LNRHO][NG];
  const float r1 = expf(-lnrho);
  float md = fmaxf(P.nu_s, P.diffrho);
  if (P.nu_r > 0.0f) md = fmaxf(md, __fmul_rn(P.nu_r, r1));
  if (P.zeta > 0.0f) md = fmaxf(md, __fmul_rn(P.zeta, r1));
#if PC_SHOCK
  if (P.nu_ss > 0.0f) md = fmaxf(md, __fmul_rn(P.nu_ss, xt[SHOCK][NG]));
#endif
#if PC_ZG && PC_ENT
  if (P.nu_t > 0.0f) {
    const float lnTT = (P.lnTT0 + P.g_cp * xt[SS][NG])
                       + P.gm1 * (lnrho - P.lnrho0);
    md = fmaxf(md, __fmul_rn(P.nu_t, expf(P.nu_c * lnTT)));
  }
#endif
  return md;
}

// The flavours' terms at this point (visx taken), added to the RHS r of
// the instance: D (del2 lnrho + |grad lnrho|^2) to dlnrho; to du_a, in the
// JAX order, 'nu-simplified' nu_s del2 u_a, 'rho-nu-const' (nu_r/rho)
// (del2 u_a + d_a div u/3), the bulk (zeta/rho) d_a div u, H3's
// anisotropic advective part sum_j u_{a,j} dlnrho_j nu3_j, 'shock-simple'
// nu_ss (grad shock . grad u_a + shock del2 u_a) and 'nu-cspeed' mu_T
// (del2 u_a + d_a div u/3 + 2 (S.grad lnrho)_a + 2 nu_c (S.grad lnT)_a),
// as one force; with ss their heat 2 nu_s S^2 + 2 (nu_r/rho) S^2 +
// (zeta/rho)(div u)^2 + 2 mu_T S^2 over T to ds.  Each coefficient of 0
// is skipped, and so is each derivative that no term on reads (the rate
// of strain S only with ss, grad u_a otherwise only for the aniso and
// shock terms).  Everything is read from the ring anew (the empty asm
// with a memory clobber keeps the compiler from reusing the RHS's loads),
// so that the RHS keeps none of its values live for these terms.
template <bool H3>
__device__ __forceinline__ void visx_rhs(const float* s, const int* xo,
                                         const PcParams& P, float* r) {
  asm volatile("" ::: "memory");
  const float lnrho = s[LNRHO * FPL];
  const float r1 = expf(-lnrho);
  const bool aniso = H3 && (P.nua[0] != 0.0f || P.nua[1] != 0.0f
                            || P.nua[2] != 0.0f);
  float gl[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    gl[a] = __fmul_rn(djr1(s + LNRHO * FPL, xo, a, P.w1), P.inv[a]);
  if (P.diffrho > 0.0f) {
    float d2l = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float l2 = __fmul_rn(djr2(s + LNRHO * FPL, xo, a, P.w2),
                                 P.invsq[a]);
      d2l = (a == 0) ? l2 : d2l + l2;
    }
    const float g2 = (gl[0] * gl[0] + gl[1] * gl[1]) + gl[2] * gl[2];
    r[LNRHO] = __fadd_rn(r[LNRHO], __fmul_rn(P.diffrho, __fadd_rn(d2l, g2)));
  }
  const bool force = P.nu_s > 0.0f || P.nu_r > 0.0f || P.zeta > 0.0f
                     || aniso || (PC_SHOCK && P.nu_ss > 0.0f)
                     || (PC_ZG && PC_ENT && P.nu_t > 0.0f);
  if (!force) return;
#if PC_SHOCK
  const float shock = s[SHOCK * FPL];
  float gsh[3] = {0.0f, 0.0f, 0.0f};
  if (P.nu_ss > 0.0f) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      gsh[a] = __fmul_rn(djr1(s + SHOCK * FPL, xo, a, P.w1), P.inv[a]);
  }
#endif
#if PC_ENT
  // with ss the whole velocity gradient: the heat reads S
  float uij[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      uij[i][j] = __fmul_rn(djr1(s + (UX + i) * FPL, xo, j, P.w1),
                            P.inv[j]);
  const float divu = (uij[0][0] + uij[1][1]) + uij[2][2];
  const float div3 = divu / 3.0f;
  const float lnTT = (P.lnTT0 + P.g_cp * s[SS * FPL])
                     + P.gm1 * (lnrho - P.lnrho0);
#if PC_ZG
  float gs[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    gs[a] = __fmul_rn(djr1(s + SS * FPL, xo, a, P.w1), P.inv[a]);
  const float mut = P.nu_t > 0.0f
      ? __fmul_rn(P.nu_t, expf(P.nu_c * lnTT)) : 0.0f;
#endif
  float sij2 = 0.0f;
#endif
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* ua = s + (UX + a) * FPL;
#if PC_ENT
    const float* ug = uij[a];
    // the rate-of-strain row S_ab: its square, (S.grad lnrho)_a and (S.grad
    // lnT)_a
    float sgl = 0.0f;
#if PC_ZG
    float sgt = 0.0f;
#endif
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float sab = 0.5f * (uij[a][b] + uij[b][a]);
      if (a == b) sab = sab - div3;
      sgl = (b == 0) ? sab * gl[0] : sgl + sab * gl[b];
#if PC_ZG
      const float gt = P.gm1 * gl[b] + P.g_cp * gs[b];
      sgt = (b == 0) ? sab * gt : sgt + sab * gt;
#endif
      sij2 = (a == 0 && b == 0) ? sab * sab : sij2 + sab * sab;
    }
#else
    // without ss only the aniso and shock terms read grad u_a
    float ug[3] = {0.0f, 0.0f, 0.0f};
    if (aniso || (PC_SHOCK && P.nu_ss > 0.0f)) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        ug[j] = __fmul_rn(djr1(ua, xo, j, P.w1), P.inv[j]);
    }
#endif
    const float dd[3] = {
        __fmul_rn(djr2(ua, xo, 0, P.w2), P.invsq[0]),
        __fmul_rn(djr2(ua, xo, 1, P.w2), P.invsq[1]),
        __fmul_rn(djr2(ua, xo, 2, P.w2), P.invsq[2])};
    const float del2 = (dd[0] + dd[1]) + dd[2];
    float gdiv = 0.0f;
    if (P.nu_r > 0.0f || P.zeta > 0.0f || (PC_ZG && PC_ENT && P.nu_t > 0.0f)) {
      gdiv = dd[a];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j == a) continue;
        const int lo = a < j ? a : j, hi = a < j ? j : a;
        const float m = djmix(s + (UX + j) * FPL, lo, hi, xo, P.wm);
        gdiv = gdiv + __fmul_rn(__fmul_rn(m, P.inv[lo]), P.inv[hi]);
      }
    }
    float fv = 0.0f;
    if (P.nu_s > 0.0f) fv = __fmul_rn(P.nu_s, del2);
    if (P.nu_r > 0.0f)
      fv = __fadd_rn(fv, __fmul_rn(__fmul_rn(P.nu_r, r1), __fadd_rn(
          del2, __fmul_rn(1.0f / 3.0f, gdiv))));
    if (P.zeta > 0.0f)
      fv = __fadd_rn(fv, __fmul_rn(__fmul_rn(P.zeta, r1), gdiv));
    if (aniso) {
      float adv = __fmul_rn(__fmul_rn(ug[0], gl[0]), P.nua[0]);
      adv = __fadd_rn(adv, __fmul_rn(__fmul_rn(ug[1], gl[1]), P.nua[1]));
      adv = __fadd_rn(adv, __fmul_rn(__fmul_rn(ug[2], gl[2]), P.nua[2]));
      fv = __fadd_rn(fv, adv);
    }
#if PC_SHOCK
    if (P.nu_ss > 0.0f)
      fv = __fadd_rn(fv, __fmul_rn(P.nu_ss, __fadd_rn(
          (gsh[0] * ug[0] + gsh[1] * ug[1]) + gsh[2] * ug[2],
          __fmul_rn(shock, del2))));
#endif
#if PC_ZG && PC_ENT
    if (P.nu_t > 0.0f)
      fv = __fadd_rn(fv, __fmul_rn(mut, ((del2 + (1.0f / 3.0f) * gdiv)
                                         + 2.0f * sgl)
                                        + (2.0f * P.nu_c) * sgt));
#endif
    r[UX + a] = __fadd_rn(r[UX + a], fv);
  }
#if PC_ENT
  float heat = 0.0f;
  if (P.nu_s > 0.0f) heat = __fmul_rn(2.0f * P.nu_s, sij2);
  if (P.nu_r > 0.0f)
    heat = __fadd_rn(heat, __fmul_rn(2.0f * __fmul_rn(P.nu_r, r1), sij2));
  if (P.zeta > 0.0f)
    heat = __fadd_rn(heat, __fmul_rn(__fmul_rn(P.zeta, r1),
                                     __fmul_rn(divu, divu)));
#if PC_ZG
  if (P.nu_t > 0.0f) heat = __fadd_rn(heat, __fmul_rn(2.0f * mut, sij2));
#endif
  r[SS] = __fadd_rn(r[SS], __fmul_rn(heat, expf(-lnTT)));
#endif
}

// The CFL 1/dt at this point with the flavours' rates (visx taken): the
// instance's advective dt1a and diffusive maximum mdif (before its
// scaling), the flavours' largest rate beside it, then the build's
// constant del6 rate, as the plain version joins them
__device__ __forceinline__ float visx_dt1(const PcParams& P,
                                          float (*xt)[NX], float dt1a,
                                          float mdif) {
  float dif = (fmaxf(mdif, visx_rate(P, xt)) * P.dxyz2) / P.cdtv;
  if (P.dif3 > 0.0f) dif = __fadd_rn(dif, P.dif3);
  return sqrtf(dt1a * dt1a + dif * dif);
}

// The flagship RHS at one point.  `s` points at field 0 of this point in
// the ring slot of its plane; field c is at s + c*FPL, its x taps in
// xt[c], the x neighbours' planes at the offsets xo.  Term order follows
// the JAX modules (density, hydro with its Coriolis force, viscosity,
// magnetic, entropy) so that the plain version and this kernel sum in the
// same order; the heating terms are formed where viscosity and magnetic
// form them and added to ds last.  grad lnT and del2 lnT are built from the
// derivatives of lnrho and ss, never from a summed field, as Pencils.glnTT
// and del2lnTT build them.  ROT adds -2 Omega x u (a template flag, so
// that the instances without rotation carry no trace of it).  The shock
// and shear builds follow the JAX modules in the order density, hydro,
// shear, viscosity (nu-const, nu-shock, hyper3 as one force; without the
// shock slot the periodic builds' form), magnetic, with the joins of the
// zroll kernels that these builds replace (PC_JOINS); xn is the x node
// of this point's plane (the Shear terms; 0 under SAFI).  H3 adds the del6
// hyper-diffusion terms of u, A and lnrho, all three, a coefficient of 0
// adding 0 (a flag as ROT is, picked on the host: without it the shocked
// box's K1s and K5w measured 4-5 % faster; testing each coefficient inside
// made K4 and K5 4-6 % slower).  The four periodic and the two z-ghosted
// builds take H3 too, in the same places: D3 del6 lnrho after the density
// terms, nu3 del6 u joined to the nu-const force as one force before it
// is added to du, eta3 del6 A after eta del2 A, and the constant rate
// dif3 added to the diffusive one.  With ss the shock and shear builds
// add nu_sh shock (div u)^2 to the viscous heat and, with the shear, its
// -S x dss/dy before the entropy terms (the Shear module comes first);
// their CFL takes chi gamma and K-const's rate among the diffusivities;
// with aa they join the Ohmic heat after the viscous one, as Entropy adds
// what Viscosity and Magnetic publish.
// Every build adds gravity, grav (g_z at this point's z, -0 without
// gravity), after the pressure force and the Coriolis force, as the JAX
// modules run (hydro, gravity, shear, viscosity); the MHD builds add
// B_ext to curl A as soon as B is formed.  The continuous forcing joins du
// after this function returns (the march), after the Lorentz force, where
// the Forcing module comes in the JAX module order.  The z-ghosted build
// with ss adds the layer terms after the heating, in the order of the JAX
// modules (entropy last); lay_c is this point's cooling profile, lay_h
// heat_norm times its heating profile, and its conduction and heating
// terms, and with aa eta del2 A and the Ohmic heat, are compiled in (no
// test of a coefficient: a layer that is off
// has a profile of zeros, a coefficient that is off adds 0); CHI adds
// 'chi-const' conduction after K-const, a flag as ROT is (a term behind a
// runtime test measured 3-6 %).  UPW (every build, not beside H3: both
// damp the same grid-scale noise) upwinds the advection of lnrho, of each
// u component (after the pressure force, before the Coriolis force) and of
// ss, each field behind a uniform test of its flag (P.upw), so that one
// instance serves any mix of lupw_lnrho, lupw_uu and lupw_ss.  SHK (the
// shock builds) adds the shock diffusivities where their coefficients are
// not 0 (a uniform test each, as nu-shock's): D_sh [shock (del2 lnrho +
// |grad lnrho|^2) + grad shock . grad lnrho] after the density terms and
// before D3 del6 lnrho, -eta_sh shock J after eta3 del6 A, chi_sh [shock
// (del2 lnT + (grad lnrho + grad lnT) . grad lnT) + grad shock . grad lnT]
// after chi-const, and their rates D_sh shock, eta_sh shock and gamma
// chi_sh shock among the diffusivities of the CFL.  The z-ghosted builds
// with ss take Entropy's other conduction and cooling terms with no flag
// of their own: after K-const, behind one uniform test of whether any of
// them is on (zgx), the layered conductivity K(z) of 'K-profile' (kz and
// dkz: K and dK/dz at this thread's z from their (2, nz) vector, loaded
// before the march, 0 where it is not given), the uniform heating and
// cooling (P.heat_uniform, cool_uniform) and Newtonian cooling
// (P.tau_cool), each behind a test of its own (JAX adds the uniform terms
// before the conduction and the cooling after it: the order moves the
// rounding only; three tests on every point measured slower); and
// Kramers opacity and 'chi-cspeed' in the CHI instances as chi-const's
// term with other parameters (P.kexp: A = cpchi exp(kq_rho lnrho + kq_T
// lnT), clipped, and the weights kp_rho, kp_T of the gradient product).
// Their per-point rates (K(z) gamma/(rho cp), A gamma/cp, as products
// with g_cp = gamma/cp) join K-const's in the CFL.
template <bool WANT_DT1, bool ROT, bool H3, bool CHI, bool UPW, bool SHK>
__device__ __forceinline__ void flagship_rhs(const float* s,
                                             float (*xt)[NX], const int* xo,
                                             const PcParams& P, float xn,
                                             float lay_c, float lay_h,
                                             float grav, bool zgx,
                                             float kz, float dkz, float* r,
                                             float& dt1, float& dt1a_out,
                                             float& mdif) {
  const float u[3] = {xt[0][NG], xt[1][NG], xt[2][NG]};
  const float lnrho = xt[LNRHO][NG];

  float uij[3][3];   // du_i/dx_j
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      uij[i][j] = __fmul_rn(dj1(s + (UX + i) * FPL, xt[UX + i], j, P.w1),
                            P.inv[j]);
  float gl[3];       // grad lnrho
#pragma unroll
  for (int a = 0; a < 3; ++a)
    gl[a] = __fmul_rn(dj1(s + LNRHO * FPL, xt[LNRHO], a, P.w1), P.inv[a]);
  const float divu = (uij[0][0] + uij[1][1]) + uij[2][2];
#if PC_ENT
  float gs[3];       // grad ss
#pragma unroll
  for (int a = 0; a < 3; ++a)
    gs[a] = __fmul_rn(dj1(s + SS * FPL, xt[SS], a, P.w1), P.inv[a]);
#endif
#if PC_SHOCK
  // the shock profile (its x taps in registers too: read from the ring
  // they measured 0-4 % slower), and its gradient where a term reads it:
  // nu-shock and, with SHK, the shock diffusion of lnrho and the shock
  // conduction
  const float shock = xt[SHOCK][NG];
  const bool gshock = SHK ? P.nu_shock > 0.0f || P.diffrho_shock > 0.0f
                                || P.chi_shock > 0.0f
                          : P.nu_shock > 0.0f;
  float gsh[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    gsh[a] = gshock
        ? __fmul_rn(dj1(s + SHOCK * FPL, xt[SHOCK], a, P.w1), P.inv[a])
        : 0.0f;
#endif

#if PC_JOINS
  // density: -u.grad(lnrho) [less its upwinding] - div u [+ shock
  // diffusion] [+ D3 del6 lnrho], then the shear term
  float rl;
  if constexpr (UPW) {
    float ug = (u[0] * gl[0] + u[1] * gl[1]) + u[2] * gl[2];
    if (P.upw[0]) ug = __fsub_rn(ug, upwind(s + LNRHO * FPL, xt[LNRHO], u, P));
    rl = -ug - divu;
  } else {
    rl = -((u[0] * gl[0] + u[1] * gl[1]) + u[2] * gl[2]) - divu;
  }
#if PC_SHOCK
  if (SHK && P.diffrho_shock > 0.0f) {
    float d2l = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float l2 = __fmul_rn(dj2(s + LNRHO * FPL, xt[LNRHO], a, P.w2),
                                 P.invsq[a]);
      d2l = (a == 0) ? l2 : d2l + l2;
    }
    const float g2 = (gl[0] * gl[0] + gl[1] * gl[1]) + gl[2] * gl[2];
    const float gsgl = (gsh[0] * gl[0] + gsh[1] * gl[1]) + gsh[2] * gl[2];
    rl = __fadd_rn(rl, P.diffrho_shock * (shock * (d2l + g2) + gsgl));
  }
#endif
  if (H3) rl = rl + P.diff3 * del6<H6L>(s + LNRHO * FPL, xt[LNRHO], P);
#else
  // density: -u.grad(lnrho) [less its upwinding] - div u [+ D3 del6 lnrho]
  if constexpr (UPW) {
    float ug = (u[0] * gl[0] + u[1] * gl[1]) + u[2] * gl[2];
    if (P.upw[0]) ug = __fsub_rn(ug, upwind(s + LNRHO * FPL, xt[LNRHO], u, P));
    r[LNRHO] = -ug - divu;
  } else {
    r[LNRHO] = -((u[0] * gl[0] + u[1] * gl[1]) + u[2] * gl[2]) - divu;
  }
  if constexpr (H3)
    r[LNRHO] = __fadd_rn(
        r[LNRHO],
        __fmul_rn(P.diff3, del6<H6L>(s + LNRHO * FPL, xt[LNRHO], P)));
#endif

  // hydro: -(u.grad)u - cs2 (grad(lnrho) + grad(ss)/cp) - 2 Omega x u
#if PC_ENT
  const float dlnrho = lnrho - P.lnrho0;
  const float ssg = P.g_cp * xt[SS][NG];
  const float cs2 = P.cs20 * expf(ssg + P.gm1 * dlnrho);
  const float lnTT = (P.lnTT0 + ssg) + P.gm1 * dlnrho;
  const float TT1 = expf(-lnTT);
  const float rho1 = expf(-lnrho);
#else
  const float cs2 = P.isothermal
      ? P.cs20 : P.cs20 * expf(P.gm1 * (lnrho - P.lnrho0));
#endif
  float duu[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ugu = (u[0] * uij[a][0] + u[1] * uij[a][1]) + u[2] * uij[a][2];
#if PC_ENT
    duu[a] = -ugu + (-cs2) * (gl[a] + gs[a] / P.cp);
#else
    duu[a] = -ugu + (-cs2) * gl[a];
#endif
  }
  if constexpr (UPW) {
    // upwinding of each component: + sum_a |u_a| d6_a u_c/(60 dx_a)
    if (P.upw[1]) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        duu[c] = __fadd_rn(duu[c], upwind(s + (UX + c) * FPL, xt[UX + c], u,
                                          P));
    }
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
  duu[2] = duu[2] + grav;      // gravity: g_z at this point's z
#if PC_SHEAR
  // shear: -S x d/dy of every evolved field, duy -= S ux (dAx -= S Ay
  // joins where grad A is formed)
  const float muy0 = -__fmul_rn(P.S, xn);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    duu[a] = __fadd_rn(duu[a], __fmul_rn(muy0, uij[a][1]));
  rl = __fadd_rn(rl, __fmul_rn(muy0, gl[1]));
  duu[1] = __fadd_rn(duu[1], __fmul_rn(-P.S, u[0]));
#endif
#if PC_JOINS
  r[LNRHO] = rl;
#endif

  // viscosity 'nu-const': nu*(del2 u + grad(div u)/3 + 2 S.grad(lnrho));
  // with PC_ENT also S^2 for the heating 2 nu S^2
  const float div3 = divu / 3.0f;
#if PC_ENT
  float sij2 = 0.0f;
#endif
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* ua = s + (UX + a) * FPL;
    float sgl = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float sab = 0.5f * (uij[a][b] + uij[b][a]);
      if (a == b) sab = sab - div3;
      sgl = (b == 0) ? sab * gl[0] : sgl + sab * gl[b];
#if PC_ENT
      sij2 = (a == 0 && b == 0) ? sab * sab : sij2 + sab * sab;
#endif
    }
    const float dd[3] = {
        __fmul_rn(dj2(ua, xt[UX + a], 0, P.w2), P.invsq[0]),
        __fmul_rn(dj2(ua, xt[UX + a], 1, P.w2), P.invsq[1]),
        __fmul_rn(dj2(ua, xt[UX + a], 2, P.w2), P.invsq[2])};
    const float del2 = (dd[0] + dd[1]) + dd[2];
    float gdiv = dd[a];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j == a) continue;
      const int lo = a < j ? a : j, hi = a < j ? j : a;
      const float m = djmix(s + (UX + j) * FPL, lo, hi, xo, P.wm);
      gdiv = gdiv + __fmul_rn(__fmul_rn(m, P.inv[lo]), P.inv[hi]);
    }
#if PC_SHOCK
    // nu-const, then nu-shock [shock (grad div u + div u grad lnrho) + div
    // u grad shock], then nu3 del6 u, joined to du as one force
    float fv = P.nu * ((del2 + (1.0f / 3.0f) * gdiv) + 2.0f * sgl);
    if (P.nu_shock > 0.0f)
      fv = __fadd_rn(fv, P.nu_shock * (shock * (gdiv + divu * gl[a])
                                       + divu * gsh[a]));
    if (H3) fv = __fadd_rn(fv, P.nu3 * del6<H6U>(ua, xt[UX + a], P));
    duu[a] = __fadd_rn(duu[a], fv);
#else
    if constexpr (H3) {
      // nu-const, then nu3 del6 u, joined to du as one force
      float fv = P.nu * ((del2 + (1.0f / 3.0f) * gdiv) + 2.0f * sgl);
      fv = __fadd_rn(fv, __fmul_rn(P.nu3, del6<H6U>(ua, xt[UX + a], P)));
      duu[a] = __fadd_rn(duu[a], fv);
    } else {
      duu[a] = duu[a] + P.nu * ((del2 + (1.0f / 3.0f) * gdiv) + 2.0f * sgl);
    }
#endif
  }

#if PC_MAG
  // magnetic: B = curl A, dA/dt = u x B + eta del2 A, du += (J x B)/rho
  float aij[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      aij[i][j] = __fmul_rn(dj1(s + (AX + i) * FPL, xt[AX + i], j, P.w1),
                            P.inv[j]);
  // B = curl A + B_ext: the curl first, then one add (JAX Pencils.bb)
  const float bb[3] = {__fadd_rn(aij[2][1] - aij[1][2], P.bext[0]),
                       __fadd_rn(aij[0][2] - aij[2][0], P.bext[1]),
                       __fadd_rn(aij[1][0] - aij[0][1], P.bext[2])};
  float jj[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* aa = s + (AX + a) * FPL;
    const float dd[3] = {
        __fmul_rn(dj2(aa, xt[AX + a], 0, P.w2), P.invsq[0]),
        __fmul_rn(dj2(aa, xt[AX + a], 1, P.w2), P.invsq[1]),
        __fmul_rn(dj2(aa, xt[AX + a], 2, P.w2), P.invsq[2])};
    const float del2 = (dd[0] + dd[1]) + dd[2];
    float gdiv = dd[a];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j == a) continue;
      const int lo = a < j ? a : j, hi = a < j ? j : a;
      const float m = djmix(s + (AX + j) * FPL, lo, hi, xo, P.wm);
      gdiv = gdiv + __fmul_rn(__fmul_rn(m, P.inv[lo]), P.inv[hi]);
    }
    jj[a] = gdiv - del2;
    const int b1 = (a + 1) % 3, b2 = (a + 2) % 3;
    const float uxb = u[b1] * bb[b2] - u[b2] * bb[b1];
#if PC_JOINS
    float out = uxb;
    if (PC_ZG || P.eta > 0.0f) out = out + P.eta * del2;
    if (H3) out = out + P.eta3 * del6<H6A>(aa, xt[AX + a], P);
#if PC_SHOCK
    // the shock resistivity -eta_sh shock J (mu0 = 1)
    if (SHK && P.eta_shock > 0.0f)
      out = __fsub_rn(out, (P.eta_shock * shock) * jj[a]);
#endif
#if PC_SHEAR
    // the Shear module's terms come first: -S x dA/dy, and -S Ay on Ax
    float ra = __fmul_rn(muy0, aij[a][1]);
    if (a == 0) ra = __fadd_rn(ra, __fmul_rn(-P.S, xt[AX + 1][NG]));
    out = __fadd_rn(ra, out);
#endif
    r[AX + a] = out;
#else
    r[AX + a] = PC_ZG || P.eta > 0.0f ? uxb + P.eta * del2 : uxb;
    if constexpr (H3)
      r[AX + a] = __fadd_rn(r[AX + a],
                            __fmul_rn(P.eta3, del6<H6A>(aa, xt[AX + a], P)));
#endif
  }
#if !PC_ENT
  const float rho1 = expf(-lnrho);
#endif
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int b1 = (a + 1) % 3, b2 = (a + 2) % 3;
    const float jxb = jj[b1] * bb[b2] - jj[b2] * bb[b1];
#if PC_JOINS
    r[UX + a] = __fadd_rn(duu[a], jxb * rho1);
#else
    r[UX + a] = duu[a] + jxb * rho1;
#endif
  }
#else
#pragma unroll
  for (int a = 0; a < 3; ++a) r[UX + a] = duu[a];
#endif

#if PC_ENT
  // entropy: -u.grad(ss) [less its upwinding] + K-const, chi-const [and
  // shock] conduction + viscous and Ohmic heating
  float ds;
  if constexpr (UPW) {
    float ug = (u[0] * gs[0] + u[1] * gs[1]) + u[2] * gs[2];
    if (P.upw[2]) ug = __fsub_rn(ug, upwind(s + SS * FPL, xt[SS], u, P));
    ds = -ug;
  } else {
    ds = -((u[0] * gs[0] + u[1] * gs[1]) + u[2] * gs[2]);
  }
  // the conductive CFL rate at this point: K-const's K gamma/(rho cp), and
  // in the z-ghosted builds the largest of it, K(z) gamma/(rho cp) and the
  // CHI instances' A gamma/cp
  float chik = 0.0f;
  if (PC_ZG || P.hcond0 > 0.0f || P.cpchi > 0.0f
      || (PC_SHOCK && SHK && P.chi_shock > 0.0f)) {
    float gt[3], d2l = 0.0f, d2s = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      gt[a] = P.gm1 * gl[a] + P.g_cp * gs[a];
      const float l2 = __fmul_rn(dj2(s + LNRHO * FPL, xt[LNRHO], a, P.w2),
                                 P.invsq[a]);
      const float s2 = __fmul_rn(dj2(s + SS * FPL, xt[SS], a, P.w2),
                                 P.invsq[a]);
      d2l = (a == 0) ? l2 : d2l + l2;
      d2s = (a == 0) ? s2 : d2s + s2;
    }
    const float del2lnTT = P.gm1 * d2l + P.g_cp * d2s;
    if (PC_ZG || P.hcond0 > 0.0f) {
      const float glnTT2 = (gt[0] * gt[0] + gt[1] * gt[1]) + gt[2] * gt[2];
      const float krho1 = P.hcond0 * rho1;
      ds = ds + krho1 * (del2lnTT + glnTT2);
      chik = (krho1 / P.cp) * P.gamma;
#if PC_ZG
      if (zgx) {
        // Entropy's other terms (any on): 'K-profile' (K(z)/rho)(del2 lnT
        // + |grad lnT|^2) + (K'(z)/rho) dlnT/dz, its rate K g_cp/rho; the
        // uniform heating and cooling (heat_uniform - cool_uniform rho cp
        // T)/(rho T); Newtonian cooling -cp (T - T_ref)/(gamma tau T)
        if (kz != 0.0f || dkz != 0.0f) {
          ds = ds + rho1 * (kz * (del2lnTT + glnTT2) + dkz * gt[2]);
          chik = fmaxf(chik, (kz * rho1) * P.g_cp);
        }
        if (P.heat_uniform != 0.0f || P.cool_uniform != 0.0f) {
          const float hu = P.heat_uniform
                           - ((P.cool_uniform * expf(lnrho)) * P.cp)
                             * expf(lnTT);
          ds = ds + (hu * rho1) * TT1;
        }
        if (P.tau_cool != 0.0f) {
          const float TT = expf(lnTT);
          ds = ds - (P.cp_g * (TT - P.ttref)) / (P.tau_cool * TT);
        }
      }
#endif
    }
    if (PC_ZG ? CHI : P.cpchi > 0.0f) {
#if PC_ZG
      // chi-const, 'kramers' or 'chi-cspeed': A (del2 lnT + sum_a (kp_rho
      // dlnrho_a + kp_T dlnT_a) dlnT_a), A = cpchi, or with kexp cpchi
      // exp(kq_rho lnrho + kq_T lnT) [clipped] and its rate A g_cp.
      // chi-const's weights 1 and 1 give gt + gl exactly, so its term
      // rounds bit for bit as the sum gt (gt + gl) did alone (a branch
      // between two forms did not: the compiler fused that sum otherwise)
      float a = P.cpchi;
      if (P.kexp) {
        a = P.cpchi * expf(P.kq_rho * lnrho + P.kq_T * lnTT);
        if (P.kmax > 0.0f) a = fminf(fmaxf(a, P.kmin), P.kmax);
        chik = fmaxf(chik, a * P.g_cp);
      }
      const float gdot = (gt[0] * (P.kp_rho * gl[0] + P.kp_T * gt[0])
                          + gt[1] * (P.kp_rho * gl[1] + P.kp_T * gt[1]))
                         + gt[2] * (P.kp_rho * gl[2] + P.kp_T * gt[2]);
#else
      const float a = P.cpchi;
      const float gdot = (gt[0] * (gt[0] + gl[0]) + gt[1] * (gt[1] + gl[1]))
                         + gt[2] * (gt[2] + gl[2]);
#endif
      ds = ds + a * (del2lnTT + gdot);
    }
#if PC_SHOCK
    if (SHK && P.chi_shock > 0.0f) {
      const float g2 = ((gl[0] + gt[0]) * gt[0] + (gl[1] + gt[1]) * gt[1])
                       + (gl[2] + gt[2]) * gt[2];
      const float gsgt = (gsh[0] * gt[0] + gsh[1] * gt[1]) + gsh[2] * gt[2];
      ds = ds + P.chi_shock * (shock * (del2lnTT + g2) + gsgt);
    }
#endif
  }
#if PC_SHOCK
  // the viscous heat 2 nu S^2 + nu_sh shock (div u)^2, in Viscosity's order
  if (P.two_nu > 0.0f || P.nu_shock > 0.0f) {
    float heat = P.two_nu * sij2;
    if (P.nu_shock > 0.0f)
      heat = __fadd_rn(heat, __fmul_rn(__fmul_rn(__fmul_rn(P.nu_shock, shock),
                                                 divu), divu));
    ds = ds + heat * TT1;
  }
#else
  if (PC_ZG || P.two_nu > 0.0f) ds = ds + (P.two_nu * sij2) * TT1;
#endif
#if PC_MAG
  if (PC_ZG || P.eta_heat > 0.0f) {
    const float j2 = (jj[0] * jj[0] + jj[1] * jj[1]) + jj[2] * jj[2];
    ds = ds + ((P.eta_heat * j2) * rho1) * TT1;
  }
#endif
#if PC_ZG
  // the cooling layer, then the heating layer
  ds = ds - ((((rho1 * TT1) * P.cool) * lay_c) * (cs2 - P.cs2c)) / P.cs2c;
  ds = ds + (lay_h * rho1) * TT1;
#endif
#if PC_SHEAR
  // the Shear module's -S x dss/dy comes first
  r[SS] = __fadd_rn(__fmul_rn(muy0, gs[1]), ds);
#else
  r[SS] = ds;
#endif
#endif

  if (WANT_DT1) {
    // CFL (JAX timestep.py:49-100): the wave-speed root joins the
    // advection linearly; advective and diffusive classes combine as RSS
    float adv = (fabsf(u[0]) * P.inv[0] + fabsf(u[1]) * P.inv[1])
                + fabsf(u[2]) * P.inv[2];
#if PC_SHEAR
    adv = __fadd_rn(adv, __fmul_rn(fabsf(muy0), P.inv[1]));   // S x along y
#endif
#if PC_MAG
    const float b0 = bb[0] * P.inv[0], b1 = bb[1] * P.inv[1],
                b2 = bb[2] * P.inv[2];
    const float va2 = ((b0 * b0 + b1 * b1) + b2 * b2) * rho1;
    adv = adv + sqrtf(cs2 * P.dxyz2 + va2);
#else
    adv = adv + sqrtf(cs2 * P.dxyz2);
#endif
    // H3: the mesh flavours' constant root after the wave-speed root
    if constexpr (H3) adv = __fadd_rn(adv, P.hmesh);
    const float dt1a = adv / P.cdt;
    dt1a_out = dt1a;
#if PC_JOINS && !PC_ZG
    // the diffusivity max(nu, nu_sh*shock, eta) at this point (the terms of
    // the build's layout; with ss also chi gamma of chi-const, in maxdif,
    // and K-const's K gamma/(rho cp); the shock diffusivities D_sh shock,
    // eta_sh shock and gamma chi_sh shock), plus the constant del6 rate
    const bool has_dif = P.nu > 0.0f || (PC_SHOCK && P.nu_shock > 0.0f)
                         || (PC_MAG && P.eta > 0.0f)
                         || (PC_ENT && (P.maxdif > 0.0f || P.hcond0 > 0.0f))
                         || (PC_SHOCK && SHK);
    float md = 0.0f;
    if (P.nu > 0.0f) md = P.nu;
#if PC_SHOCK
    if (P.nu_shock > 0.0f) md = fmaxf(md, P.nu_shock * shock);
    if constexpr (SHK) {
      if (P.diffrho_shock > 0.0f) md = fmaxf(md, P.diffrho_shock * shock);
      if (PC_MAG && P.eta_shock > 0.0f) md = fmaxf(md, P.eta_shock * shock);
      if (PC_ENT && P.chi_shock > 0.0f)
        md = fmaxf(md, P.gchi_shock * shock);
    }
#endif
    if (PC_MAG && P.eta > 0.0f) md = fmaxf(md, P.eta);
#if PC_ENT
    md = fmaxf(fmaxf(md, P.maxdif), chik);
#endif
    mdif = md;
    float dif = has_dif ? (md * P.dxyz2) / P.cdtv : 0.0f;
    if (P.dif3 > 0.0f) dif = has_dif ? dif + P.dif3 : P.dif3;
    dt1 = (has_dif || P.dif3 > 0.0f) ? sqrtf(dt1a * dt1a + dif * dif) : dt1a;
#elif PC_ZG && PC_ENT
    // max(nu, [eta,] K gamma/(rho cp)) at this point (maxdif = max(nu,
    // eta)): with nothing diffusive dif = 0 and the root gives dt1a exactly
    // H3: plus the constant del6 rate.  With the shock slot also nu_sh
    // shock and, SHK, D_sh shock, eta_sh shock and gamma chi_sh shock
    float md = fmaxf(P.maxdif, chik);
#if PC_SHOCK
    if (P.nu_shock > 0.0f) md = fmaxf(md, P.nu_shock * shock);
    if constexpr (SHK) {
      if (P.diffrho_shock > 0.0f) md = fmaxf(md, P.diffrho_shock * shock);
      if (PC_MAG && P.eta_shock > 0.0f) md = fmaxf(md, P.eta_shock * shock);
      if (P.chi_shock > 0.0f) md = fmaxf(md, P.gchi_shock * shock);
    }
#endif
    mdif = md;
    float dif = (md * P.dxyz2) / P.cdtv;
    if constexpr (H3) dif = __fadd_rn(dif, P.dif3);
    dt1 = sqrtf(dt1a * dt1a + dif * dif);
#elif PC_ENT
    // the K-const rate varies from point to point; H3: plus the constant
    // del6 rate
    mdif = P.hcond0 > 0.0f ? fmaxf(P.maxdif, chik) : P.maxdif;
    float dif = P.hcond0 > 0.0f
        ? (fmaxf(P.maxdif, chik) * P.dxyz2) / P.cdtv : P.dif;
    if constexpr (H3) dif = __fadd_rn(dif, P.dif3);
    dt1 = dif == 0.0f ? dt1a : sqrtf(dt1a * dt1a + dif * dif);
#else
    // the isothermal builds, periodic or z-ghosted: the constant rates
    mdif = P.maxdif;
    if constexpr (H3) {
      // the constant rates, diffusive plus del6 (dif3 > 0 here)
      const float dif = __fadd_rn(P.dif, P.dif3);
      dt1 = sqrtf(dt1a * dt1a + dif * dif);
    } else {
      dt1 = P.dif == 0.0f ? dt1a : sqrtf(dt1a * dt1a + P.dif * P.dif);
    }
#endif
  }
}

// ---- the plane loader -----------------------------------------------------
// cp.async copies to a shared-memory address (bytes, shared state space),
// each under a predicate of its own, so that a row's copies are straight-
// line code whatever the lane copies
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src,
                                          bool on = true) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
               " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n"
               :: "r"(dst), "l"(src), "r"((int)on) : "memory");
}

__device__ __forceinline__ void cp_async16(unsigned dst, const float* src,
                                           bool on = true) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
               " @p cp.async.cg.shared.global [%0], [%1], 16;\n}\n"
               :: "r"(dst), "l"(src), "r"((int)on) : "memory");
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
// rstep, ...; copy k takes z index zk to row position dk.  With `vec` a
// half-warp takes a row: 8 lanes copy its 32-float body in 16-byte pieces
// (p16), 6 lanes its 3 + 3 halo floats (p4); otherwise a warp takes a row
// in 4-byte pieces, 6 of its lanes a second one (p4b).  Every wrap is done
// here, once.
struct RowCopy {
  int r0, rstep, z0, d0, z1, d1;
  bool p16, p4, p4b;
};

__device__ __forceinline__ RowCopy row_copy_plan(int bz, int nz, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  RowCopy rc;
  rc.z0 = rc.z1 = rc.d0 = rc.d1 = 0;
  rc.p16 = rc.p4 = rc.p4b = false;
  if (vec) {
    const int h = lane & 15;
    rc.r0 = 2 * warp + (lane >> 4);
    rc.rstep = NTHREADS / 16;
    if (h < TZ / 4) {                   // the body, no wrap (bz + TZ <= nz)
      rc.p16 = true;
      rc.z0 = bz + 4 * h;
      rc.d0 = ZOFF + 4 * h;
    } else if (h < TZ / 4 + 2 * NG) {   // the low, then the high halo
      const int k = h - TZ / 4;
      const int i = k < NG ? k - NG : TZ + k - NG;
      rc.p4 = true;
      rc.z0 = wrap_index(bz + i, nz);
      rc.d0 = ZOFF + i;
    }
  } else {
    rc.r0 = warp;
    rc.rstep = NTHREADS / 32;
    rc.p4 = true;
    rc.z0 = wrap_index(bz - NG + lane, nz);
    rc.d0 = ZOFF - NG + lane;
    if (32 + lane < TZ + 2 * NG) {
      rc.p4b = true;
      rc.z1 = wrap_index(bz - NG + 32 + lane, nz);
      rc.d1 = ZOFF - NG + 32 + lane;
    }
  }
  return rc;
}

// One plane's rows of this thread: from f0/f1 (the plane of fa, at the z
// of the thread's copies) to the slot at dst0/dst1, with DEFER also from
// g0/g1 (the plane of df1) to the staging slot.  rowg and rowd are the
// block's row table.  VEC picks the trip count: a half-warp or a warp per
// row.
template <bool VEC, bool DEFER>
__device__ __forceinline__ void copy_rows(
    const RowCopy& rc, const long long* rowg, const int* rowd, unsigned dst0,
    unsigned dst1, unsigned stg0, unsigned stg1, const float* f0,
    const float* f1, const float* g0, const float* g1) {
  constexpr int per = NTHREADS / (VEC ? 16 : 32);
  constexpr int trips = (NROWS + per - 1) / per;
#pragma unroll
  for (int k = 0; k < trips; ++k) {
    const int r = rc.r0 + k * per;
    const bool ok = r < NROWS;
    const int rr = ok ? r : rc.r0;
    const long long g = rowg[rr];
    const unsigned d = rowd[rr];
    if (VEC) cp_async16(dst0 + d, f0 + g, ok && rc.p16);
    cp_async4(dst0 + d, f0 + g, ok && rc.p4);
    if (!VEC) cp_async4(dst1 + d, f1 + g, ok && rc.p4b);
    if (DEFER) {
      if (VEC) cp_async16(stg0 + d, g0 + g, ok && rc.p16);
      cp_async4(stg0 + d, g0 + g, ok && rc.p4);
      if (!VEC) cp_async4(stg1 + d, g1 + g, ok && rc.p4b);
    }
  }
}

#if PC_ZG
// The z-ghosted build's source of one copy of the row plan, fixed for the
// thread: for the row position d of the column at bz, its z in fa (x
// planes of ny*nz floats, the row table at 0), or in the slab zlo or zhi
// (planes of ny*NG, the slabs' row table at NROWS) where that z lies
// below 0 or at nz and above; with PC_SHEAR both are ghosted in y (planes
// of (ny + 2 NG)*nz and (ny + 2 NG)*NG).  A z past nz + NG - 1 feeds only
// points outside the grid, and a lane without that copy issues none: both
// read a clamped cell.
struct ZgSrc {
  const float* base;   // the copy's z at x = 0, row offset 0
  size_t pstride;      // floats per x plane
  int tab;             // its row table's offset in rowg
};

__device__ __forceinline__ ZgSrc zg_source(int d, int bz, const PcParams& P,
                                           const float* fa, const ZgIn& zg) {
  const int z = bz + d - ZOFF;
  const size_t slab = (size_t)SRC_NY(P.ny) * NG;
  if (z < 0) return {zg.zlo + max(z + NG, 0), slab, NROWS};
  if (z >= P.nz) return {zg.zhi + min(z - P.nz, NG - 1), slab, NROWS};
  return {fa + z, (size_t)SRC_NY(P.ny) * P.nz, 0};
}

// copy_rows of the z-ghosted build: f0 and f1 are the plane of each copy's
// own source, t0 and t1 its row table.
template <bool VEC>
__device__ __forceinline__ void copy_rows_zg(
    const RowCopy& rc, const long long* rowg, const int* rowd, unsigned dst0,
    unsigned dst1, const float* f0, const float* f1, int t0, int t1) {
  constexpr int per = NTHREADS / (VEC ? 16 : 32);
  constexpr int trips = (NROWS + per - 1) / per;
#pragma unroll
  for (int k = 0; k < trips; ++k) {
    const int r = rc.r0 + k * per;
    const bool ok = r < NROWS;
    const int rr = ok ? r : rc.r0;
    const long long g = rowg[t0 + rr];
    const unsigned d = rowd[rr];
    if (VEC) cp_async16(dst0 + d, f0 + g, ok && rc.p16);
    cp_async4(dst0 + d, f0 + g, ok && rc.p4);
    if (!VEC) cp_async4(dst1 + d, f1 + rowg[t1 + rr], ok && rc.p4b);
  }
}
#endif

// Shared memory of an instance, in floats: the ring; with DEFER, NS
// staging slots of df1's planes; in the other tails, NQ slots of each
// point's own df_prev (no halo) of the planes in flight.  Past ~196 KB
// the SM's L1 shrinks to 28 KB and the copies slow down (PD = 3 and padded
// builds measured 2-25 % slower), so PD = 2 keeps every instance below
// but those of a 9-slot ring, which take PD = 1.
// A tail copies its own df_prev of plane l - OQLAG with the group of plane
// l; the copy must land by step l - OQLAG - NG, so OQLAG may be 0 .. NG,
// and NQ slots hold the planes in flight (of the NV evolved fields: a
// shock slot has no df).  The 8-field tails take NG, which keeps them at
// 183-186 KB (the 9-slot ones at PD = 1 at 177 KB); the others 0.
#ifndef PC_OQLAG
#define PC_OQLAG (NC >= 8 ? NG : 0)
#endif
#define OQLAG PC_OQLAG
#define NS PD
#define NQ (PD + NG + 1 - OQLAG)
template <bool FIRST, bool DEFER>
__host__ __device__ constexpr int smem_floats() {
  return NR * SLOT + (DEFER ? NS * SLOT : 0)
         + (!FIRST && !DEFER ? NQ * NV * NTHREADS : 0);
}

// Static shared memory, in bytes, at most: the row table (PC_ZG: two, fa's
// and the slabs'), the kick's sin/cos per plane, block_max_store's red[].
// 227 KB is what one block may use on Hopper.
#define STATIC_SMEM ((12 + 8 * PC_ZG) * NROWS + 8 * MX + 4 * (NTHREADS / 32) \
                     + 64)
// Two blocks per SM where two rings fit under the ~196 KB carve-out (the
// 4-field K1; each block with the 1 KB the system keeps): those instances
// are held to 128 registers.  Not the z-ghosted builds (PC_MINB2 = 0):
// their two sources (ZgSrc) do not fit, and the 4-field K6i held to 128
// spilled 24 B a thread; PC_MINB2=1 builds that variant.
#ifndef PC_MINB2
#define PC_MINB2 (!PC_ZG)
#endif
// The instances that would spill with Viscosity's other flavours and
// diffrho (visx_rhs, visx_dt1) in their march, measured on an NVIDIA H100
// 80GB HBM3 (pc_flagship_attrs): the 4-field hydro build's K1 UPW at its
// 128 registers (two blocks an SM; 8 B).  It is built without those
// terms, as before them, and the host refuses the flavours where it
// would launch it (_visx_spills in model.py, _visx_check in
// ops/fused_rhs.py).
template <bool FIRST, bool UPW>
__host__ __device__ constexpr bool visx_spills() {
  return !PC_MAG && !PC_ENT && !PC_SHOCK && !PC_SHEAR && !PC_ZG && FIRST
         && UPW;
}

template <bool FIRST, bool DEFER>
__host__ __device__ constexpr int min_blocks() {
  return PC_MINB2
      && 2 * (4 * smem_floats<FIRST, DEFER>() + STATIC_SMEM + 1024) <= 200704
      ? 2 : 1;
}
static_assert(!PC_TAILS  // no DEFER instance in the shock and zg builds
              || 4 * smem_floats<false, true>() + STATIC_SMEM <= 232448,
              "DEFER ring");
static_assert(4 * smem_floats<false, false>() + STATIC_SMEM <= 232448,
              "tail ring");
static_assert(SLOT % 4 == 0 && PZ % 4 == 0 && ZOFF % 4 == 0,
              "16-byte rows");
static_assert(OQLAG >= 0 && OQLAG <= NG, "own df_prev lag");
static_assert(MX <= NTHREADS, "one thread per plane reads the kick's sin/cos");

// One template for every kernel: FIRST is substep 1; otherwise DEFER
// rebuilds f1 = f0 + cprev*df1 in the ring and LAST skips the df store.
// FAKE puts f*1.0000001 in place of the RHS (the K8 memory floor); ROT
// adds the Coriolis force (launch() picks it where P.om is not 0), H3 the
// del6 terms (picked where a hyper coefficient is not 0), CHI the
// z-ghosted builds' chi-const term (picked where cp chi is not 0), UPW the
// upwinding (picked where an lupw flag is on; never beside H3), SHK the
// shock builds' shock diffusivities (picked where one is not 0).  coef =
// [alpha, beta*dt, cprev] and kick = [k(3), phase, f_re(3), f_im(3), N*dt,
// 0] live on the device, so no launch needs a host copy of dt.  dfin and
// dfout may be one buffer (K3'): each thread reads and writes only its own
// point of them, and copies its df_prev of a plane before it stores there.
// `vec`: nz % 4 == 0 and fa (and, with DEFER, dfin) 16-byte aligned.
// `zg`: the z-ghosted build's slabs and profiles (the others get none).
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
//
// Every thread computes every plane, also one whose point lies outside
// the grid (its ring position holds wrapped data): it just loads and
// stores nothing of its own there.
template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool FAKE, bool ROT,
          bool H3, bool CHI, bool UPW, bool SHK>
__global__ void __launch_bounds__(NTHREADS, min_blocks<FIRST, DEFER>())
pc_flagship(const PcParams P, const float* __restrict__ fa, const float* dfin,
            const float* __restrict__ coef, const float* __restrict__ kick,
            const float* __restrict__ ktab, float* dfout,
            float* __restrict__ faout, float* __restrict__ dt1blk, int vec,
            const ZgIn zg) {
  constexpr bool OWN = !FIRST && !DEFER;   // df_prev at the point, staged
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* stage = smem + NR * SLOT;     // DEFER
  float* ownq = smem + NR * SLOT;      // OWN: [NQ][NV][NTHREADS]
  // of each row of a plane: its offset in fa less the plane's (the field,
  // the wrapped y; PC_SHEAR: the ghosted y; PC_ZG: then in the slabs, each
  // of them ghosted in x and y with PC_SHEAR) and its byte offset in a slot
  __shared__ long long rowg[(1 + PC_ZG) * NROWS];
  __shared__ int rowd[NROWS];
  __shared__ float kick_a[KICK ? 2 * MX : 1];     // sin, cos of A per plane
  const int tid = threadIdx.x;
  const int tz = tid % TZ, ty = tid / TZ;
  const int x0 = blockIdx.z * MX, by = blockIdx.y * TY, bz = blockIdx.x * TZ;
  const int gy = by + ty, gz = bz + tz;
  const bool active = gy < P.ny && gz < P.nz;
  const int np = min(MX, P.nx - x0);   // planes computed
  const int nl = np + 2 * NG;          // planes loaded
  const size_t N = (size_t)P.nx * P.ny * P.nz;
  const size_t plane = (size_t)P.ny * P.nz;
#if PC_SHEAR
  // fa is ghosted in x and y, (NC, nx + 2 NG, ny + 2 NG, nz): plane l is
  // ghosted x = x0 + l and row iy ghosted y = by + iy, no wrap but in z.  A
  // block over the end of y repeats the last row for points that store
  // nothing
  const size_t fplane = (size_t)(P.ny + 2 * NG) * P.nz;
  const size_t MG = (size_t)(P.nx + 2 * NG) * fplane;
  for (int r = tid; r < NROWS; r += NTHREADS) {
    const int c = r / PY, iy = r - c * PY;
    rowg[r] = (long long)(c * MG)
              + (long long)min(by + iy, P.ny + 2 * NG - 1) * P.nz;
    rowd[r] = 4 * (c * FPL + iy * PZ);
#if PC_ZG
    rowg[NROWS + r] = (long long)c * (P.nx + 2 * NG) * (P.ny + 2 * NG) * NG
                      + (long long)min(by + iy, P.ny + 2 * NG - 1) * NG;
#endif
  }
#else
  const size_t fplane = plane;
  for (int r = tid; r < NROWS; r += NTHREADS) {
    const int c = r / PY, iy = r - c * PY;
    rowg[r] = (long long)(c * N)
              + (long long)wrap_index(by - NG + iy, P.ny) * P.nz;
    rowd[r] = 4 * (c * FPL + iy * PZ);
#if PC_ZG
    rowg[NROWS + r] = (long long)c * P.nx * P.ny * NG
                      + (long long)wrap_index(by - NG + iy, P.ny) * NG;
#endif
  }
#endif
  // 16-byte row copies where the caller allows them and the column does
  // not hang over the end of z
  const bool vecblk = vec && bz + TZ <= P.nz;
  const RowCopy rc = row_copy_plan(bz, P.nz, vecblk);
#if PC_ZG
  // each copy's source: fa, or a z-halo slab at the two ends of z
  const ZgSrc src0 = zg_source(rc.d0, bz, P, fa, zg);
  const ZgSrc src1 = zg_source(rc.d1, bz, P, fa, zg);
#endif
  // g_z and (PC_ZG with PC_ENT) the layer profiles at this thread's z,
  // fixed along the march; without gravity -0, which adds nothing
  const int izl = min(gz, P.nz - 1);
  const float grav = zg.grav ? zg.grav[izl] : -0.0f;
#if PC_ZG && PC_ENT
  const float lay_c = zg.prof_c[izl];
  const float lay_h = P.heat_norm * zg.prof_h[izl];
#else
  const float lay_c = 0.0f, lay_h = 0.0f;
#endif
#if PC_ZG && PC_ENT
  // K(z) and dK/dz of 'K-profile' at this thread's z, 0 where it is off
  // (loaded in the march, with the rates divided by cp, K6 ran slower),
  // and whether any of Entropy's other terms is on
  const float kz = zg.kprof ? __ldg(zg.kprof + izl) : 0.0f;
  const float dkz = zg.kprof ? __ldg(zg.kprof + P.nz + izl) : 0.0f;
  const bool zgx = zg.kprof || P.heat_uniform != 0.0f
                   || P.cool_uniform != 0.0f || P.tau_cool != 0.0f;
#else
  const bool zgx = false;
  const float kz = 0.0f, dkz = 0.0f;
#endif

  // The kick's factors that do not change along the march (JAX
  // fused_rhs.py:441-466: theta = k.x + phase = A + B + C, one axis each):
  // sin and cos of B (this row's) and C (this thread's) and the rotated
  // amplitudes U, V per thread, sin and cos of A per plane in shared
  // memory, all from the table that pc_kick_phases filled.
  float k_sb = 0.0f, k_cb = 0.0f, k_amp = 0.0f, k_u[3], k_v[3];
  if constexpr (KICK) {
    const int nt = P.nx + P.ny + P.nz;     // sines, then cosines
    if (tid < np) {
      kick_a[tid] = ktab[x0 + tid];
      kick_a[MX + tid] = ktab[nt + x0 + tid];
    }
    const int iy = P.nx + (active ? gy : 0);
    const int iz = P.nx + P.ny + (active ? gz : 0);
    k_sb = ktab[iy];
    k_cb = ktab[nt + iy];
    const float sC = ktab[iz], cC = ktab[nt + iz];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a = kick[4 + i], b = kick[7 + i];
      k_u[i] = a * cC - b * sC;
      k_v[i] = a * sC + b * cC;
    }
    k_amp = kick[10];
  }
  __syncthreads();

  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const unsigned stage_s = (unsigned)__cvta_generic_to_shared(stage);
  const unsigned ownq_s = (unsigned)__cvta_generic_to_shared(ownq);
  // planes are issued in order, l = 0, 1, ...: the next one's wrapped x
  // (PC_SHEAR: ghosted x) and its ring, staging and own-df_prev slots are
  // carried along
#if PC_SHEAR
  int il = 0, ix = x0, ir = 0, is = 0;
#else
  int il = 0, ix = wrap_index(x0 - NG, P.nx), ir = 0, is = 0;
#endif
  int iq = OQLAG ? (NQ - OQLAG % NQ) % NQ : 0;       // (il - OQLAG) % NQ
  auto issue = [&]() {
    const int l = il;
    if (l < nl) {
      const size_t xoff = (size_t)ix * fplane;
      const unsigned slot = ring_s + 4 * ir * SLOT;
#if PC_ZG
      const float* f0 = src0.base + ix * src0.pstride;
      const float* f1 = src1.base + ix * src1.pstride;
      if (vecblk)
        copy_rows_zg<true>(rc, rowg, rowd, slot + 4 * rc.d0,
                           slot + 4 * rc.d1, f0, f1, src0.tab, src1.tab);
      else
        copy_rows_zg<false>(rc, rowg, rowd, slot + 4 * rc.d0,
                            slot + 4 * rc.d1, f0, f1, src0.tab, src1.tab);
#else
      const unsigned stg = stage_s + 4 * is * SLOT;
      const float* f0 = fa + xoff + rc.z0;
      const float* f1 = fa + xoff + rc.z1;
      const float* g0 = DEFER ? dfin + xoff + rc.z0 : nullptr;
      const float* g1 = DEFER ? dfin + xoff + rc.z1 : nullptr;
      if (vecblk)
        copy_rows<true, DEFER>(rc, rowg, rowd, slot + 4 * rc.d0,
                               slot + 4 * rc.d1, stg + 4 * rc.d0,
                               stg + 4 * rc.d1, f0, f1, g0, g1);
      else
        copy_rows<false, DEFER>(rc, rowg, rowd, slot + 4 * rc.d0,
                                slot + 4 * rc.d1, stg + 4 * rc.d0,
                                stg + 4 * rc.d1, f0, f1, g0, g1);
#endif
      const int m = l - OQLAG;   // the plane whose own df_prev goes along
      if (OWN && active && m >= NG && m < np + NG) {
        const size_t xoffm = (OQLAG || PC_SHEAR)
            ? (size_t)wrap_index(x0 - NG + m, P.nx) * plane : xoff;
        const float* src = dfin + xoffm + (size_t)gy * P.nz + gz;
        const unsigned o = ownq_s + 4 * (iq * NV * NTHREADS + tid);
#pragma unroll
        for (int c = 0; c < NV; ++c)
          cp_async4(o + 4 * c * NTHREADS, src + c * N);
      }
    }
    cp_async_commit();
    il = l + 1;
#if PC_SHEAR
    ix = ix + 1;
#else
    ix = ix + 1 == P.nx ? 0 : ix + 1;
#endif
    ir = ir + 1 == NR ? 0 : ir + 1;
    is = is + 1 == NS ? 0 : is + 1;
    iq = iq + 1 == NQ ? 0 : iq + 1;
  };

  // DEFER, once plane l has landed: this thread's own df1 of it onto the
  // end of q, which holds planes j + NG .. j + 2 NG in step j (q[0]: the
  // df1 of the plane computed), then f1 = f0 + cprev*df1 over the plane's
  // slot, shared by all threads
  const int own = (ty + NG) * PZ + ZOFF + tz;
  const float cprev = DEFER ? coef[2] : 0.0f;
  float q[NG + 1][NV];
  auto rebuild = [&](int l) {
    const float* stg = stage + (l % NS) * SLOT + own;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
#pragma unroll
      for (int k = 0; k < NG; ++k) q[k][c] = q[k + 1][c];
      q[NG][c] = stg[c * FPL];
    }
    float4* s4 = reinterpret_cast<float4*>(ring + (l % NR) * SLOT);
    const float4* d4 =
        reinterpret_cast<const float4*>(stage + (l % NS) * SLOT);
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
    for (int l = 0; l < PD; ++l) issue();
    for (int l = 0; l < 2 * NG; ++l) {
      cp_async_wait<PD - 1>();
      __syncthreads();
      rebuild(l);
      __syncthreads();
      issue();
    }
  } else {
    for (int l = 0; l < 2 * NG + PD; ++l) issue();
  }

  const float alpha = FIRST ? 0.0f : coef[0], bdt = FIRST ? 0.0f : coef[1];
  const float* s0 = ring + own;
  float xt[NC][NX];      // the x taps of every field at this thread's point
  float dt1max = 0.0f;
  int jm = 0;            // j % NR
  // field 0 at this thread's point of plane x0, in dfout and faout
  size_t g = ((size_t)x0 * P.ny + gy) * P.nz + gz;
  // this point's continuous forcing on the plane computed (df's layout),
  // one plane ahead; a point outside the grid stores nothing and loads none
  float fc[3];
  if (zg.fcont) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      fc[a] = active ? __ldg(zg.fcont + g + a * N) : 0.0f;
  }
  for (int j = 0; j < np; ++j, jm = jm + 1 == NR ? 0 : jm + 1, g += plane) {
    cp_async_wait<PD - 1>();
    __syncthreads();
    if (DEFER) {
      rebuild(j + 2 * NG);
      __syncthreads();
    }
    issue();          // plane j + 2 NG + PD

    // this plane's slot, and its x neighbours' offsets from it
    const int sc = jm + NG < NR ? jm + NG : jm + NG - NR;
    int xo[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k)
      xo[k] = ((jm + k < NR ? jm + k : jm + k - NR) - sc) * SLOT;
    const float* s = s0 + sc * SLOT;
    // the column of x taps moves one plane on: one new tap per field (on
    // the first plane all of them)
    if (j == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int k = 1; k < NX; ++k) xt[c][k] = s[c * FPL + xo[k - 1]];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int k = 0; k < NX - 1; ++k) xt[c][k] = xt[c][k + 1];
      xt[c][NX - 1] = s[c * FPL + xo[NX - 1]];
    }

    float r[NV];
    float dt1 = 0.0f, dt1a = 0.0f, mdif = 0.0f;
    if constexpr (FAKE) {
#pragma unroll
      for (int c = 0; c < NV; ++c) r[c] = __fmul_rn(xt[c][NG], 1.0000001f);
    } else {
      // PC_SHEAR: the node x of this plane, the JAX tile rule in f32
      const float xn = PC_SHEAR
          ? __fadd_rn(P.x0, __fmul_rn(P.dx, (float)(x0 + j))) : 0.0f;
      flagship_rhs<FIRST, ROT, H3, CHI, UPW, SHK>(
          s, xt, xo, P, xn, lay_c, lay_h, grav, zgx, kz, dkz, r, dt1, dt1a,
          mdif);
      if (zg.fcont) {
        // the continuous forcing joins du last (the Forcing module
        // follows Magnetic), then the next plane's is loaded: a plane's
        // steps cover the loads' latency
#pragma unroll
        for (int a = 0; a < 3; ++a) r[UX + a] = __fadd_rn(r[UX + a], fc[a]);
        if (j + 1 < np) {
#pragma unroll
          for (int a = 0; a < 3; ++a)
            fc[a] = active ? __ldg(zg.fcont + g + plane + a * N) : 0.0f;
        }
      }
    }

    // Viscosity's other flavours and diffrho, where any is on (not in K8,
    // nor in the instances that would spill with them): after the plane's
    // outputs are stored as without them, their terms join them and the
    // outputs are stored again, so that the instance's schedule up to its
    // stores is the one of before (untaken, the terms inside its RHS or
    // between it and the stores cost 3-13 %); a first kernel also takes
    // their CFL rates
    constexpr bool VX =
        !FAKE && !visx_spills<FIRST, UPW>();
    if (FIRST) {
      if (active) {
        float* o = dfout + g;
#pragma unroll
        for (int c = 0; c < NV; ++c, o += N) *o = r[c];
        dt1max = fmaxf(dt1max, dt1);
      }
      if constexpr (VX) {
        if (__builtin_expect(P.visx != 0, 0)) {
          visx_rhs<H3>(s, xo, P, r);
          if (active) {
            float* o = dfout + g;
#pragma unroll
            for (int c = 0; c < NV; ++c, o += N) *o = r[c];
            dt1max = fmaxf(dt1max, visx_dt1(P, xt, dt1a, mdif));
          }
        }
      }
      continue;
    }

    float dfn[NV], fnew[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float dfp = DEFER
          ? q[0][c] : ownq[(((j + NG) % NQ) * NV + c) * NTHREADS + tid];
      dfn[c] = __fadd_rn(__fmul_rn(alpha, dfp), r[c]);
      fnew[c] = __fadd_rn(xt[c][NG], __fmul_rn(bdt, dfn[c]));
    }
    if (KICK) {
      // theta = A + B + C in angle-addition form, the plane's sin A, cos A
      // from shared memory
      const float sA = kick_a[j], cA = kick_a[MX + j];
      const float Pc = cA * k_cb - sA * k_sb;   // cos(A+B)
      const float Qs = sA * k_cb + cA * k_sb;   // sin(A+B)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        fnew[UX + i] = fnew[UX + i] + k_amp * (Pc * k_u[i] - Qs * k_v[i]);
    }
    if (active) {
      float* o = faout + g;
#pragma unroll
      for (int c = 0; c < NV; ++c, o += N) *o = fnew[c];
      if (!LAST) {
        o = dfout + g;
#pragma unroll
        for (int c = 0; c < NV; ++c, o += N) *o = dfn[c];
      }
    }
    if constexpr (VX) {
      if (__builtin_expect(P.visx != 0, 0)) {
        // their terms v join df and, times beta dt, f
        float v[NV];
#pragma unroll
        for (int c = 0; c < NV; ++c) v[c] = -0.0f;
        visx_rhs<H3>(s, xo, P, v);
        if (active) {
          float* o = faout + g;
#pragma unroll
          for (int c = 0; c < NV; ++c, o += N)
            *o = __fadd_rn(fnew[c], __fmul_rn(bdt, v[c]));
          if (!LAST) {
            o = dfout + g;
#pragma unroll
            for (int c = 0; c < NV; ++c, o += N) *o = __fadd_rn(dfn[c], v[c]);
          }
        }
      }
    }
  }
  // a red[] of its own for the z-ghosted builds' Coriolis K6 and for each
  // instance with the H3 (periodic and z-ghosted builds) or CHI flag, so
  // that the instances without them keep the shared layout of a build
  // that lacks those; each first kernel of the aux builds with ss and aa
  // has one of its own too (tags 8-11), and so has each of the z-ghosted
  // shear builds (tags 12-19), and so has each of the z-ghosted builds
  // without ss (tags 20-35), and each UPW instance (tags 36-39) and SHK
  // instance (tags 40-47), and each instance of the z-ghosted builds with
  // the shock slot (tags 56-71: SHK beside CHI there too)
  constexpr bool XT = CHI || (H3 && PC_TAILS);
  constexpr bool ZH3 = H3 && PC_ZG;
  constexpr int TAG = PC_ZG && PC_SHOCK
      ? 56 + ROT + 2 * CHI + 4 * UPW + 8 * SHK
      : SHK ? 40 + ROT + 2 * H3 + 4 * UPW
      : UPW ? 36 + ROT + 2 * CHI
      : PC_ZG && !PC_ENT
      ? 20 + ROT + 2 * H3 + 4 * PC_SHEAR + 8 * PC_MAG
      : PC_ZG && PC_SHEAR
      ? 12 + ROT + 2 * CHI + 4 * H3
      : PC_JOINS && PC_ENT && PC_MAG
      ? 8 + ROT + 2 * H3
      : ((PC_ZG || XT) && ROT) + 2 * XT + 4 * ZH3;
  if (FIRST)
    block_max_store<NTHREADS, TAG>(
        dt1max, dt1blk + (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                    + blockIdx.x);
}

template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool FAKE, bool ROT,
          bool H3, bool CHI, bool UPW, bool SHK = false>
static int launch_as(const PcParams* p, const float* fa, const float* dfin,
                     const float* coef, const float* kick, const float* ktab,
                     float* dfout, float* faout, float* dt1blk, void* stream,
                     const ZgIn& zg) {
  auto kern =
      pc_flagship<FIRST, DEFER, LAST, KICK, FAKE, ROT, H3, CHI, UPW, SHK>;
  const int smem = 4 * smem_floats<FIRST, DEFER>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = p->nz % 4 == 0 && (uintptr_t)fa % 16 == 0
                  && (!DEFER || (uintptr_t)dfin % 16 == 0);
  const dim3 grid((p->nz + TZ - 1) / TZ, (p->ny + TY - 1) / TY,
                  (p->nx + MX - 1) / MX);
  kern<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      *p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, vec, zg);
  return (int)cudaGetLastError();
}

// launch_as with the Coriolis force where Omega is not 0
template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool H3, bool CHI,
          bool UPW = false, bool SHK = false>
static int launch_rot(const PcParams* p, const float* fa, const float* dfin,
                      const float* coef, const float* kick, const float* ktab,
                      float* dfout, float* faout, float* dt1blk, void* stream,
                      const ZgIn& zg) {
  const bool rot = p->om[0] != 0.0f || p->om[1] != 0.0f || p->om[2] != 0.0f;
  return rot
      ? launch_as<FIRST, DEFER, LAST, KICK, false, true, H3, CHI, UPW, SHK>(
            p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg)
      : launch_as<FIRST, DEFER, LAST, KICK, false, false, H3, CHI, UPW, SHK>(
            p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg);
}

#if PC_SHOCK
// The shock builds' SHK instances (a shock diffusivity on): with rotation
// where Omega is not 0, beside the del6 terms or the upwinding where those
// are on.
template <bool FIRST, bool DEFER, bool LAST, bool KICK>
static int launch_shk(const PcParams* p, const float* fa, const float* dfin,
                      const float* coef, const float* kick, const float* ktab,
                      float* dfout, float* faout, float* dt1blk, void* stream,
                      const ZgIn& zg) {
  const bool hyper = p->nu3 > 0.0f || p->eta3 > 0.0f || p->diff3 > 0.0f;
  if (p->upw[0] || p->upw[1] || p->upw[2])
    return hyper ? (int)cudaErrorInvalidValue
                 : launch_rot<FIRST, DEFER, LAST, KICK, false, false, true,
                              true>(p, fa, dfin, coef, kick, ktab, dfout,
                                    faout, dt1blk, stream, zg);
  return hyper
      ? launch_rot<FIRST, DEFER, LAST, KICK, true, false, false, true>(
            p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg)
      : launch_rot<FIRST, DEFER, LAST, KICK, false, false, false, true>(
            p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg);
}
#endif

// The instance with the Coriolis force where Omega is not 0 (K8 has none)
// and with the build's own terms where they are on: the del6 terms where a
// hyper coefficient is not 0 (H3: every build), chi-const where cp chi is
// not 0 (CHI: the z-ghosted builds with ss, each with both flags, four
// instances a rotation), the upwinding where an lupw flag is on (UPW: every
// build, with CHI where the build has it; beside a hyper coefficient no
// instance, an invalid value), the shock diffusivities where one is on
// (SHK: the shock builds, beside each of the others).
#if PC_ZG && PC_SHOCK
// The z-ghosted builds with the shock slot: CHI where cp chi is not 0, UPW
// where an lupw flag is on, SHK where a shock diffusivity is on, each with
// or without the others, with rotation where Omega is not 0.
template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool CHI, bool SHK>
static int launch_zgs(const PcParams* p, const float* fa, const float* dfin,
                      const float* coef, const float* kick,
                      const float* ktab, float* dfout, float* faout,
                      float* dt1blk, void* stream, const ZgIn& zg) {
  if (p->upw[0] || p->upw[1] || p->upw[2])
    return launch_rot<FIRST, DEFER, LAST, KICK, false, CHI, true, SHK>(
        p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg);
  return launch_rot<FIRST, DEFER, LAST, KICK, false, CHI, false, SHK>(
      p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg);
}
#endif

template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool FAKE>
static int launch(const PcParams* p, const float* fa, const float* dfin,
                  const float* coef, const float* kick, const float* ktab,
                  float* dfout, float* faout, float* dt1blk, void* stream,
                  const ZgIn& zg = ZgIn{}) {
#if PC_ZG && PC_SHOCK
  // no H3 instance beside the slot: the host refuses del6 here
  if (p->nu3 > 0.0f || p->eta3 > 0.0f || p->diff3 > 0.0f)
    return (int)cudaErrorInvalidValue;
  const bool shk = p->diffrho_shock > 0.0f || p->eta_shock > 0.0f
                   || p->chi_shock > 0.0f;
  if (p->cpchi > 0.0f)
    return shk ? launch_zgs<FIRST, DEFER, LAST, KICK, true, true>(
                     p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk,
                     stream, zg)
               : launch_zgs<FIRST, DEFER, LAST, KICK, true, false>(
                     p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk,
                     stream, zg);
  return shk ? launch_zgs<FIRST, DEFER, LAST, KICK, false, true>(
                   p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk,
                   stream, zg)
             : launch_zgs<FIRST, DEFER, LAST, KICK, false, false>(
                   p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk,
                   stream, zg);
#else
  if constexpr (!FAKE) {
#if PC_SHOCK
    if (p->diffrho_shock > 0.0f || p->eta_shock > 0.0f
        || p->chi_shock > 0.0f)
      return launch_shk<FIRST, DEFER, LAST, KICK>(
          p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg);
#endif
    const bool hyper = p->nu3 > 0.0f || p->eta3 > 0.0f || p->diff3 > 0.0f;
    if (p->upw[0] || p->upw[1] || p->upw[2]) {
      if (hyper) return (int)cudaErrorInvalidValue;
#if PC_ZG && PC_ENT
      if (p->cpchi > 0.0f)
        return launch_rot<FIRST, DEFER, LAST, KICK, false, true, true>(
            p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg);
#endif
      return launch_rot<FIRST, DEFER, LAST, KICK, false, false, true>(
          p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg);
    }
#if PC_ZG && PC_ENT
    if (p->cpchi > 0.0f)
      return hyper
          ? launch_rot<FIRST, DEFER, LAST, KICK, true, true>(
                p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream,
                zg)
          : launch_rot<FIRST, DEFER, LAST, KICK, false, true>(
                p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream,
                zg);
#endif
    if (hyper)
      return launch_rot<FIRST, DEFER, LAST, KICK, true, false>(
          p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg);
    const bool rot = p->om[0] != 0.0f || p->om[1] != 0.0f || p->om[2] != 0.0f;
    if (rot)
      return launch_as<FIRST, DEFER, LAST, KICK, false, true, false, false,
                       false>(p, fa, dfin, coef, kick, ktab, dfout, faout,
                              dt1blk, stream, zg);
  }
  return launch_as<FIRST, DEFER, LAST, KICK, FAKE, false, false, false, false>(
      p, fa, dfin, coef, kick, ktab, dfout, faout, dt1blk, stream, zg);
#endif
}

// The substep-1 kernel and the three tail kinds, real or fake.
template <bool FAKE>
static int first(const PcParams* p, const float* fa, float* df,
                 float* dt1blk, void* stream, const ZgIn& zg = ZgIn{}) {
  return launch<true, false, false, false, FAKE>(
      p, fa, nullptr, nullptr, nullptr, nullptr, df, nullptr, dt1blk, stream,
      zg);
}

#if PC_TAILS
template <bool FAKE>
static int tail_defer(const PcParams* p, const float* fa, const float* df1,
                      const float* coef, float* df2, float* f2, void* stream,
                      const ZgIn& zg = ZgIn{}) {
  return launch<false, true, false, false, FAKE>(
      p, fa, df1, coef, nullptr, nullptr, df2, f2, nullptr, stream, zg);
}

// The sines, then the cosines, of the kick's partial phases A = kx*x +
// phase at each x, B = ky*y at each y and C = kz*z at each z (nx + ny + nz
// of each), in the kernels' rounding, for the tails to read: the march
// itself calls no sincosf.
__global__ void pc_kick_phases(const PcParams P,
                               const float* __restrict__ kick,
                               const float* __restrict__ zc,
                               float* __restrict__ tab) {
  const int nt = P.nx + P.ny + P.nz;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nt) return;
  float ang;
  if (i < P.nx) {
    const float xg = __fadd_rn(P.x0, __fmul_rn(P.dx, (float)i));
    ang = __fadd_rn(__fmul_rn(kick[0], xg), kick[3]);
  } else if (i < P.nx + P.ny) {
    const float yg = __fadd_rn(P.y0, __fmul_rn(P.dy, (float)(i - P.nx)));
    ang = __fmul_rn(kick[1], yg);
  } else {
    ang = __fmul_rn(kick[2], zc[i - P.nx - P.ny]);
  }
  sincosf(ang, &tab[i], &tab[nt + i]);
}

// a null kick is an unforced run; tab is scratch for pc_kick_phases,
// 2 (nx + ny + nz) floats
template <bool DEFER, bool FAKE>
static int tail_last(const PcParams* p, const float* fa, const float* dfin,
                     const float* coef, const float* kick, const float* zc,
                     float* tab, float* f, void* stream,
                     const ZgIn& zg = ZgIn{}) {
  if (kick) {
    const int nt = p->nx + p->ny + p->nz;
    pc_kick_phases<<<(nt + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        *p, kick, zc, tab);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch<false, DEFER, true, true, FAKE>(
        p, fa, dfin, coef, kick, tab, nullptr, f, nullptr, stream, zg);
  }
  return launch<false, DEFER, true, false, FAKE>(
      p, fa, dfin, coef, nullptr, nullptr, nullptr, f, nullptr, stream, zg);
}
#endif  // PC_TAILS

// Registers, local (spill) bytes per thread, static and dynamic shared
// memory per block, and resident blocks per SM of one instance.
template <bool FIRST, bool DEFER, bool LAST, bool KICK, bool FAKE,
          bool ROT = false, bool H3 = false, bool CHI = false,
          bool UPW = false, bool SHK = false>
static int attrs(int* out) {
  auto kern =
      pc_flagship<FIRST, DEFER, LAST, KICK, FAKE, ROT, H3, CHI, UPW, SHK>;
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

// attrs() of the instance `base` of pc_flagship_attrs with rotation ROT and
// the flags H3, CHI, UPW and SHK
template <bool ROT, bool H3, bool CHI, bool UPW = false, bool SHK = false>
static int attrs_of(int base, int* out) {
  switch (base) {
    case 0:
      return attrs<true, false, false, false, false, ROT, H3, CHI, UPW, SHK>(
          out);
    case 8:
      return attrs<false, false, false, false, false, ROT, H3, CHI, UPW,
                   SHK>(out);
#if PC_TAILS
    case 2:
      return attrs<false, true, false, false, false, ROT, H3, CHI, UPW>(out);
    case 4:
      return attrs<false, false, true, true, false, ROT, H3, CHI, UPW>(out);
    case 5:
      return attrs<false, false, true, false, false, ROT, H3, CHI, UPW>(out);
    case 9:
      return attrs<false, true, true, true, false, ROT, H3, CHI, UPW>(out);
    case 10:
      return attrs<false, true, true, false, false, ROT, H3, CHI, UPW>(out);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
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
// and without the kick; + 16 with rotation, + 32 with the del6 terms (H3),
// + 64 with chi-const (CHI, the z-ghosted builds with ss only), + 128 with
// the upwinding (UPW: every build, not with H3), + 256 with the shock
// diffusivities (SHK: the shock builds, with CHI only in the z-ghosted
// ones, which have no H3).  Only the
// isothermal MHD build has K8 (1, 3, 6, 7; none with rotation or H3).  The
// shock and shear builds have 0 and 8 (K1s and K5w, or K4 and K5, and
// those of their other layouts), each with the four flag sets, the
// z-ghosted builds 0 and 8 (K6 and
// K7, K6m and K7m) with the eight, those without ss with the four.
int pc_flagship_attrs(int which, int* out) {
  switch (which) {
#if PC_MAG && !PC_ENT && PC_TAILS
    case 1: return attrs<true, false, false, false, true>(out);
    case 3: return attrs<false, true, false, false, true>(out);
    case 6: return attrs<false, false, true, true, true>(out);
    case 7: return attrs<false, false, true, false, true>(out);
#endif
    default: break;
  }
  const int base = which & 15;
  switch (which >> 4) {
    case 0: return attrs_of<false, false, false>(base, out);
    case 1: return attrs_of<true, false, false>(base, out);
#if !(PC_ZG && PC_SHOCK)
    case 2: return attrs_of<false, true, false>(base, out);
    case 3: return attrs_of<true, true, false>(base, out);
#endif
#if PC_ZG && PC_ENT
    case 4: return attrs_of<false, false, true>(base, out);
    case 5: return attrs_of<true, false, true>(base, out);
#if !PC_SHOCK
    case 6: return attrs_of<false, true, true>(base, out);
    case 7: return attrs_of<true, true, true>(base, out);
#endif
#endif
    case 8: return attrs_of<false, false, false, true>(base, out);
    case 9: return attrs_of<true, false, false, true>(base, out);
#if PC_ZG && PC_ENT
    case 12: return attrs_of<false, false, true, true>(base, out);
    case 13: return attrs_of<true, false, true, true>(base, out);
#endif
#if PC_SHOCK
    case 16: return attrs_of<false, false, false, false, true>(base, out);
    case 17: return attrs_of<true, false, false, false, true>(base, out);
#if !PC_ZG
    case 18: return attrs_of<false, true, false, false, true>(base, out);
    case 19: return attrs_of<true, true, false, false, true>(base, out);
#endif
    case 24: return attrs_of<false, false, false, true, true>(base, out);
    case 25: return attrs_of<true, false, false, true, true>(base, out);
#endif
#if PC_ZG && PC_SHOCK
    case 20: return attrs_of<false, false, true, false, true>(base, out);
    case 21: return attrs_of<true, false, true, false, true>(base, out);
    case 28: return attrs_of<false, false, true, true, true>(base, out);
    case 29: return attrs_of<true, false, true, true, true>(base, out);
#endif
    default: return (int)cudaErrorInvalidValue;
  }
}

// the inputs after the stream (and K3's and K2L's scratch): of the
// z-ghosted build the slabs, the profiles and K(z), then of every build
// g_z(z) and the continuous forcing
#if PC_ZG
#define ZG_INPUTS , const float *zlo, const float *zhi, const float *prof_c, \
                  const float *prof_h, const float *kprof
#define ZG_IN(grav, fcont) ZgIn{zlo, zhi, prof_c, prof_h, grav, fcont, kprof}
#else
#define ZG_INPUTS
#define ZG_IN(grav, fcont) ZgIn{nullptr, nullptr, nullptr, nullptr, grav, \
                                fcont, nullptr}
#endif

// K1: replaces `kernel` + `_dma_tile_wrap` (pencil_tpu/ops/fused_rhs.py);
// in the shock builds K1s (the same with the shock slot) and K4 (`kernel`
// + `_dma_tile`, zroll), fa then the 8-slot state, ghosted in x and y for
// K4; in the z-ghosted builds K6 and K6m (`kernel_zg` + `_fetch_zg`), fa
// the interior (5 or 8, nx, ny, nz) with its z-halo slabs, the layer
// profiles and K(z) of 'K-profile' (or null) after the stream; grav,
// g_z(z) or null, follows those, then fcont, the continuous forcing or
// null.
int pc_rhs_first(const PcParams* p, const float* fa, float* df,
                 float* dt1blk, void* stream ZG_INPUTS, const float* grav,
                 const float* fcont) {
  return first<false>(p, fa, df, dt1blk, stream, ZG_IN(grav, fcont));
}

#if PC_TAILS
// K2: replaces `kernel_tail(defer_prev=True)` (pencil_tpu/ops/fused_rhs.py).
int pc_rhs_tail_defer(const PcParams* p, const float* fa, const float* df1,
                      const float* coef, float* df2, float* f2, void* stream,
                      const float* grav, const float* fcont) {
  return tail_defer<false>(p, fa, df1, coef, df2, f2, stream,
                           ZG_IN(grav, fcont));
}

// K3: replaces `kernel_tail(last=True, with_kick)` (pencil_tpu/ops/
// fused_rhs.py); kick may be null (unforced runs), else tab is scratch of
// 2 (nx + ny + nz) floats (it follows the stream, so that a caller of the
// older interface, without it, still runs an unforced tail); grav and
// fcont follow.
int pc_rhs_tail_last(const PcParams* p, const float* fa, const float* df2,
                     const float* coef, const float* kick, const float* zc,
                     float* f3, void* stream, float* tab, const float* grav,
                     const float* fcont) {
  return tail_last<false, false>(p, fa, df2, coef, kick, zc, tab, f3, stream,
                                 ZG_IN(grav, fcont));
}
#endif  // PC_TAILS

// K3': replaces the 2N-RK4 middle substeps' `kernel_upd` with the wrap
// fetch (pencil_tpu/ops/fused_rhs.py); in the shock builds K5w (the same
// with the shock slot) and K5 (`kernel_upd` with the zroll `_dma_tile`
// fetch); in the z-ghosted builds K7 and K7m (`kernel_zg_upd`).  df may be
// df_prev's own buffer.
int pc_rhs_tail_mid(const PcParams* p, const float* fa, const float* df_prev,
                    const float* coef, float* df, float* f,
                    void* stream ZG_INPUTS, const float* grav,
                    const float* fcont) {
  return launch<false, false, false, false, false>(
      p, fa, df_prev, coef, nullptr, nullptr, df, f, nullptr, stream,
      ZG_IN(grav, fcont));
}

#if PC_TAILS
// K2L: replaces `kernel_tail(defer_prev=True, last=True, with_kick)`
// (pencil_tpu/ops/fused_rhs.py); kick may be null, else tab as for K3.
int pc_rhs_tail_defer_last(const PcParams* p, const float* fa,
                           const float* df1, const float* coef,
                           const float* kick, const float* zc, float* f,
                           void* stream, float* tab, const float* grav,
                           const float* fcont) {
  return tail_last<true, false>(p, fa, df1, coef, kick, zc, tab, f, stream,
                                ZG_IN(grav, fcont));
}
#endif

#if PC_MAG && !PC_ENT && PC_TAILS
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
                          void* stream, float* tab) {
  return tail_last<false, true>(p, fa, df2, coef, kick, zc, tab, f3, stream);
}
#endif  // PC_MAG && !PC_ENT && PC_TAILS

}  // extern "C"
