// Device code of K1 shared by the forward kernel (gen_trace.cu) and the
// backward kernel K2 (gen_grad.cu): the launch prologue, the surface step
// and the image epilogue, for sub-slices (a) conic and plane surfaces that
// refract, reflect and absorb, (b) tilt/decenter, radial and offset-radial
// apertures and simple coatings, (c) the Newton sags (even/odd aspheres, the
// XY polynomial, the Chebyshev grid, the biconic, the toroid, the Zernike
// sag, the Forbes Qbfs and Q2D sags) and the thin Fresnel surfaces (zoned,
// designed), the launch modes of (d) (the object-space telecentric aim and
// the closed-form apodizations), the diffractive surfaces of (f) (the
// linear grating and the constant, radial and linear-grating phase
// profiles on conic or plane substrates), and the OPD modes of (g): the
// Kahan-compensated sum and the split-OPD accumulation.
//
// Both kernels run this one forward, so K2's recomputed forward is bit for
// bit K1's, lost-ray masks included. Sub-slice (e), the polarization chain,
// is a template flag (POL) of the surface step, with its own libraries
// (gen_trace_pol.cu, gen_grad_pol*.cu), so that unpolarized launches run
// the code they ran before it.
//
// Counterpart of optiland_pr_tpu/kernels/pallas_trace.py: _gen_prologue
// (2008-2054, the split frame 2032-2038), _surface_step (1308-1754:
// localize 1345-1360, the split frame 1361-1368, the conic root 1371-1404,
// the Newton refinement 1406-1440, the split deviation and Kahan sums
// 1446-1481, the split sag refresh 1482-1489, the aperture 1493-1500, the
// freeform normal 1663-1671, the coating 1733-1736, globalize 1738-1748),
// _state_step's propagation sign (2057-2099, 2163-2168), _conic_base
// (435-443), _asphere_sag_grad (396-432), _axis_conic (446-453),
// _zernike_sag_grad (468-530), _forbes_sigma (518), _qbfs_sag_grad (533),
// _q2d_sag_grad (594), _freeform_sag_grad (841-935), the Fresnel branches
// (1379-1383, 1672-1688, 1707-1720), the (d) branches of _gen_prologue
// (telecentric 1980, 2011; apodization 1998, 2026-2051) and _gen_epilogue
// (2123-2140), the diffractive branches of _surface_step (the shared conic
// slope and normal 1527-1540, the grating 1542-1586, the phase update
// 1587-1662).
//
// Layout (shared with the plain version, kernels/gen_trace.py):
//   gen    [F, 16]     per-field launch constants (origin/aim coefficients,
//                      field offsets, launch z, EPL or the telecentric aim
//                      distance, image thickness), 10 the telecentric flag,
//                      11 the apodization code, 12-15 its constants
//   consts [W, S, 32]  per-wavelength, per-surface scalars; columns
//                      0 radius_inv 1 conic 2 pos_z 3 n1 4 n2 5 alpha_abs
//                      6 coating factor 8-16 rotation (row-major)
//                      17-19 translation (tx, ty, pos_z + dz)
//                      20 r_min^2 21 r_max^2 22-23 aperture offset
//                      24-25 the sag's own scalars: Chebyshev norm_x,
//                      norm_y; biconic 1/radius_x, conic_x; toroid the
//                      rotation radius (1 at infinity); Zernike
//                      norm_radius; Forbes norm_radius; designed Fresnel
//                      focal_length, n_design; a grating m lambda / period
//                      (per wavelength) and tan of its groove angle; a
//                      phase surface's constant phase, or its linear
//                      grating's (Kx, Ky)
//                      7 the wavelength (a phase surface's k0 = 2 pi / c7)
//                      27 the signed vertex gap (split mode; surface 1's
//                      from the launch plane)
//                      29 a phase surface's diffraction efficiency
//   acoef  [S, C]      sag coefficients, row k for surface k: asphere and
//                      toroid terms, the XY-polynomial and Chebyshev grids
//                      row-major (C[i][j] at i nv + j), Zernike terms, the
//                      Forbes sags' basis-changed terms (a Q2D surface's
//                      followed by its term structure, q2d_sag_grad), a
//                      radial phase profile's terms
//   ztab   [3, MAX_TERMS, ZT_W]  each Zernike basis's term structure, built
//                      on the host (kernels/gen_trace.py::zernike_table):
//                      per term n, m, the normalization, the number of
//                      radial powers, then (p, coef, p coef) per power in
//                      ascending p
//   flags  [S]         bits 0 plane, 1 reflective, 2 absorbing, 3 tilted or
//                      decentered, 4 aperture, 5 simple coating; bits 6-9 the
//                      sag (GK_*); bits 10-15 nu, the terms of a sag or the
//                      x size of a grid; bits 16-21 nv, a grid's y size;
//                      bits 22-23 the Zernike basis (0 standard, 1 fringe,
//                      2 Noll); bit 24 a Fresnel coating; bits 25-26 the
//                      interaction (INTER_*: 0 refract or reflect, 1
//                      grating, 2 phase); bits 27-28 a phase surface's
//                      profile (PH_*); bit 29 a phase surface on the Plane
//                      class (its normal +z)
//
// Rounding: every operation is an explicit IEEE round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts
// into an FMA, in the order of the plain PyTorch version. The kernels and the
// plain version on the card therefore agree bit for bit. Built without
// --use_fast_math.
//
// Variants: surface_step is a template on the variant and on the OPD mode.
// VAR_NARROW compiles only sub-slice (a), the code that ran before (b) and
// (c) existed, so a conic/plane system keeps its register count and speed;
// VAR_WIDE adds (b) and the even/odd aspheres; VAR_FREEFORM adds the other
// sags of (c) (sag kinds GK_POLY and up), so the aspheric systems keep the
// WIDE variant's registers. The host launches the least variant the flag
// words need. The OPD mode (OPD_PLAIN, OPD_KAHAN, OPD_SPLIT) is the
// caller's choice; OPD_PLAIN compiles the code that ran before (g). The
// split mode takes no sag but the conic, so VAR_FREEFORM is built in the
// plain and Kahan modes only. The diffractive surfaces of (f) are a
// runtime branch on the flag word's interaction bits in the WIDE,
// FREEFORM and FORBES variants (the host launches at least WIDE for them),
// so the narrow variant compiles the code it had before (f); the split
// mode takes none. A source compiles the branch when it defines WITH_DOE
// 1 before including this header: K1 and K3 do; K2's adjoint of it would
// take the WIDE and wider instances' registers (WIDE K2 from 128 to ~205),
// so K2's instances with it are libraries of their own
// (gen_grad_doe*.cu, gen_grad_pol_doe*.cu), and its other libraries compile
// the code they had before (f).
//
// The Newton sags share the asphere's loop: the conic root (or the plane)
// as the warm start, NEWTON_ITERS steps, then the live step K2
// differentiates. Each sag's term structure is static per surface: loop
// counts from the flag word, the Zernike terms from ztab, never recomputed
// from the term index per ray.
//
// The OPD modes (sub-slice (g)):
//   OPD_KAHAN  opd += |t n1| as a compensated (two-sum) update, with the
//              compensation in opd_c;
//   OPD_SPLIT  for untilted conic/plane stacks: z is local to the previous
//              vertex (0 at the launch plane); the surface shifts by its gap
//              (column 27) instead of its position; the per-ray sum takes
//              only the deviation of the path from the axial gap,
//              dev = n1 sigma gap (1-|N|)/|N| - sigma n1 zp/|N| + n1 tq with
//              |N| = sigma N, (1-|N|) = (L^2+M^2)/(1+|N|), zp the entry z
//              and tq the conic root's correction to t0 = -z/N, compensated;
//              after the propagation z is the exact conic sag at the landed
//              (x, y) (0 on a plane) and stays local. sigma, the static
//              propagation sign, flips after each mirror. The axial base
//              sum_k sigma_k n1_k gap_k is the caller's (kernels/gen_trace.py).
#pragma once

#include <cuda_runtime.h>

// 1: compile the diffractive surfaces of (f) (see above)
#ifndef WITH_DOE
#define WITH_DOE 0
#endif
#include <math.h>
#include <stdint.h>

#define CONST_W 32
#define GEN_W 16
#define MAX_SURF 64
#define MAX_TERMS 32
#define NEWTON_ITERS 8

#define ZT_W 32

enum { FLAG_PLANE = 1, FLAG_REFL = 2, FLAG_ABSORB = 4, FLAG_CS = 8,
       FLAG_AP = 16, FLAG_COAT = 32 };
// a Fresnel coating (bit 24): read by a polarized launch only, so it needs
// no wider variant
#define FLAG_FRESNEL (1 << 24)
// sub-slice (f): the interaction (bits 25-26), a phase surface's profile
// (bits 27-28) and its Plane class (bit 29); the efficiency's column
#define INTER_SHIFT 25
#define INTER_MASK 3
enum { INTER_NONE = 0, INTER_GRATING = 1, INTER_PHASE = 2 };
#define PHASE_SHIFT 27
#define PHASE_MASK 3
enum { PH_CONSTANT = 0, PH_RADIAL = 1, PH_LINEAR = 2 };
#define FLAG_PLANE_CLS (1 << 29)
#define EFF_COL 29
// the sag kinds
enum { GK_CONIC = 0, GK_EVEN = 1, GK_ODD = 2, GK_POLY = 3, GK_CHEB = 4,
       GK_BICONIC = 5, GK_TORUS = 6, GK_TORUS_INF = 7, GK_ZERNIKE = 8,
       GK_FZONE = 9, GK_FDESIGNED = 10, GK_QBFS = 11, GK_Q2D = 12,
       GK_LAST = GK_Q2D };
enum { OPD_PLAIN = 0, OPD_KAHAN = 1, OPD_SPLIT = 2 };
enum { VAR_NARROW = 0, VAR_WIDE = 1, VAR_FREEFORM = 2, VAR_FORBES = 3 };
#define GKIND_SHIFT 6
#define GKIND_MASK 15
#define NU_SHIFT 10
#define NV_SHIFT 16
#define NTERM_MASK 63
#define BASIS_SHIFT 22
#define BASIS_MASK 3
// the bits that need the WIDE variant
#define WIDE_MASK (FLAG_CS | FLAG_AP | FLAG_COAT | (GKIND_MASK << GKIND_SHIFT) \
                   | (INTER_MASK << INTER_SHIFT))

__host__ __device__ __forceinline__ int gkind_of(int fl) { return (fl >> GKIND_SHIFT) & GKIND_MASK; }
__host__ __device__ __forceinline__ int nu_of(int fl) { return (fl >> NU_SHIFT) & NTERM_MASK; }
__host__ __device__ __forceinline__ int nv_of(int fl) { return (fl >> NV_SHIFT) & NTERM_MASK; }
__host__ __device__ __forceinline__ int basis_of(int fl) { return (fl >> BASIS_SHIFT) & BASIS_MASK; }
__host__ __device__ __forceinline__ int inter_of(int fl) { return (fl >> INTER_SHIFT) & INTER_MASK; }
__host__ __device__ __forceinline__ int phase_of(int fl) { return (fl >> PHASE_SHIFT) & PHASE_MASK; }
// the coefficients a sag reads from its acoef row
__host__ __device__ __forceinline__ int ncoef_of(int fl) {
    const int gk = gkind_of(fl);
    return (gk == GK_POLY || gk == GK_CHEB) ? nu_of(fl) * nv_of(fl) : nu_of(fl);
}
// a Q2D sag's term structure rows after its coefficients (q2d_sag_grad)
#define Q2D_ROWS 4
// the columns of its acoef row a sag reads
__host__ __device__ __forceinline__ int acoef_width_of(int fl) {
    return gkind_of(fl) == GK_Q2D ? (1 + Q2D_ROWS) * nu_of(fl) : ncoef_of(fl);
}

struct SurfFlags {
    int32_t f[MAX_SURF];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqt(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float rsq(float a) { return __fdiv_rn(1.0f, __fsqrt_rn(a)); }

#define EPS_GUARD 1e-14f
#define ODD_R2_MIN 1e-24f   // the odd asphere's r = sqrt(max(r^2, 1e-24))

// |v| > eps ? v : (v >= 0 ? eps : -eps)  (pallas_trace.py:1397-1400)
__device__ __forceinline__ float eps_guard(float v) {
    return fabsf(v) > EPS_GUARD ? v : (v >= 0.0f ? EPS_GUARD : -EPS_GUARD);
}

// jnp.sign(d) * r: sign(0) == 0 here (pallas_trace.py:1513, 1707), unlike
// the +-1 pairing sign of the intersection root
__device__ __forceinline__ float sign_times(float d, float r) {
    return d > 0.0f ? r : (d < 0.0f ? -r : 0.0f);
}

struct RayState {
    float x, y, z, L, M, N, inten, opd;
    float opd_c;      // the Kahan compensation (OPD_KAHAN, OPD_SPLIT)
    bool valid;
};

// Intermediates of one surface step. K1 discards them (the stores are dead
// code after inlining); K2's reverse sweep reads them back.
struct SurfTape {
    // the state in the surface's frame before the intersection; the split
    // mode's entry z (local to the previous vertex)
    float xl, yl, zl, Ll, Ml, Nl, zp;
    // intersection (tq: the conic root's correction, 0 where it failed)
    float t0, x0, y0, a, bh, cc, sq, q, ag, qg, t_far, t_near, tq, t;
    bool ok, near;
    // the asphere's live Newton step: root estimate, point, residual, raw
    // and guarded slope, sag gradient there
    float t_it, xx, yy, f, dd, dg, ngx, ngy;
    // absorption factor; the position after propagation (local frame); the
    // aperture mask; the intensity before the coating
    float e, x2, y2, z2, mask, inten_pc;
    // the split mode's deviation: |N|, 1 + |N|, (1 - |N|) and its ratio to
    // |N|; the sag refresh's argument and root
    float nabs, den, onem, ratio, arg_z, sq_z;
    // refraction
    float u, root_r, w;
    bool ok_r;
    // normal (conic or asphere slope)
    float r2, arg, sr, inv_root, dfdx, dfdy, sn, inv_n, nx, ny, nz, dot;
    // the directions after the interaction (local frame)
    float Lo, Mo, No;
};

// ---- even/odd asphere sag and gradient (_asphere_sag_grad) ----------------
struct Sag {
    float s, gx, gy;
};

// s = r^2 ri / (1 + sqrt(arg)) + sum_i C_i term_i, with arg = 1 - (1 + k) ri^2
// r^2 clamped to eps (not replaced by 1 as in the conic normal); term_i =
// r^(2(i+1)) (even) or r^(i+1) with r = sqrt(max(r^2, 1e-24)) (odd).
__device__ __forceinline__ Sag asphere_sag_grad(float ri, float conic,
                                                const float* ac, int nu,
                                                bool odd, float xx, float yy) {
    const float r2 = add(mul(xx, xx), mul(yy, yy));
    const float arg = sub(1.0f, mul(mul(mul(add(1.0f, conic), ri), ri), r2));
    const float sq = sqt(arg > EPS_GUARD ? arg : EPS_GUARD);
    Sag o;
    o.s = dvd(mul(r2, ri), add(1.0f, sq));
    const float inv_sq = dvd(1.0f, sq);
    o.gx = mul(mul(xx, ri), inv_sq);
    o.gy = mul(mul(yy, ri), inv_sq);
    float step, term, gterm;
    if (odd) {
        step = sqt(fmaxf(r2, ODD_R2_MIN));
        term = step;
        gterm = dvd(1.0f, step);
    } else {
        step = r2;
        term = r2;
        gterm = 1.0f;
    }
    for (int i = 0; i < nu; ++i) {
        const float c = ac[i];
        const float kk = odd ? (float)(i + 1) : 2.0f * (float)(i + 1);
        o.s = add(o.s, mul(c, term));
        o.gx = add(o.gx, mul(mul(mul(kk, xx), c), gterm));
        o.gy = add(o.gy, mul(mul(mul(kk, yy), c), gterm));
        term = mul(term, step);
        gterm = mul(gterm, step);
    }
    return o;
}

// ---- the freeform sags of (c) (_freeform_sag_grad) -------------------------
// Each returns (s, ds/dx, ds/dy) at (xx, yy) in the plain version's order
// (kernels/gen_trace.py::_sag_grad). c is the surface's constant row.

// the conic base of the freeform sags (_conic_base)
__device__ __forceinline__ Sag conic_base(float ri, float conic, float xx,
                                          float yy) {
    return asphere_sag_grad(ri, conic, nullptr, 0, false, xx, yy);
}

// a 1-D conic section's sag and slope in curvature form (_axis_conic)
__device__ __forceinline__ void axis_conic(float cv, float k, float v,
                                           float& s, float& g) {
    const float arg = sub(1.0f, mul(mul(mul(mul(add(1.0f, k), cv), cv), v), v));
    const float sq = sqt(arg > EPS_GUARD ? arg : EPS_GUARD);
    s = dvd(mul(mul(cv, v), v), add(1.0f, sq));
    g = dvd(mul(cv, v), sq);
}

// conic + sum_ij C[i][j] x^i y^j
__device__ __forceinline__ Sag poly_sag_grad(const float* c, const float* ac,
                                             int nu, int nv, float xx,
                                             float yy) {
    Sag o = conic_base(c[0], c[1], xx, yy);
    float xi = 1.0f, xim1 = 0.0f;              // x^i, x^(i-1)
    for (int i = 0; i < nu; ++i) {
        float yj = 1.0f, yjm1 = 0.0f;
        for (int j = 0; j < nv; ++j) {
            const float cij = ac[i * nv + j];
            o.s = add(o.s, mul(mul(cij, xi), yj));
            if (i > 0) o.gx = add(o.gx, mul(mul(mul((float)i, cij), xim1), yj));
            if (j > 0) o.gy = add(o.gy, mul(mul(mul((float)j, cij), xi), yjm1));
            yjm1 = yj;
            yj = mul(yj, yy);
        }
        xim1 = xi;
        xi = mul(xi, xx);
    }
    return o;
}

// T_k(w) and T'_k(w) = k U_{k-1}(w), k = 0, 1, ... by the recurrences
// T_k = 2w T_{k-1} - T_{k-2}, U_k = 2w U_{k-1} - U_{k-2} (_cheb_tu)
struct Cheb {
    float w, w2, t_prev, t, u_prev, u, dt;
    int k;
    __device__ __forceinline__ void start(float w_) {
        w = w_;
        w2 = mul(2.0f, w_);
        k = 0;
        t_prev = 0.0f;
        t = 1.0f;
        u_prev = 0.0f;
        u = 1.0f;                              // U_0
        dt = 0.0f;
    }
    __device__ __forceinline__ void next() {
        ++k;
        const float tn = k == 1 ? w : sub(mul(w2, t), t_prev);
        t_prev = t;
        t = tn;
        if (k >= 2) {                          // u = U_{k-1}
            const float un = k == 2 ? w2 : sub(mul(w2, u), u_prev);
            u_prev = u;
            u = un;
        }
        dt = mul((float)k, u);
    }
};

// conic + sum_ij C[i][j] T_i(x / c24) T_j(y / c25); the slope is T' at the
// normalized coordinate without the 1/norm factor (the reference's quirk)
__device__ __forceinline__ Sag cheb_sag_grad(const float* c, const float* ac,
                                             int nu, int nv, float xx,
                                             float yy) {
    Sag o = conic_base(c[0], c[1], xx, yy);
    Cheb tx;
    tx.start(dvd(xx, c[24]));
    const float v = dvd(yy, c[25]);
    for (int i = 0; i < nu; ++i) {
        if (i > 0) tx.next();
        Cheb ty;
        ty.start(v);
        for (int j = 0; j < nv; ++j) {
            if (j > 0) ty.next();
            const float cij = ac[i * nv + j];
            o.s = add(o.s, mul(mul(cij, tx.t), ty.t));
            if (i > 0) o.gx = add(o.gx, mul(mul(cij, tx.dt), ty.t));
            if (j > 0) o.gy = add(o.gy, mul(mul(cij, tx.t), ty.dt));
        }
    }
    return o;
}

// separate x (curvature c24, conic c25) and y (c0, c1) conic sections
__device__ __forceinline__ Sag biconic_sag_grad(const float* c, float xx,
                                                float yy) {
    Sag o;
    float sy, sx;
    axis_conic(c[0], c[1], yy, sy, o.gy);
    axis_conic(c[24], c[25], xx, sx, o.gx);
    o.s = add(sx, sy);
    return o;
}

// a y-z conic plus sum_i C_i y^(2(i+1)), swept about x with the radius c24;
// at an infinite radius (inf) the cylinder of the y-z curve
__device__ __forceinline__ Sag toroidal_sag_grad(const float* c,
                                                 const float* ac, int nu,
                                                 bool inf, float xx,
                                                 float yy) {
    float zy, dzy;
    axis_conic(c[0], c[1], yy, zy, dzy);
    const float y2 = mul(yy, yy);
    float term = y2, dterm = yy;
    for (int i = 0; i < nu; ++i) {
        const float ci = ac[i];
        zy = add(zy, mul(ci, term));
        dzy = add(dzy, mul(mul(2.0f * (float)(i + 1), ci), dterm));
        term = mul(term, y2);
        dterm = mul(dterm, y2);
    }
    Sag o;
    if (inf) {
        o.s = zy;
        o.gx = 0.0f;
        o.gy = dzy;
        return o;
    }
    const float R = c[24];
    const float dz = sub(R, zy);
    const float inside = sub(mul(dz, dz), mul(xx, xx));
    const bool ok = inside > EPS_GUARD;
    const float root = sqt(ok ? inside : EPS_GUARD);
    o.s = dz >= 0.0f ? sub(R, root) : add(R, root);   // R - sign(dz) root
    const float sgn_r = R >= 0.0f ? 1.0f : -1.0f;
    const float inv_root = dvd(1.0f, root);
    o.gx = ok ? mul(mul(sgn_r, xx), inv_root) : 0.0f;
    o.gy = ok ? mul(mul(mul(sgn_r, dz), dzy), inv_root) : 0.0f;
    return o;
}

// conic + sum_j c_j norm_j R_j(rho) A_j(phi), rho = r / c24: the radial
// polynomials in ascending powers, cos/sin of m phi by the multiple-angle
// recurrence on (x, y) / r; zt is the basis's term table
__device__ __forceinline__ Sag zernike_sag_grad(const float* c,
                                                const float* ac, int nu,
                                                const float* zt, float xx,
                                                float yy) {
    Sag o = conic_base(c[0], c[1], xx, yy);
    if (nu == 0) return o;
    const float nr = c[24];
    const float r = sqt(add(mul(xx, xx), mul(yy, yy)));
    const float r_safe = fmaxf(r, 1e-12f);
    const float rho = dvd(r, nr);
    const float cost = dvd(xx, r_safe), sint = dvd(yy, r_safe);
    const float cost2 = mul(2.0f, cost);
    float dz_drho = 0.0f, dz_dphi = 0.0f;
    for (int j = 0; j < nu; ++j) {
        const float* t = zt + j * ZT_W;
        const int m = (int)t[1], nc = (int)t[3];
        float Rnm = 0.0f, dR = 0.0f;
        float pw = 1.0f, prev = 0.0f;          // rho^q, rho^(q - 1)
        int q = 0;
        for (int k = 0; k < nc; ++k) {
            const int p = (int)t[4 + 3 * k];
            while (q < p) {
                prev = pw;
                pw = mul(pw, rho);
                ++q;
            }
            Rnm = add(Rnm, mul(t[5 + 3 * k], pw));
            if (p > 0) dR = add(dR, mul(t[6 + 3 * k], prev));
        }
        const float cj = mul(ac[j], t[2]);
        if (m == 0) {
            o.s = add(o.s, mul(cj, Rnm));
            dz_drho = add(dz_drho, mul(cj, dR));
            continue;
        }
        const int mu = m > 0 ? m : -m;
        float c0 = 1.0f, c1 = cost, s0 = 0.0f, s1 = sint;
        for (int a = 2; a <= mu; ++a) {
            const float cn = sub(mul(cost2, c1), c0);
            const float sn = sub(mul(cost2, s1), s0);
            c0 = c1;
            c1 = cn;
            s0 = s1;
            s1 = sn;
        }
        const float ang = m > 0 ? c1 : s1;
        const float dang = m > 0 ? mul(-(float)m, s1) : mul((float)mu, c1);
        o.s = add(o.s, mul(mul(cj, Rnm), ang));
        dz_drho = add(dz_drho, mul(mul(cj, dR), ang));
        dz_dphi = add(dz_dphi, mul(mul(cj, Rnm), dang));
    }
    const float inv_rs = dvd(1.0f, r_safe);
    o.gx = sub(add(o.gx, dvd(mul(mul(dz_drho, xx), inv_rs), nr)),
               mul(mul(mul(dz_dphi, yy), inv_rs), inv_rs));
    o.gy = add(add(o.gy, dvd(mul(mul(dz_drho, yy), inv_rs), nr)),
               mul(mul(mul(dz_dphi, xx), inv_rs), inv_rs));
    return o;
}

// ---- the Forbes sags (_forbes_sigma, _qbfs_sag_grad, _q2d_sag_grad) -------
// On basis-changed coefficients (kernels/gen_trace.py::_forbes_coeff_vector),
// in the plain version's order (kernels/gen_trace.py::_qbfs_sag_grad,
// _q2d_sag_grad and geometry/forbes.py's Clenshaw sums). Each Clenshaw sum
// runs the value's and the usq derivative's recurrences in one backward
// pass over the terms (the derivative's step at n reads the value's at
// n + 1), which rounds every term as the two passes of the plain version do.

// the sigma^-1 projection factor and its rho derivative, in curvature form
__device__ __forceinline__ void forbes_sigma(float ri, float k, float r2,
                                             float rho, float& factor,
                                             float& deriv) {
    const float c2 = mul(ri, ri);
    const float num = sub(1.0f, mul(mul(k, c2), r2));
    const float den = sub(1.0f, mul(mul(add(k, 1.0f), c2), r2));
    const float nf = sqt(num > 0.0f ? num : 1e-12f);
    const float df = sqt(den > 0.0f ? den : 1e-12f);
    factor = dvd(nf, df);
    deriv = dvd(mul(c2, rho), mul(mul(mul(nf, df), df), df));
}

// sum_n bs_n P_n(us) and its derivative by us: the Clenshaw alphas
// al_i = bs_i + (2 - 4 us) al_{i+1} - al_{i+2}, read as 2 (al_0 + al_1)
__device__ __forceinline__ void qbfs_sum(const float* bs, int nu, float us,
                                         float& sm, float& dsm) {
    const float prefix = sub(2.0f, mul(4.0f, us));
    const int m = nu - 1;
    float a1 = 0.0f, a2 = 0.0f, d1 = 0.0f, d2 = 0.0f;  // at i + 1, i + 2
    for (int i = m; i >= 0; --i) {
        float al, ad;
        if (i == m) {
            al = add(bs[i], 0.0f);
            ad = 0.0f;
        } else if (i == m - 1) {
            al = add(bs[i], mul(prefix, a1));
            ad = mul(-4.0f, a1);
        } else {
            al = sub(add(bs[i], mul(prefix, a1)), a2);
            ad = i == m - 2 ? sub(mul(prefix, d1), mul(4.0f, a1))
                            : sub(sub(mul(prefix, d1), d2), mul(4.0f, a1));
        }
        a2 = a1;
        a1 = al;
        d2 = d1;
        d1 = ad;
    }
    if (nu > 1) {
        sm = mul(2.0f, add(a1, a2));
        dsm = mul(2.0f, add(d1, d2));
    } else {
        sm = mul(2.0f, a1);
        dsm = 0.0f;
    }
}

// one (m, cos or sin) group of a Q2D sag: the readout al_0 / 2 (less 2/5 al_3
// for m = 1 and more than 3 terms) of the alphas al_n = ds_n + (a_n + b_n
// usq) al_{n+1} - c_n al_{n+2} and of their usq derivative, with a_n, b_n,
// c_n = a(n, m), b(n, m), c(n + 1, m) from the structure rows ta, tb, tc
__device__ __forceinline__ void q2d_group(const float* ds, const float* ta,
                                          const float* tb, const float* tc,
                                          int ln, int m, float usq, float& s,
                                          float& sp) {
    const int nmax = ln - 1;
    float a1 = 0.0f, a2 = 0.0f, d1 = 0.0f, d2 = 0.0f, al3 = 0.0f, ad3 = 0.0f;
    for (int n = nmax; n >= 0; --n) {
        float al, ad;
        if (n == nmax) {
            al = add(ds[n], 0.0f);
            ad = 0.0f;
        } else {
            const float alpha = add(ta[n], mul(tb[n], usq));
            if (n == nmax - 1) {
                al = add(ds[n], mul(alpha, a1));
                ad = mul(tb[n], a1);
            } else {
                al = sub(add(ds[n], mul(alpha, a1)), mul(tc[n], a2));
                ad = sub(add(mul(tb[n], a1), mul(alpha, d1)), mul(tc[n], d2));
            }
        }
        if (n == 3) {
            al3 = al;
            ad3 = ad;
        }
        a2 = a1;
        a1 = al;
        d2 = d1;
        d1 = ad;
    }
    s = mul(0.5f, a1);
    sp = mul(0.5f, d1);
    if (m == 1 && nmax > 2) {
        s = sub(s, mul(0.4f, al3));
        sp = sub(sp, mul(0.4f, ad3));
    }
}

// conic + u^2 (1 - u^2) sigma^-1 sum_n bs_n P_n(u^2), u = r / c24: the sag's
// sum at r^2 / c24^2, the slope's at u^2 with u = sqrt(r^2 + 1e-12) / c24,
// zero departure beyond u = 1
__device__ __forceinline__ Sag qbfs_sag_grad(const float* c, const float* ac,
                                             int nu, float xx, float yy) {
    Sag o = conic_base(c[0], c[1], xx, yy);
    if (nu == 0) return o;
    const float nr = c[24];
    const float r2 = add(mul(xx, xx), mul(yy, yy));
    const float rho = sqt(add(r2, 1e-12f));
    const float u = dvd(rho, nr);
    const float usq_s = dvd(r2, mul(nr, nr));
    const float usq = mul(u, u);
    float poly_s, unused;
    qbfs_sum(ac, nu, usq_s, poly_s, unused);
    float factor, dfac;
    forbes_sigma(c[0], c[1], r2, rho, factor, dfac);
    const float dep = mul(mul(mul(usq_s, sub(1.0f, usq_s)), factor), poly_s);
    o.s = add(o.s, usq_s > 1.0f ? 0.0f : dep);
    float poly_g, dpoly;
    qbfs_sum(ac, nu, usq, poly_g, dpoly);
    const float ds_du = mul(mul(dpoly, 2.0f), u);
    const float dpref = dvd(sub(mul(2.0f, u), mul(mul(4.0f, u), usq)), nr);
    const float dpoly_drho = dvd(ds_du, nr);
    const float B = sub(usq, mul(usq, usq));
    float dS = add(add(mul(mul(dpref, factor), poly_g), mul(mul(B, dfac), poly_g)),
                   mul(mul(B, factor), dpoly_drho));
    dS = u >= 1.0f ? 0.0f : dS;
    const float inv_rho = dvd(1.0f, rho);
    o.gx = add(o.gx, mul(mul(dS, xx), inv_rho));
    o.gy = add(o.gy, mul(mul(dS, yy), inv_rho));
    return o;
}

// The Q2D sag: conic + sigma^-1 [u^2 (1 - u^2) S_0(u^2) + sum_m u^m (cos m t
// S_m^a(u^2) + sin m t S_m^b(u^2))]. ac holds the nu basis-changed
// coefficients, then Q2D_ROWS rows of nu: each coefficient's group code (0
// rotational, 2 m cosine, 2 m + 1 sine), a(n, m), b(n, m), c(n + 1, m).
// cos and sin of m t by the multiple-angle recurrence on (x, y) / r, t = 0
// at the vertex.
__device__ __forceinline__ Sag q2d_sag_grad(const float* c, const float* ac,
                                            int nu, float xx, float yy) {
    Sag o = conic_base(c[0], c[1], xx, yy);
    const float* code = ac + nu;
    const float* ta = ac + 2 * nu;
    const float* tb = ac + 3 * nu;
    const float* tc = ac + 4 * nu;
    const float nr = c[24];
    const float r2 = add(mul(xx, xx), mul(yy, yy));
    const float rho = sqt(add(r2, 1e-12f));
    const float u = dvd(rho, nr);
    const float usq = mul(u, u);
    const bool ok = r2 > 0.0f;
    const float rho2 = sqt(ok ? r2 : 1.0f);
    const float cost = ok ? dvd(xx, rho2) : 1.0f;
    const float sint = ok ? dvd(yy, rho2) : 0.0f;
    const float cost2 = mul(2.0f, cost);
    int n_m0 = 0;
    while (n_m0 < nu && code[n_m0] == 0.0f) ++n_m0;
    float s_m0 = 0.0f, d_m0_du = 0.0f;
    if (n_m0) {
        float ds_dusq;
        qbfs_sum(ac, n_m0, usq, s_m0, ds_dusq);
        d_m0_du = mul(mul(ds_dusq, 2.0f), u);
    }
    const int max_m = nu > n_m0 ? (int)code[nu - 1] / 2 : 0;
    float poly = 0.0f, dr = 0.0f, dt = 0.0f;
    float c0 = 1.0f, c1 = cost, s0 = 0.0f, s1 = sint;  // cos, sin of (m-1) t, m t
    float upm1 = 1.0f, upm = mul(1.0f, u);             // u^(m - 1), u^m
    int off = n_m0;
    for (int m = 1; m <= max_m; ++m) {
        if (m >= 2) {
            const float cn = sub(mul(cost2, c1), c0);
            const float sn = sub(mul(cost2, s1), s0);
            c0 = c1;
            c1 = cn;
            s0 = s1;
            s1 = sn;
            upm1 = upm;
            upm = mul(upm, u);
        }
        float sv[2] = {0.0f, 0.0f}, spv[2] = {0.0f, 0.0f};
        for (int b = 0; b < 2; ++b) {
            int ln = 0;
            while (off + ln < nu && (int)code[off + ln] == 2 * m + b) ++ln;
            if (!ln) continue;
            q2d_group(ac + off, ta + off, tb + off, tc + off, ln, m, usq, sv[b],
                      spv[b]);
            off += ln;
        }
        const float fm = (float)m, usq2 = mul(2.0f, usq);
        poly = add(poly, mul(upm, add(mul(c1, sv[0]), mul(s1, sv[1]))));
        const float aterm = mul(c1, add(mul(usq2, spv[0]), mul(fm, sv[0])));
        const float bterm = mul(s1, add(mul(usq2, spv[1]), mul(fm, sv[1])));
        dr = add(dr, mul(upm1, add(aterm, bterm)));
        dt = add(dt, mul(mul(fm, upm), add(mul(-sv[0], s1), mul(sv[1], c1))));
    }
    float factor, dfac;
    forbes_sigma(c[0], c[1], r2, rho, factor, dfac);
    const float B = sub(usq, mul(usq, usq));
    const float dep = add(mul(mul(mul(usq, sub(1.0f, usq)), factor), s_m0),
                          mul(factor, poly));
    o.s = add(o.s, u > 1.0f ? 0.0f : dep);
    const float dpref = dvd(sub(mul(2.0f, u), mul(mul(4.0f, u), usq)), nr);
    const float dpoly_drho = dvd(d_m0_du, nr);
    const float dS0 = add(add(mul(mul(dpref, factor), s_m0), mul(mul(B, dfac), s_m0)),
                          mul(mul(B, factor), dpoly_drho));
    const float dSg = add(mul(dfac, poly), dvd(mul(factor, dr), nr));
    const float dSr = u >= 1.0f ? 0.0f : add(dS0, dSg);
    const float dSt = u >= 1.0f ? 0.0f : mul(factor, dt);
    const float inv_rho = dvd(1.0f, rho);
    o.gx = sub(add(o.gx, mul(mul(dSr, xx), inv_rho)),
               mul(mul(mul(dSt, yy), inv_rho), inv_rho));
    o.gy = add(add(o.gy, mul(mul(dSr, yy), inv_rho)),
               mul(mul(mul(dSt, xx), inv_rho), inv_rho));
    return o;
}

// The Newton sags' dispatch: the WIDE variant compiles the even/odd asphere
// only, the FREEFORM variant every kind but the Forbes sags, the FORBES
// variant every kind.
template <int VAR>
__device__ __forceinline__ Sag sag_grad(int gk, int fl, const float* c,
                                        const float* ac, const float* ztab,
                                        float xx, float yy) {
    const int nu = nu_of(fl);
    if (VAR < VAR_FREEFORM || gk == GK_EVEN || gk == GK_ODD)
        return asphere_sag_grad(c[0], c[1], ac, nu, gk == GK_ODD, xx, yy);
    if constexpr (VAR == VAR_FORBES) {
        if (gk == GK_QBFS) return qbfs_sag_grad(c, ac, nu, xx, yy);
        if (gk == GK_Q2D) return q2d_sag_grad(c, ac, nu, xx, yy);
    }
    if (gk == GK_POLY) return poly_sag_grad(c, ac, nu, nv_of(fl), xx, yy);
    if (gk == GK_CHEB) return cheb_sag_grad(c, ac, nu, nv_of(fl), xx, yy);
    if (gk == GK_BICONIC) return biconic_sag_grad(c, xx, yy);
    if (gk == GK_TORUS || gk == GK_TORUS_INF)
        return toroidal_sag_grad(c, ac, nu, gk == GK_TORUS_INF, xx, yy);
    return zernike_sag_grad(c, ac, nu,
                            ztab + (size_t)basis_of(fl) * MAX_TERMS * ZT_W,
                            xx, yy);
}

// the designed Fresnel facet's slopes m (x, y) / r, m = -(r / hyp) /
// (n_design - f / hyp), hyp = sqrt(r^2 + f^2) (pallas_trace.py:1672-1688)
__device__ __forceinline__ void designed_slope(const float* c, float x,
                                               float y, float& dfdx,
                                               float& dfdy) {
    const float r2 = add(mul(x, x), mul(y, y));
    const float r = sqt(r2);
    const float r_safe = fmaxf(r, 1e-12f);
    const float f = c[24];
    const float hyp = sqt(add(r2, mul(f, f)));
    const float m = dvd(-dvd(r, hyp), sub(c[25], dvd(f, hyp)));
    dfdx = dvd(mul(m, x), r_safe);
    dfdy = dvd(mul(m, y), r_safe);
}

// ---- the compensated update of (opd, opd_c) by v -------------------------
// Three separate roundings: an FMA or a reassociation would delete the
// compensation, and the explicit intrinsics forbid both.
__device__ __forceinline__ void kahan_add(RayState& s, float v) {
    const float yk = sub(v, s.opd_c);
    const float tk = add(s.opd, yk);
    s.opd_c = sub(sub(tk, s.opd), yk);
    s.opd = tk;
}

// ---- the apodization weight of the launch (gen columns 11-15) -------------
// The closed-form profiles of system/apodization.py, in the plain version's
// order (kernels/gen_trace.py::apod_weight), with r = sqrt(Px^2 + Py^2):
// Gaussian exp(-(Px^2 + Py^2) / p0); cosine squared cos(pi r / p0)^2 for
// r < p1; Hann (1 - cos(2 pi r / p0)) / 2 for r < p1; Tukey 1 for r <= p0,
// (1 + cos(pi (r - p0) / p1)) / 2 up to r <= p2; super-Gaussian
// exp(-(r / p0)^p1); polynomial (1 - (r / p0)^2)^p1 for r < p0; 0 outside
// each support. expf, cosf and powf are not correctly rounded, so the
// intensity differs from the plain version's by a few ulps (PERF.md); no
// position, direction or OPD reads it.
#define PI_F 3.14159274101257324f      // float32 pi, as pi * r rounds it
#define TWO_PI_F 6.28318548202514648f
enum { APOD_NONE = 0, APOD_UNIFORM = 1, APOD_GAUSSIAN = 2, APOD_COSSQ = 3,
       APOD_HANN = 4, APOD_TUKEY = 5, APOD_SUPERGAUSS = 6, APOD_POLY = 7 };

__device__ __forceinline__ float apod_weight(const float* g, float Px,
                                             float Py) {
    const int code = (int)g[11];
    if (code <= APOD_UNIFORM) return 1.0f;
    const float s2 = add(mul(Px, Px), mul(Py, Py));
    if (code == APOD_GAUSSIAN) return expf(dvd(-s2, g[12]));
    const float r = sqt(s2);
    if (code == APOD_COSSQ) {
        const float c = cosf(dvd(mul(PI_F, r), g[12]));
        return r < g[13] ? mul(c, c) : 0.0f;
    }
    if (code == APOD_HANN) {
        const float w = mul(0.5f, sub(1.0f, cosf(dvd(mul(TWO_PI_F, r), g[12]))));
        return r < g[13] ? w : 0.0f;
    }
    if (code == APOD_TUKEY) {
        if (!(r <= g[14])) return 0.0f;
        if (r <= g[12]) return 1.0f;
        return mul(0.5f, add(1.0f, cosf(dvd(mul(PI_F, sub(r, g[12])), g[13]))));
    }
    if (code == APOD_SUPERGAUSS) return expf(-powf(dvd(r, g[12]), g[13]));
    if (code == APOD_POLY) {
        const float q = dvd(r, g[12]);
        return r < g[12] ? powf(sub(1.0f, mul(q, q)), g[13]) : 0.0f;
    }
    return __int_as_float(0x7fc00000);         // no such profile
}

// ---- the polarization chain (sub-slice (e)) ---------------------------------
// A polarized launch carries n_ev (1 or 2) real E-vectors per ray
// (pallas_trace.py::_polar_layout :1922, _polar_init :796-828): a linear
// state one, a complex state its real and imaginary projections, the
// unpolarized average the two linear states at scale 0.5. Each is a s + b p
// in the launch basis p = k x (1, 0, 0) / |.|, s = p x k, scaled by sqrt(w)
// under an apodization weight w. Each surface's refract/reflect step
// updates them by its rank-structured Jones matrix (_polar_update :686),
//   E' = js (s.E) s + jp (p0.E) p1 + j3 (k0.E) k1,
// with s ~ k0 x n (n the normal; (-M0, L0, 0) on a plane), p0 = k0 x s,
// p1 = k1 x s, and s = k0 x (1, 0, 0) below |s|^2 = 1e-12; (js, jp, j3) a
// Fresnel coating's real s/p coefficients (_fresnel_diag :773; (js, -jp,
// -1) on a mirror), else 1. A bare refracting surface takes the rotation
// about u = k0 x k1 instead (Rodrigues with u unnormalized: no root, no
// fallback). k0 and k1 are the local directions before and after the
// interaction: the vectors are not rotated by localize or globalize (the
// reference's frame mixing, kept). The final intensity is scale x the sum
// of the squared norms, in place of the traced one (aperture, coatings and
// absorption included; lost rays still end NaN). The launch's numbers are
// a kernel argument, uniform over the launch: a linear state's second
// vector is skipped by a branch no warp diverges on.
struct PolLaunch {
    int nev;            // 1 or 2
    float scale;        // 1, or 0.5 for the unpolarized average
    float a[2], b[2];   // each vector's s and p amplitudes
};

struct PolState {
    float e[2][3];
    int nev;
};

// The launch state from the host array [n_ev, scale, a0, b0, a1, b1] (null:
// unpolarized, n_ev 0); false for an n_ev that is not 1 or 2.
static inline bool polar_launch_of(const float* polar, PolLaunch& pl) {
    pl = {0, 1.0f, {0.0f, 0.0f}, {0.0f, 0.0f}};
    if (polar == nullptr) return true;
    pl = {(int)polar[0], polar[1], {polar[2], polar[4]}, {polar[3], polar[5]}};
    return pl.nev == 1 || pl.nev == 2;
}

#define POL_FALLBACK 1e-12f

// One surface's Jones update and the intermediates K2's adjoint reads.
struct PolSurf {
    bool rod;                       // the Rodrigues form
    float ux, uy, uz, ct, inv1c;
    float sx0, sy0, sz0, mag2;      // s before the fallback, |s|^2
    bool fb;                        // the fallback taken
    float mag2f, sq, inv;           // |s|^2 after it, the guarded root, 1/root
    float sx, sy, sz, p0x, p0y, p0z, p1x, p1y, p1z;
    bool fres;                      // a Fresnel coating's coefficients
    float js, jp, j3;
    float n, rad, root, n2c, da, db, finv;
};

// _fresnel_diag: the clamp rad > eps, one shared reciprocal
__device__ __forceinline__ void fresnel_diag(PolSurf& b, float n1, float n2,
                                             float cos_i, bool refl) {
    b.n = dvd(n2, n1);
    const float sin2 = sub(1.0f, mul(cos_i, cos_i));
    b.rad = sub(mul(b.n, b.n), sin2);
    b.root = sqt(b.rad > EPS_GUARD ? b.rad : EPS_GUARD);
    b.n2c = mul(mul(b.n, b.n), cos_i);
    b.da = add(cos_i, b.root);
    b.db = add(b.n2c, b.root);
    b.finv = dvd(1.0f, mul(b.da, b.db));
    if (refl) {
        b.js = mul(mul(sub(cos_i, b.root), b.db), b.finv);
        b.jp = -mul(mul(sub(b.n2c, b.root), b.da), b.finv);
        b.j3 = -1.0f;
    } else {
        b.js = mul(mul(mul(2.0f, cos_i), b.db), b.finv);
        b.jp = mul(mul(mul(mul(2.0f, b.n), cos_i), b.da), b.finv);
        b.j3 = 1.0f;
    }
}

// The basis of a surface's update from k0 = (L0, M0, N0), k1 = (L1, M1, N1),
// the normal (read unless ``plane``) and cos_i (read by a Fresnel coating).
__device__ __forceinline__ void polar_surface(PolSurf& b, int fl, float n1,
                                              float n2, bool plane,
                                              float cos_i, float L0, float M0,
                                              float N0, float L1, float M1,
                                              float N1, float nx, float ny,
                                              float nz) {
    const bool refl = (fl & FLAG_REFL) != 0;
    b.fres = (fl & FLAG_FRESNEL) != 0;
    b.rod = !b.fres && !refl;
    if (b.rod) {
        b.ux = sub(mul(M0, N1), mul(N0, M1));
        b.uy = sub(mul(N0, L1), mul(L0, N1));
        b.uz = sub(mul(L0, M1), mul(M0, L1));
        b.ct = add(add(mul(L0, L1), mul(M0, M1)), mul(N0, N1));
        b.inv1c = dvd(1.0f, add(1.0f, b.ct));
        return;
    }
    if (plane) {
        b.sx0 = -M0;
        b.sy0 = L0;
        b.sz0 = 0.0f;
        b.mag2 = add(mul(L0, L0), mul(M0, M0));
    } else {
        b.sx0 = sub(mul(M0, nz), mul(N0, ny));
        b.sy0 = sub(mul(N0, nx), mul(L0, nz));
        b.sz0 = sub(mul(L0, ny), mul(M0, nx));
        b.mag2 = add(add(mul(b.sx0, b.sx0), mul(b.sy0, b.sy0)),
                     mul(b.sz0, b.sz0));
    }
    b.fb = b.mag2 < POL_FALLBACK;
    const float sx = b.fb ? 0.0f : b.sx0;
    const float sy = b.fb ? N0 : b.sy0;
    const float sz = b.fb ? -M0 : b.sz0;
    b.mag2f = b.fb ? add(mul(N0, N0), mul(M0, M0)) : b.mag2;
    b.sq = sqt(b.mag2f > 0.0f ? b.mag2f : 1.0f);
    b.inv = dvd(1.0f, b.sq);
    b.sx = mul(sx, b.inv);
    b.sy = mul(sy, b.inv);
    b.sz = mul(sz, b.inv);
    b.p0x = sub(mul(M0, b.sz), mul(N0, b.sy));
    b.p0y = sub(mul(N0, b.sx), mul(L0, b.sz));
    b.p0z = sub(mul(L0, b.sy), mul(M0, b.sx));
    b.p1x = sub(mul(M1, b.sz), mul(N1, b.sy));
    b.p1y = sub(mul(N1, b.sx), mul(L1, b.sz));
    b.p1z = sub(mul(L1, b.sy), mul(M1, b.sx));
    if (b.fres) fresnel_diag(b, n1, n2, cos_i, refl);
}

// E <- the surface's update of E
__device__ __forceinline__ void polar_apply(const PolSurf& b, float L0,
                                            float M0, float N0, float L1,
                                            float M1, float N1, float* e) {
    const float ex = e[0], ey = e[1], ez = e[2];
    if (b.rod) {
        const float ue = mul(add(add(mul(b.ux, ex), mul(b.uy, ey)),
                                 mul(b.uz, ez)), b.inv1c);
        e[0] = add(add(mul(b.ct, ex), sub(mul(b.uy, ez), mul(b.uz, ey))),
                   mul(b.ux, ue));
        e[1] = add(add(mul(b.ct, ey), sub(mul(b.uz, ex), mul(b.ux, ez))),
                   mul(b.uy, ue));
        e[2] = add(add(mul(b.ct, ez), sub(mul(b.ux, ey), mul(b.uy, ex))),
                   mul(b.uz, ue));
        return;
    }
    float ds = add(add(mul(b.sx, ex), mul(b.sy, ey)), mul(b.sz, ez));
    float dp = add(add(mul(b.p0x, ex), mul(b.p0y, ey)), mul(b.p0z, ez));
    float dk = add(add(mul(L0, ex), mul(M0, ey)), mul(N0, ez));
    if (b.fres) {
        ds = mul(b.js, ds);
        dp = mul(b.jp, dp);
        dk = mul(b.j3, dk);
    }
    e[0] = add(add(mul(ds, b.sx), mul(dp, b.p1x)), mul(dk, L1));
    e[1] = add(add(mul(ds, b.sy), mul(dp, b.p1y)), mul(dk, M1));
    e[2] = add(add(mul(ds, b.sz), mul(dp, b.p1z)), mul(dk, N1));
}

// The launch vectors from the launch direction (L, M, N) and the weight w
// (the launch intensity; scaled by sqrt(w) under an apodization, gen column
// 11 above APOD_UNIFORM: the double where at w = 0).
__device__ __forceinline__ void polar_init(const float* g, float L, float M,
                                           float N, float w,
                                           const PolLaunch& pl, PolState& ps) {
    const float pyv0 = N, pzv0 = -M;
    const float m2 = add(mul(pyv0, pyv0), mul(pzv0, pzv0));
    const float inv = dvd(1.0f, sqt(m2 > 0.0f ? m2 : 1.0f));
    const float pxv = mul(0.0f, inv), pyv = mul(pyv0, inv), pzv = mul(pzv0, inv);
    const float sxv = sub(mul(pyv, N), mul(pzv, M));
    const float syv = sub(mul(pzv, L), mul(pxv, N));
    const float szv = sub(mul(pxv, M), mul(pyv, L));
    const bool apod = (int)g[11] > 1;           // above APOD_UNIFORM
    const float sa = w > 0.0f ? sqt(w) : 0.0f;
    ps.nev = pl.nev;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
        if (v >= pl.nev) break;
        const float a = pl.a[v], b = pl.b[v];
        ps.e[v][0] = add(mul(a, sxv), mul(b, pxv));
        ps.e[v][1] = add(mul(a, syv), mul(b, pyv));
        ps.e[v][2] = add(mul(a, szv), mul(b, pzv));
        if (apod) {
            ps.e[v][0] = mul(ps.e[v][0], sa);
            ps.e[v][1] = mul(ps.e[v][1], sa);
            ps.e[v][2] = mul(ps.e[v][2], sa);
        }
    }
}

// scale x sum |E|^2 (_polar_intensity)
__device__ __forceinline__ float polar_intensity(const PolState& ps,
                                                 float scale) {
    float total = 0.0f;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
        if (v >= ps.nev) break;
        const float sq = add(add(mul(ps.e[v][0], ps.e[v][0]),
                                 mul(ps.e[v][1], ps.e[v][1])),
                             mul(ps.e[v][2], ps.e[v][2]));
        total = v == 0 ? sq : add(total, sq);
    }
    return mul(total, scale);
}

// ---- the diffractive surfaces of (f) ---------------------------------------
// A grating or phase surface meets the ray as its conic or plane substrate
// does; at the landed point (x, y) it computes the substrate's slope and
// unit normal (the conic's, as the refracting surface's; (0, 0, -1) on a
// plane), then
//   the grating: the groove tangent t = normalize(1, tan a, dfdx + tan a
//     dfdy) (tan a in column 25), the grating vector f = -normalize(n x
//     t), the strength g = c24 |f_xy| (c24 = m lambda / period); the normal
//     aligned along the ray, the tangential part of n1 k plus g f, and the
//     normal part rebuilt from |k_out| = n2 (negated, and the whole divided
//     by -n2, on a reflective grating); a ray with no propagating order
//     (disc < 0) is lost;
//   the phase update: the profile's phase and gradient (constant c24;
//     radial sum_i a_i r^(2(i+1)) from the acoef row; linear c24 x + c25
//     y), the Plane class's +z normal, the surface-projected gradient G =
//     pg - (pg.n) n, k0 = 2 pi / c7, the tangential part of n1 k0 k plus G
//     and the normal part rebuilt from n2 k0 (negated on a mirror); an
//     evanescent order (R^2 < 0) gets intensity 0 and stays valid; the OPD
//     shifts by -phase / k0 and the intensity scales by the efficiency
//     (column 29).
// Every operation in the plain version's order (kernels/gen_trace.py::
// _doe_plain). The intermediates are kept for K2, which recomputes them
// from the tape's landed point and incoming direction.
struct DoeTape {
    // the substrate's slope and unit normal
    float r2, arg, sr, inv_root, dfdx, dfdy, sn, inv_n, nx, ny, nz;
    // the grating: the groove tangent, the grating vector before and after
    // its normalization, its xy projection's root and the strength; the
    // aligned normal, n1 k, the tangential part, the normal part's root
    float ta, tz0, tsq, tinv, tgx, tgy, tgz, fx0, fy0, fz0, fsq, finv, fx,
          fy, fz, gsq, g;
    bool flip;
    float nxa, nya, nza, kx, ky, kz, kdn, tx2, ty2, tz2, disc, kn0, kn, den;
    bool ok;
    // the phase: the radial profile's r^2, r, d phi / dr and its ratio to
    // r, the profile's phase and gradient, (pg.n), G, k0, n1 k0, k_in,
    // (k_in.n), k_parallel, n2 k0, R^2, the normal part alpha
    float r2p, rp, d_dr, ratio, phase, pgx, pgy, gdn, Gx, Gy, Gz, k0, nk1,
          kix, kiy, kiz, pdn, kpx, kpy, kpz, nk, rsq, alpha;
    bool evan;
    // the new direction before its normalization, its norm's root and
    // inverse; the outputs: the direction, the intensity factor, the OPD
    // shift
    float ox, oy, oz, osq, oinv, Lo, Mo, No, mask, shift;
};

__device__ __forceinline__ void doe_forward(const float* c, const float* ac,
                                            int fl, float x, float y,
                                            float L, float M, float N,
                                            DoeTape& d) {
    const float n1 = c[3], n2 = c[4];
    const bool refl = (fl & FLAG_REFL) != 0;
    if (fl & FLAG_PLANE) {
        d.dfdx = 0.0f;
        d.dfdy = 0.0f;
        d.nx = 0.0f;
        d.ny = 0.0f;
        d.nz = -1.0f;
    } else {
        d.r2 = add(mul(x, x), mul(y, y));
        d.arg = sub(1.0f, mul(mul(mul(add(1.0f, c[1]), c[0]), c[0]), d.r2));
        d.sr = sqt(d.arg > EPS_GUARD ? d.arg : 1.0f);
        d.inv_root = dvd(1.0f, d.sr);
        d.dfdx = mul(mul(x, c[0]), d.inv_root);
        d.dfdy = mul(mul(y, c[0]), d.inv_root);
        d.sn = sqt(add(add(mul(d.dfdx, d.dfdx), mul(d.dfdy, d.dfdy)), 1.0f));
        d.inv_n = dvd(1.0f, d.sn);
        d.nx = mul(d.dfdx, d.inv_n);
        d.ny = mul(d.dfdy, d.inv_n);
        d.nz = -d.inv_n;
    }
    d.mask = 1.0f;
    d.shift = 0.0f;
    d.ok = true;
    if (inter_of(fl) == INTER_GRATING) {
        d.ta = c[25];
        d.tz0 = add(d.dfdx, mul(d.ta, d.dfdy));
        d.tsq = sqt(add(add(1.0f, mul(d.ta, d.ta)), mul(d.tz0, d.tz0)));
        d.tinv = dvd(1.0f, d.tsq);
        d.tgx = d.tinv;
        d.tgy = mul(d.ta, d.tinv);
        d.tgz = mul(d.tz0, d.tinv);
        d.fx0 = sub(mul(d.ny, d.tgz), mul(d.nz, d.tgy));
        d.fy0 = sub(mul(d.nz, d.tgx), mul(d.nx, d.tgz));
        d.fz0 = sub(mul(d.nx, d.tgy), mul(d.ny, d.tgx));
        d.fsq = sqt(add(add(mul(d.fx0, d.fx0), mul(d.fy0, d.fy0)),
                        mul(d.fz0, d.fz0)));
        d.finv = dvd(1.0f, d.fsq);
        d.fx = mul(-d.fx0, d.finv);
        d.fy = mul(-d.fy0, d.finv);
        d.fz = mul(-d.fz0, d.finv);
        d.gsq = sqt(add(mul(d.fx, d.fx), mul(d.fy, d.fy)));
        d.g = mul(c[24], d.gsq);
        // the normal along the ray, sign(0) := +1
        d.flip = add(add(mul(L, d.nx), mul(M, d.ny)), mul(N, d.nz)) >= 0.0f;
        d.nxa = d.flip ? d.nx : -d.nx;
        d.nya = d.flip ? d.ny : -d.ny;
        d.nza = d.flip ? d.nz : -d.nz;
        d.kx = mul(n1, L);
        d.ky = mul(n1, M);
        d.kz = mul(n1, N);
        d.kdn = add(add(mul(d.kx, d.nxa), mul(d.ky, d.nya)), mul(d.kz, d.nza));
        d.tx2 = add(sub(d.kx, mul(d.kdn, d.nxa)), mul(d.g, d.fx));
        d.ty2 = add(sub(d.ky, mul(d.kdn, d.nya)), mul(d.g, d.fy));
        d.tz2 = add(sub(d.kz, mul(d.kdn, d.nza)), mul(d.g, d.fz));
        d.disc = sub(mul(n2, n2), add(add(mul(d.tx2, d.tx2), mul(d.ty2, d.ty2)),
                                      mul(d.tz2, d.tz2)));
        d.ok = d.disc >= 0.0f;
        d.kn0 = sqt(d.ok ? d.disc : 1.0f);
        d.kn = refl ? -d.kn0 : d.kn0;
        d.den = refl ? -n2 : n2;
        d.ox = dvd(add(d.tx2, mul(d.kn, d.nxa)), d.den);
        d.oy = dvd(add(d.ty2, mul(d.kn, d.nya)), d.den);
        d.oz = dvd(add(d.tz2, mul(d.kn, d.nza)), d.den);
    } else {
        if (fl & FLAG_PLANE_CLS) {             // the Plane class: +z
            d.nx = 0.0f;
            d.ny = 0.0f;
            d.nz = 1.0f;
        }
        const int pk = phase_of(fl);
        if (pk == PH_CONSTANT) {
            d.phase = c[24];
            d.pgx = 0.0f;
            d.pgy = 0.0f;
        } else if (pk == PH_RADIAL) {
            d.r2p = add(mul(x, x), mul(y, y));
            d.rp = sqt(d.r2p);
            float phase = 0.0f, d_dr = 0.0f, term = d.r2p, rpow = d.rp;
            const int nu = nu_of(fl);
            for (int i = 0; i < nu; ++i) {
                const float ci = ac[i];
                phase = add(phase, mul(ci, term));
                d_dr = add(d_dr, mul(mul(ci, 2.0f * (float)(i + 1)), rpow));
                term = mul(term, d.r2p);
                rpow = mul(rpow, d.r2p);
            }
            d.phase = phase;
            d.d_dr = d_dr;
            d.ratio = dvd(d_dr, d.rp == 0.0f ? 1.0f : d.rp);
            d.pgx = mul(d.ratio, x);
            d.pgy = mul(d.ratio, y);
        } else {
            d.phase = add(mul(c[24], x), mul(c[25], y));
            d.pgx = c[24];
            d.pgy = c[25];
        }
        d.gdn = add(mul(d.pgx, d.nx), mul(d.pgy, d.ny));
        d.Gx = sub(d.pgx, mul(d.gdn, d.nx));
        d.Gy = sub(d.pgy, mul(d.gdn, d.ny));
        d.Gz = mul(-d.gdn, d.nz);
        d.k0 = dvd(TWO_PI_F, c[7]);
        d.nk1 = mul(n1, d.k0);
        d.kix = mul(d.nk1, L);
        d.kiy = mul(d.nk1, M);
        d.kiz = mul(d.nk1, N);
        d.pdn = add(add(mul(d.kix, d.nx), mul(d.kiy, d.ny)), mul(d.kiz, d.nz));
        d.kpx = add(sub(d.kix, mul(d.pdn, d.nx)), d.Gx);
        d.kpy = add(sub(d.kiy, mul(d.pdn, d.ny)), d.Gy);
        d.kpz = add(sub(d.kiz, mul(d.pdn, d.nz)), d.Gz);
        d.nk = mul(n2, d.k0);
        d.rsq = sub(mul(d.nk, d.nk), add(add(mul(d.kpx, d.kpx), mul(d.kpy, d.kpy)),
                                         mul(d.kpz, d.kpz)));
        d.evan = d.rsq < 0.0f;
        d.mask = d.evan ? 0.0f : 1.0f;
        // the double where: no root of a negative R^2
        const float alpha = d.evan ? 0.0f : sqt(fmaxf(d.rsq, 0.0f));
        d.alpha = refl ? -alpha : alpha;
        d.ox = add(d.kpx, mul(d.alpha, d.nx));
        d.oy = add(d.kpy, mul(d.alpha, d.ny));
        d.oz = add(d.kpz, mul(d.alpha, d.nz));
        d.shift = dvd(-d.phase, d.k0);
    }
    d.osq = sqt(add(add(mul(d.ox, d.ox), mul(d.oy, d.oy)), mul(d.oz, d.oz)));
    d.oinv = dvd(1.0f, d.osq);
    d.Lo = mul(d.ox, d.oinv);
    d.Mo = mul(d.oy, d.oinv);
    d.No = mul(d.oz, d.oinv);
}

// ---- prologue: launch by generalized aiming (_gen_prologue) -------------
// gen column 10 selects the object-space telecentric aim x1 = Px*B + x0
// (dxr = Px g8, dzr = g5, the constant axial distance); column 11 the
// apodization. Both are uniform over a launch, so no warp diverges on them.
template <int MODE>
__device__ __forceinline__ void gen_prologue(const float* g, float Px, float Py,
                                             RayState& s) {
    s.x = add(mul(Px, g[0]), g[2]);
    s.y = add(mul(Py, g[1]), g[3]);
    s.z = g[4];
    const bool tele = g[10] != 0.0f;
    const float dxr = tele ? mul(Px, g[8]) : sub(mul(Px, g[8]), s.x);
    const float dyr = tele ? mul(Py, g[9]) : sub(mul(Py, g[9]), s.y);
    const float dzr = tele ? g[5] : sub(g[5], s.z);
    const float inv_mag = rsq(add(add(mul(dxr, dxr), mul(dyr, dyr)), mul(dzr, dzr)));
    s.L = mul(dxr, inv_mag);
    s.M = mul(dyr, inv_mag);
    s.N = mul(dzr, inv_mag);
    s.inten = apod_weight(g, Px, Py);
    s.opd = 0.0f;
    s.opd_c = 0.0f;
    s.valid = true;
    // the split frame: z local to the launch plane (the aim used the true z)
    if (MODE == OPD_SPLIT) s.z = 0.0f;
}

// ---- one surface (_surface_step) -------------------------------------------
// c: the surface's constant row; ac: its sag coefficients (read only by WIDE
// and FREEFORM) or a radial phase profile's terms; ztab: the Zernike table
// (read only by FREEFORM); sigma: the propagation sign (read only by
// OPD_SPLIT); ps: a polarized launch's E-vectors (POL only; a grating or
// phase surface leaves them as they are).
template <int VAR, int MODE, bool POL = false>
__device__ __forceinline__ void surface_step(const float* c, const float* ac,
                                             const float* ztab, int fl,
                                             float sigma, RayState& s,
                                             SurfTape& tp,
                                             PolState* ps = nullptr) {
    constexpr bool WIDE = VAR != VAR_NARROW;
    constexpr bool FF = VAR >= VAR_FREEFORM;
    const float ri = c[0], conic = c[1], pos_z = c[2];
    const float n1 = c[3], n2 = c[4], alpha = c[5];
    const bool cs = WIDE && (fl & FLAG_CS);
    const int gk = WIDE ? gkind_of(fl) : GK_CONIC;
    // the thin Fresnel surfaces meet the ray at their base plane
    const bool fresnel = FF && (gk == GK_FZONE || gk == GK_FDESIGNED);
    const bool newton = gk != GK_CONIC && !fresnel;
    // the zoned Fresnel refracts with its parent conic's slope
    const bool conic_like = gk == GK_CONIC || (FF && gk == GK_FZONE);
#if WITH_DOE
    // a grating or phase surface (sub-slice (f)): WIDE and up; a source
    // without (f) leaves out its lines (gen_grad.cu)
    const bool doe = WIDE && inter_of(fl) != INTER_NONE;
#endif
    float x = s.x, y = s.y, z;
    float L = s.L, M = s.M, N = s.N;

    // localize: v_local = R^T (v - t); otherwise shift to the vertex plane
    if (cs) {
        const float dx0 = sub(x, c[17]), dy0 = sub(y, c[18]), dz0 = sub(s.z, c[19]);
        x = add(add(mul(c[8], dx0), mul(c[11], dy0)), mul(c[14], dz0));
        y = add(add(mul(c[9], dx0), mul(c[12], dy0)), mul(c[15], dz0));
        z = add(add(mul(c[10], dx0), mul(c[13], dy0)), mul(c[16], dz0));
        const float Ln = add(add(mul(c[8], L), mul(c[11], M)), mul(c[14], N));
        const float Mn = add(add(mul(c[9], L), mul(c[12], M)), mul(c[15], N));
        const float Nn = add(add(mul(c[10], L), mul(c[13], M)), mul(c[16], N));
        L = Ln;
        M = Mn;
        N = Nn;
    } else if (MODE == OPD_SPLIT) {
        tp.zp = s.z;
        z = sub(s.z, c[27]);
    } else {
        z = sub(s.z, pos_z);
    }
    tp.xl = x;
    tp.yl = y;
    tp.zl = z;
    tp.Ll = L;
    tp.Ml = M;
    tp.Nl = N;

    // the conic root (the Newton sag's warm start)
    float t;
    if ((fl & FLAG_PLANE) || fresnel) {
        t = dvd(-z, N);
    } else {
        tp.t0 = dvd(-z, N);
        tp.x0 = add(x, mul(tp.t0, L));
        tp.y0 = add(y, mul(tp.t0, M));
        tp.a = mul(add(mul(mul(conic, N), N), 1.0f), ri);
        tp.bh = sub(mul(add(mul(L, tp.x0), mul(M, tp.y0)), ri), N);
        tp.cc = mul(add(mul(tp.x0, tp.x0), mul(tp.y0, tp.y0)), ri);
        const float disc = sub(mul(tp.bh, tp.bh), mul(tp.a, tp.cc));
        tp.ok = disc >= 0.0f;
        tp.sq = sqt(tp.ok ? disc : 1.0f);
        // sign(0) := +1 for the root pairing (_sign_pm)
        tp.q = -add(tp.bh, tp.bh >= 0.0f ? tp.sq : -tp.sq);
        tp.ag = eps_guard(tp.a);
        tp.qg = eps_guard(tp.q);
        tp.t_far = dvd(tp.q, tp.ag);
        tp.t_near = dvd(tp.cc, tp.qg);
        tp.near = fabsf(tp.t_near) <= fabsf(tp.t_far);
        tp.tq = tp.ok ? (tp.near ? tp.t_near : tp.t_far) : 0.0f;
        t = add(tp.t0, tp.tq);
        s.valid = s.valid && tp.ok;
    }

    // a Newton sag: NEWTON_ITERS steps from the warm start, then the live
    // step (the plain version runs the steps without gradient)
    if (newton) {
        float t_it = t;
        for (int it = 0; it <= NEWTON_ITERS; ++it) {
            const float xx = add(x, mul(t_it, L));
            const float yy = add(y, mul(t_it, M));
            const float zz = add(z, mul(t_it, N));
            const Sag g = sag_grad<VAR>(gk, fl, c, ac, ztab, xx, yy);
            const float f = sub(g.s, zz);
            const float dd = sub(add(mul(g.gx, L), mul(g.gy, M)), N);
            const float dg = eps_guard(dd);
            if (it == NEWTON_ITERS) {
                tp.t_it = t_it;
                tp.xx = xx;
                tp.yy = yy;
                tp.f = f;
                tp.dd = dd;
                tp.dg = dg;
                tp.ngx = g.gx;
                tp.ngy = g.gy;
            }
            t_it = sub(t_it, dvd(f, dg));
        }
        t = t_it;
    }
    tp.t = t;

    x = add(x, mul(t, L));
    y = add(y, mul(t, M));
    z = add(z, mul(t, N));
    if (MODE == OPD_SPLIT) {
        tp.nabs = mul(sigma, N);
        tp.den = add(1.0f, tp.nabs);
        tp.onem = dvd(add(mul(L, L), mul(M, M)), tp.den);
        tp.ratio = dvd(tp.onem, tp.nabs);
        float dev = sub(mul(mul(mul(n1, sigma), c[27]), tp.ratio),
                        dvd(mul(mul(sigma, n1), tp.zp), tp.nabs));
        if (!(fl & FLAG_PLANE)) dev = add(dev, mul(n1, tp.tq));
        kahan_add(s, dev);
        // z from the exact sag at the landed (x, y)
        if (fl & FLAG_PLANE) {
            z = 0.0f;
        } else {
            const float r2 = add(mul(x, x), mul(y, y));
            tp.arg_z = sub(1.0f, mul(mul(mul(add(1.0f, conic), ri), ri), r2));
            tp.sq_z = sqt(tp.arg_z > EPS_GUARD ? tp.arg_z : EPS_GUARD);
            z = dvd(mul(r2, ri), add(1.0f, tp.sq_z));
        }
    } else if (MODE == OPD_KAHAN) {
        kahan_add(s, fabsf(mul(t, n1)));
    } else {
        s.opd = add(s.opd, fabsf(mul(t, n1)));
    }
    if (fl & FLAG_ABSORB) {
        tp.e = expf(mul(mul(-alpha, t), 1000.0f));
        s.inten = mul(s.inten, tp.e);
    }
    // the aperture masks the intensity in the local frame
    if (WIDE && (fl & FLAG_AP)) {
        const float xa = sub(x, c[22]), ya = sub(y, c[23]);
        const float r2a = add(mul(xa, xa), mul(ya, ya));
        tp.mask = (r2a >= c[20] && r2a <= c[21]) ? 1.0f : 0.0f;
        s.inten = mul(s.inten, tp.mask);
    }
    tp.x2 = x;
    tp.y2 = y;
    tp.z2 = z;

    float Lo = L, Mo = M, No = N;
#if WITH_DOE
    if (doe) {
        DoeTape d;
        doe_forward(c, ac, fl, x, y, L, M, N, d);
        Lo = d.Lo;
        Mo = d.Mo;
        No = d.No;
        s.valid = s.valid && d.ok;
        if (inter_of(fl) == INTER_PHASE) {
            s.inten = mul(s.inten, d.mask);
            if (MODE == OPD_KAHAN)
                kahan_add(s, d.shift);
            else
                s.opd = add(s.opd, d.shift);
            s.inten = mul(s.inten, c[EFF_COL]);
        }
    } else
#endif
    if (conic_like && (fl & FLAG_PLANE)) {
        if (fl & FLAG_REFL) {
            No = -N;
        } else {
            tp.u = dvd(n1, n2);
            const float disc_r = sub(1.0f, mul(mul(tp.u, tp.u), sub(1.0f, mul(N, N))));
            tp.ok_r = disc_r >= 0.0f;
            tp.root_r = sqt(tp.ok_r ? disc_r : 1.0f);
            s.valid = s.valid && tp.ok_r;
            Lo = mul(tp.u, L);
            Mo = mul(tp.u, M);
            No = sign_times(N, tp.root_r);
        }
    } else {
        if (conic_like) {
            tp.r2 = add(mul(x, x), mul(y, y));
            tp.arg = sub(1.0f, mul(mul(mul(add(1.0f, conic), ri), ri), tp.r2));
            tp.sr = sqt(tp.arg > EPS_GUARD ? tp.arg : 1.0f);
            tp.inv_root = dvd(1.0f, tp.sr);
            tp.dfdx = mul(mul(x, ri), tp.inv_root);
            tp.dfdy = mul(mul(y, ri), tp.inv_root);
        } else if (FF && gk == GK_FDESIGNED) {
            designed_slope(c, x, y, tp.dfdx, tp.dfdy);
        } else {                               // the Newton sag's own slope
            const Sag g = sag_grad<VAR>(gk, fl, c, ac, ztab, x, y);
            tp.dfdx = g.gx;
            tp.dfdy = g.gy;
        }
        tp.sn = sqt(add(add(mul(tp.dfdx, tp.dfdx), mul(tp.dfdy, tp.dfdy)), 1.0f));
        tp.inv_n = dvd(1.0f, tp.sn);
        tp.nx = mul(tp.dfdx, tp.inv_n);
        tp.ny = mul(tp.dfdy, tp.inv_n);
        tp.nz = -tp.inv_n;
        tp.dot = add(add(mul(L, tp.nx), mul(M, tp.ny)), mul(N, tp.nz));
        if (fl & FLAG_REFL) {
            const float two_dot = mul(2.0f, tp.dot);
            Lo = sub(L, mul(two_dot, tp.nx));
            Mo = sub(M, mul(two_dot, tp.ny));
            No = sub(N, mul(two_dot, tp.nz));
        } else {
            tp.u = dvd(n1, n2);
            const float disc_r = sub(1.0f, mul(mul(tp.u, tp.u),
                                               sub(1.0f, mul(tp.dot, tp.dot))));
            tp.ok_r = disc_r >= 0.0f;
            tp.root_r = sqt(tp.ok_r ? disc_r : 1.0f);
            tp.w = sub(sign_times(tp.dot, tp.root_r), mul(tp.u, tp.dot));
            Lo = add(mul(tp.u, L), mul(tp.nx, tp.w));
            Mo = add(mul(tp.u, M), mul(tp.ny, tp.w));
            No = add(mul(tp.u, N), mul(tp.nz, tp.w));
            s.valid = s.valid && tp.ok_r;
        }
    }
    // the polarization chain, on the local directions before and after the
    // interaction (pallas_trace.py:1517-1523, 1663-1731)
#if WITH_DOE
    if constexpr (POL) if (!doe) {
#else
    if constexpr (POL) {
#endif
        const bool plane = conic_like && (fl & FLAG_PLANE);
        PolSurf b;
        polar_surface(b, fl, n1, n2, plane, plane ? fabsf(N) : fabsf(tp.dot),
                      L, M, N, Lo, Mo, No, tp.nx, tp.ny, tp.nz);
#pragma unroll
        for (int v = 0; v < 2; ++v) {
            if (v >= ps->nev) break;
            polar_apply(b, L, M, N, Lo, Mo, No, ps->e[v]);
        }
    }
    // the simple coating's factor, after the interaction
    if (WIDE && (fl & FLAG_COAT)) {
        tp.inten_pc = s.inten;
        s.inten = mul(s.inten, c[6]);
    }
    tp.Lo = Lo;
    tp.Mo = Mo;
    tp.No = No;

    // globalize: v = R v_local + t
    if (cs) {
        s.x = add(add(add(mul(c[8], x), mul(c[9], y)), mul(c[10], z)), c[17]);
        s.y = add(add(add(mul(c[11], x), mul(c[12], y)), mul(c[13], z)), c[18]);
        s.z = add(add(add(mul(c[14], x), mul(c[15], y)), mul(c[16], z)), c[19]);
        s.L = add(add(mul(c[8], Lo), mul(c[9], Mo)), mul(c[10], No));
        s.M = add(add(mul(c[11], Lo), mul(c[12], Mo)), mul(c[13], No));
        s.N = add(add(mul(c[14], Lo), mul(c[15], Mo)), mul(c[16], No));
    } else {
        s.x = x;
        s.y = y;
        s.z = MODE == OPD_SPLIT ? z : add(z, pos_z);
        s.L = Lo;
        s.M = Mo;
        s.N = No;
    }
}

// ---- epilogue: image propagation (_gen_epilogue; NaN injection is left to
// the caller) ------------------------------------------------------------------
__device__ __forceinline__ void gen_epilogue(const float* g, int final_prop,
                                             RayState& s) {
    if (final_prop) {
        const float t_img = g[6];
        s.x = add(s.x, mul(t_img, s.L));
        s.y = add(s.y, mul(t_img, s.M));
        s.z = add(s.z, mul(t_img, s.N));
    }
}

// True when the split mode can take the flag words: no tilt, no sag but the
// conic, no grating or phase surface.
static inline bool split_ok(const int32_t* flags, int S) {
    for (int k = 0; k < S; ++k)
        if (flags[k] & (FLAG_CS | (GKIND_MASK << GKIND_SHIFT)
                        | (INTER_MASK << INTER_SHIFT)))
            return false;
    return true;
}

// True when every flag word names a sag kind the kernels have, and an
// interaction they have on a conic or plane (a phase profile of PH_*; terms
// on a radial one only), and a grating or phase surface only where this
// source compiles them (WITH_DOE).
static inline bool kinds_ok(const int32_t* flags, int S) {
    for (int k = 0; k < S; ++k) {
        const int fl = flags[k], inter = inter_of(fl);
        if (gkind_of(fl) > GK_LAST || inter > INTER_PHASE ||
            (!WITH_DOE && inter != INTER_NONE))
            return false;
        if (inter != INTER_NONE &&
            (gkind_of(fl) != GK_CONIC || (fl & (FLAG_COAT | FLAG_FRESNEL)) ||
             (inter == INTER_PHASE ? phase_of(fl) > PH_LINEAR ||
                                         (nu_of(fl) && phase_of(fl) != PH_RADIAL)
                                   : nu_of(fl) != 0)))
            return false;
    }
    return true;
}

// The least variant the flag words need.
static inline int variant_of(const int32_t* flags, int S) {
    int v = VAR_NARROW;
    for (int k = 0; k < S; ++k) {
        const int gk = gkind_of(flags[k]);
        if (gk == GK_QBFS || gk == GK_Q2D) return VAR_FORBES;
        if (gk >= GK_POLY) v = VAR_FREEFORM;
        else if ((flags[k] & WIDE_MASK) && v == VAR_NARROW) v = VAR_WIDE;
    }
    return v;
}
