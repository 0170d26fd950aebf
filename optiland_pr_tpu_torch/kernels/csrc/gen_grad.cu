// K2, sub-slices (a), (b), (c), (d), (e), (f) and the OPD modes of (g): the
// vector-Jacobian product of K1 (gen_trace.cu) by per-ray recompute and a
// per-surface reverse sweep, one ray per thread.
//
// One library per OPD mode: this file builds the plain mode's, and
// gen_grad_kahan.cu and gen_grad_split.cu include it with GRAD_MODE set to
// OPD_KAHAN and OPD_SPLIT. Each library holds its mode's template instances
// (4 stack depths x the variants: narrow, WIDE and, in the plain and Kahan
// modes, FREEFORM and FORBES), and the three build in parallel. The
// polarized instances (sub-slice (e), GRAD_POL 1) are three more libraries,
// gen_grad_pol.cu, gen_grad_pol_kahan.cu and gen_grad_pol_split.cu, so that
// the unpolarized ones compile the code they had before (e). The instances
// that take the gratings and phase surfaces of (f) (WITH_DOE 1, the plain
// and Kahan modes) are four more, gen_grad_doe.cu, gen_grad_doe_kahan.cu,
// gen_grad_pol_doe.cu and gen_grad_pol_doe_kahan.cu, for the same reason:
// the adjoint of (f) takes the WIDE instances from 128 registers to about
// 205 (PERF.md).
//
// Replaces the TPU kernel optiland_pr_tpu/kernels/pallas_grad.py::
// _pallas_gen_bwd_2d (body _gen_bwd_kernel -> _manual_vjp) for conic,
// plane, even/odd aspheric, XY-polynomial, Chebyshev, biconic, toroidal,
// Zernike and thin Fresnel surfaces that refract or reflect, linear gratings
// and phase surfaces (constant, radial and linear-grating profiles) on conic
// or plane substrates, with absorption in the pre-material, tilt/decenter,
// radial and offset-radial apertures and simple coatings. The TPU kernel ran
// jax.vjp inside the kernel; here the
// adjoint of every branch is written out by hand, and it follows the
// derivative conventions of PyTorch autograd on the plain version
// (kernels/gen_grad.py::gen_trace_bwd_plain), which it is held against:
//   - where(c, a, b) sends the cotangent to the taken branch only; the
//     guarded square roots (sqrt(ok ? d : 1), sqrt(arg > eps ? arg : eps))
//     get none on the guarded side, max(r^2, 1e-24) none below the floor;
//   - eps_guard passes the cotangent on |v| > eps and none on its clamp;
//   - sign() has zero derivative; |v| has derivative sign(v), 0 at 0;
//   - 1/sqrt(s) is differentiated as reciprocal(sqrt(s));
//   - a Newton sag's steps are not differentiated: only its live last step
//     is, so the cotangent is the implicit-function-theorem one, and the
//     conic warm start gets none. Each sag's adjoint (of its value and
//     slopes, so through its second derivatives) serves the live step and
//     the exit normal; the Chebyshev slope keeps the reference's missing
//     1/norm factor, and its adjoint differentiates that slope as it is;
//   - the thin Fresnel surfaces' base-plane root t = -z / N, and the
//     designed facet's slope through focal_length and n_design (columns 24
//     and 25);
//   - the aperture mask passes the intensity cotangent inside and none
//     outside, and gives the aperture extents none;
//   - the Kahan update (opd, opd_c) <- (opd + (v - opd_c), ((opd + (v -
//     opd_c)) - opd) - (v - opd_c)) is linear: with g, gc the cotangents of
//     the new opd and opd_c, the sum's gtk = g + gc, and opd, v and opd_c
//     get gtk - gc, gtk - gc and -(gtk - gc), as autograd forms them;
//   - the split mode's sag refresh clamps its root's argument at eps, which
//     passes no cotangent, and the propagated z it replaces gets none;
//   - (e): a polarized launch's final intensity, scale x sum |E|^2, is the
//     only one with a cotangent (the traced intensity it replaces gets
//     none); each surface's update of the E-vectors runs back into the
//     directions before and after the interaction, the normal (so the
//     sag's slopes and parameters), cos_i (|N| on a plane, |dot| else,
//     derivative sign(.), 0 at 0), n1 and n2 (through the Fresnel
//     coefficients) and the incoming vectors; the launch vectors into the
//     launch direction and, through sqrt(w), the apodization weight. The
//     fallback of the s basis and its guarded roots pass the cotangent to
//     the taken branch only;
//   - (f): the grating runs back through its two normalizations, the cross
//     product n x t, the strength c24 |f_xy| and the rebuilt normal part
//     (none through the aligned normal's sign, none from a lost ray's
//     guarded root), the phase update through its profile (the radial
//     terms into dacoef; the root r = sqrt(x^2 + y^2) differentiated as
//     autograd does, so a ray through the exact centre of a radial profile
//     gets a non-finite cotangent, as in the JAX package), the projected
//     gradient, the rebuilt normal part (none on an evanescent order, the
//     double where) and the final normalization, and the OPD shift -phase
//     / k0 (plain or compensated) into k0 = 2 pi / c7; both into the
//     substrate's slope (the Plane class's normal is constant); the
//     efficiency (column 29) is a constant and gets none.
//
// Inputs: the forward's tables and pupil samples (gen_trace_common.cuh,
// gen_trace.cu) and the cotangents of its 8 outputs, cot [8, W, F, n].
// Outputs:
//   dgen    [F, 16]    columns 0-6, 8, 9 (the rest are 0), summed over W
//   dconsts [W, S, 32] columns 0-5; 6 on a coated surface; 8-19 on a tilted
//                      or decentered one; 24-25 on a sag of kind GK_POLY and
//                      up and on a grating or phase surface; 7 on a phase
//                      surface; 27 (the vertex gap) in the split mode (the
//                      rest are 0)
//   dacoef  [S, C]     the sag coefficients' and a radial phase profile's
//                      (the rest are 0), summed over W
//   dPx, dPy [n]       summed over W and F (optional)
//
// Design.
//   0. The narrow, plain-OPD, unpolarized instances (one per stack-depth
//      bucket, in this library only) are gen_grad_narrow.cuh's explicit
//      specializations: K1 narrow's fused step (gen_trace_narrow.cuh) run
//      for the lost-ray mask alone, the shared forward for the states and
//      the tape, an adjoint with fast divisions and derived-constant
//      cotangents, one butterfly reduction per surface. What follows
//      describes every other instance.
//   1. gen_grad_kernel, grid (ceil(n/256), F, W) as in K1. Each thread runs
//      the shared forward (gen_trace_common.cuh), so its lost-ray mask is
//      K1's bit for bit, and keeps the boundary state of every surface
//      (x, y, z, L, M, N, intensity: 7 floats; a polarized launch's
//      E-vectors too, 3 n_ev more) in a local array. The kernel
//      is a template on a stack-depth bucket (8, 16, 32, 64 surfaces) so the
//      local array is sized for the system, not for the 64-surface maximum;
//      it is indexed by the runtime surface number, so it lives in local
//      memory (L1/L2), not in registers. Recompute from checkpoints would
//      save that memory at O(S^2) arithmetic, and the kernel is bound by
//      arithmetic (PERF.md). It is a template on K1's variant too: the
//      narrow one for conic/plane systems, WIDE for (b) and the even/odd
//      aspheres, FREEFORM for the other sags of (c) but the Forbes sags,
//      FORBES for a system with a Forbes sag (the Clenshaw adjoints would
//      cost the other freeform sags their registers: 812 B spilled against
//      220 B, PERF.md). The launch's telecentric aim and apodization are a
//      runtime branch on gen columns 10-11 in every variant.
//      The cotangents of x, y, z, L, M, N, opd are zeroed for lost rays (the
//      transpose of _nanify8: a NaN cotangent from an unmasked consumer
//      becomes 0); the intensity cotangent is not masked. The reverse sweep
//      runs the epilogue's adjoint, then each surface's (recomputing that
//      surface's intermediates from its boundary state), then the
//      prologue's.
//      Each surface's parameter cotangents are summed over the block as soon
//      as they are made: a warp shuffle tree, then the 8 warp sums in order
//      from shared memory, into one partial per block and quantity. The
//      quantities ("slots") of surface k start at layout.qoff[k]: consts
//      columns 0-5, then 6 if coated, then 8-19 if tilted, then its sag
//      coefficients, then columns 24-25 on a sag of kind GK_POLY and up,
//      then columns 24-25 (and 7 on a phase surface) on a grating or phase
//      surface, then column 27 in the split mode; dgen's 9 follow the last
//      surface's.
//   2. gen_grad_reduce: one block per output element sums its partials in
//      float64, each thread a fixed strided subset, then a fixed tree; the
//      sums are 4M-36M float32 terms, so float64 keeps the order from
//      mattering against the plain version's torch.sum.
//   3. sum_wf: dPx and dPy summed over the W*F per-(w, f) planes, in order,
//      in float64.
//   No float atomicAdd anywhere: two runs on the same inputs give
//   bit-identical gradients. (The TPU kernel accumulated across its
//   sequential grid instead, pallas_grad.py:147-180; blocks on a GPU run in
//   no order.)
//   4. The OPD modes: the boundary state needs no OPD (no surface's
//      geometry reads it), the cotangent of opd_c rides beside the OPD's
//      through the sweep, and in the split mode the propagation sign is
//      unwound surface by surface from its value after the stack.
//
// Bounds on an H100: per ray it reads 8 B of pupil and 32 B of cotangents
// and writes 8 B of pupil cotangents per (w, f) plane; the arithmetic is
// K1's forward twice (the sweep recomputes each surface) plus the adjoint,
// ~3.4x K1's operations for conic surfaces and more for aspheres (the
// adjoint of the live Newton step and of the normal each re-evaluate the
// sag and its derivatives). Measured on an H100 (700 W): 1.03 ms for the
// Cooke triplet at 4M rays, ~5x K1's time per ray and ~9x the operation
// bound, so it is bound by instruction issue, as K1 is (PERF.md); the
// narrow instance's redesign (gen_grad_narrow.cuh) is measured there too.
#include "gen_trace_common.cuh"

#ifndef GRAD_MODE
#define GRAD_MODE OPD_PLAIN
// this file built as it stands: the plain mode's library, whose narrow
// instances are gen_grad_narrow.cuh's (every other library defines
// GRAD_MODE, and GRAD_POL, WITH_DOE or another mode, before including it)
#define NARROW_FUSED 1
#else
#define NARROW_FUSED 0
#endif
// 1: this library holds the polarized instances (sub-slice (e))
#ifndef GRAD_POL
#define GRAD_POL 0
#endif
// 1: this library's WIDE, plain-OPD, polarized instances are
// gen_grad_pol_wide.cuh's (gen_grad_pol.cu)
#ifndef POL_WIDE_FUSED
#define POL_WIDE_FUSED 0
#endif

#define GBLOCK 256
#define NWARP (GBLOCK / 32)
#define NGEN 9        // gen columns with a cotangent: 0-6, 8, 9
// consts columns with a cotangent: 0-6, 8-19, 24-25; 7 where the library
// takes the diffractive surfaces (WITH_DOE, a phase surface's k0). The
// libraries without them leave out every line of (f) by the preprocessor,
// so that they compile the code they had before it: a branch that is only
// dead after constant folding still moved their instruction schedule.
#if WITH_DOE
#define NDC 22
#else
#define NDC 21
#endif
#define RBLOCK 256    // threads of the reduction kernels

// The flag words, where each surface's slots start (qoff[S]: dgen's), and
// whether each surface has a vertex-gap slot (the split mode).
struct GradLayout {
    int32_t f[MAX_SURF];
    int32_t qoff[MAX_SURF + 1];
    int32_t split;
};

// Cotangents of the ray state; opdc is the Kahan compensation's.
struct Adj {
    float x, y, z, L, M, N, inten, opd, opdc;
};

// the slots of columns 24-25: the sags of kind GK_POLY and up
__host__ __device__ __forceinline__ int n_extra(int fl) {
    return gkind_of(fl) >= GK_POLY ? 2 : 0;
}

__host__ __device__ __forceinline__ int n_slots(int fl) {
    return 6 + ((fl & FLAG_COAT) ? 1 : 0) + ((fl & FLAG_CS) ? 12 : 0) + ncoef_of(fl)
           + n_extra(fl);
}

// the slots of a grating's columns 24-25, and of a phase surface's 24-25
// and 7 (sub-slice (f)), after n_slots' (no split mode takes them)
__host__ __device__ __forceinline__ int n_doe(int fl) {
    const int inter = inter_of(fl);
    return inter == INTER_GRATING ? 2 : (inter == INTER_PHASE ? 3 : 0);
}

// Slot of consts column j of surface k, or -1 if it has no cotangent.
__device__ __forceinline__ int const_slot(const GradLayout& g, int k, int j) {
    const int fl = g.f[k];
    const int coat = (fl & FLAG_COAT) ? 1 : 0;
    if (j < 6) return g.qoff[k] + j;
    if (j == 6) return coat ? g.qoff[k] + 6 : -1;
    if (j >= 8 && j <= 19 && (fl & FLAG_CS)) return g.qoff[k] + 6 + coat + (j - 8);
    if ((j == 24 || j == 25) && n_extra(fl))
        return g.qoff[k] + 6 + coat + ((fl & FLAG_CS) ? 12 : 0) + ncoef_of(fl) + (j - 24);
    if (WITH_DOE && (j == 24 || j == 25) && n_doe(fl))
        return g.qoff[k] + n_slots(fl) + (j - 24);
    if (WITH_DOE && j == 7 && n_doe(fl) == 3) return g.qoff[k] + n_slots(fl) + 2;
    if (j == 27 && g.split) return g.qoff[k] + n_slots(fl);
    return -1;
}

// Slot of sag coefficient i of surface k, or -1.
__device__ __forceinline__ int acoef_slot(const GradLayout& g, int k, int i) {
    const int fl = g.f[k];
    if (i >= ncoef_of(fl)) return -1;
    return g.qoff[k] + 6 + ((fl & FLAG_COAT) ? 1 : 0) + ((fl & FLAG_CS) ? 12 : 0) + i;
}

__device__ __forceinline__ float sgn(float v) {
    return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Reverse of asphere_sag_grad (gen_trace_common.cuh): adds to (dxx, dyy,
// dri, dconic, da[0..nu)) the cotangents of its inputs for the cotangents
// (ds, dgx, dgy) of (s, gx, gy). Through the gradient's cotangents this
// carries the sag's second derivatives, and their derivatives with respect
// to the curvature, the conic and every term. Used by the live Newton step
// (ds, dgx, dgy) and by the normal (0, dgx, dgy).
__device__ __forceinline__ void asphere_sag_adjoint(
        float ri, float conic, const float* ac, int nu, bool odd, float xx,
        float yy, float ds, float dgx, float dgy, float& dxx, float& dyy,
        float& dri, float& dconic, float* da) {
    const float r2 = add(mul(xx, xx), mul(yy, yy));
    const float B = mul(add(1.0f, conic), ri);
    const float A = mul(B, ri);
    const float arg = sub(1.0f, mul(A, r2));
    const bool ok = arg > EPS_GUARD;
    const float sq = sqt(ok ? arg : EPS_GUARD);
    const float den = add(1.0f, sq);
    const float s0 = dvd(mul(r2, ri), den);
    const float inv_sq = dvd(1.0f, sq);
    float dr2 = 0.0f;
    // the terms: term_i and gterm_i are powers of ``step`` (r^2, or r for
    // the odd asphere); dterm and dgterm carry their derivatives by step
    float step, term, gterm, dterm, dgterm;
    if (odd) {
        step = sqt(fmaxf(r2, ODD_R2_MIN));
        term = step;
        gterm = dvd(1.0f, step);
        dterm = 1.0f;
        dgterm = -gterm * gterm;
    } else {
        step = r2;
        term = r2;
        gterm = 1.0f;
        dterm = 1.0f;
        dgterm = 0.0f;
    }
    float dstep = 0.0f;
    for (int i = 0; i < nu; ++i) {
        const float c = ac[i];
        const float kk = odd ? (float)(i + 1) : 2.0f * (float)(i + 1);
        const float gsum = dgx * (kk * xx) + dgy * (kk * yy);  // of c * gterm
        da[i] += ds * term + gsum * gterm;
        dxx += dgx * kk * c * gterm;
        dyy += dgy * kk * c * gterm;
        dstep += ds * c * dterm + gsum * c * dgterm;
        dterm = dterm * step + term;
        term = term * step;
        dgterm = dgterm * step + gterm;
        gterm = gterm * step;
    }
    if (odd)
        dr2 += r2 >= ODD_R2_MIN ? dstep / (2.0f * step) : 0.0f;
    else
        dr2 += dstep;
    // the conic base: gx = (xx ri) inv_sq, s0 = (r2 ri) / (1 + sq)
    const float dxr = dgx * inv_sq, dyr = dgy * inv_sq;
    const float dinv_sq = dgx * (xx * ri) + dgy * (yy * ri);
    dxx += dxr * ri;
    dyy += dyr * ri;
    dri += dxr * xx + dyr * yy;
    const float dnum = ds / den;
    float dsq = -ds * s0 / den;
    dr2 += dnum * ri;
    dri += dnum * r2;
    dsq -= dinv_sq * (inv_sq * inv_sq);
    // sq = sqrt(arg > eps ? arg : eps), arg = 1 - ((1 + k) ri) ri r2
    const float darg = ok ? dsq / (2.0f * sq) : 0.0f;
    const float dA = -darg * r2;
    dr2 -= darg * A;
    const float dB = dA * ri;
    dri += dA * B;
    dconic += dB * ri;
    dri += dB * (1.0f + conic);
    dxx += 2.0f * xx * dr2;
    dyy += 2.0f * yy * dr2;
}

// ---- the freeform sags' adjoints -------------------------------------------
// Each adds to (dxx, dyy) and to its parameters' cotangents those of its
// inputs for the cotangents (ds, dgx, dgy) of its (s, gx, gy), as autograd
// forms them through the plain version (kernels/gen_trace.py::_sag_grad).
// The forward quantities that pick a branch are recomputed with K1's
// intrinsics, so the branch is K1's.

__device__ __forceinline__ void conic_base_adjoint(
        float ri, float conic, float xx, float yy, float ds, float dgx,
        float dgy, float& dxx, float& dyy, float& dri, float& dconic) {
    asphere_sag_adjoint(ri, conic, nullptr, 0, false, xx, yy, ds, dgx, dgy,
                        dxx, dyy, dri, dconic, nullptr);
}

// axis_conic: s = ((cv v) v) / (1 + sq), g = (cv v) / sq, sq = sqrt(arg > eps
// ? arg : eps), arg = 1 - ((((1 + k) cv) cv) v) v
__device__ __forceinline__ void axis_conic_adjoint(float cv, float k, float v,
                                                   float ds, float dg,
                                                   float& dv, float& dcv,
                                                   float& dk) {
    const float A1 = mul(add(1.0f, k), cv);
    const float A2 = mul(A1, cv);
    const float A3 = mul(A2, v);
    const float arg = sub(1.0f, mul(A3, v));
    const bool ok = arg > EPS_GUARD;
    const float sq = sqt(ok ? arg : EPS_GUARD);
    const float cvv = cv * v, den = 1.0f + sq;
    const float s = cvv * v / den, g = cvv / sq;
    const float dnum = ds / den;
    const float dsq = -ds * s / den - dg * g / sq;
    const float dcvv = dg / sq + dnum * v;
    dv += dnum * cvv;
    const float darg = ok ? dsq / (2.0f * sq) : 0.0f;
    const float dA3 = -darg * v;
    dv -= darg * A3;
    const float dA2 = dA3 * v;
    dv += dA3 * A2;
    const float dA1 = dA2 * cv;
    dcv += dA2 * A1;
    dk += dA1 * cv;
    dcv += dA1 * (1.0f + k);
    dcv += dcvv * v;
    dv += dcvv * cv;
}

// poly_sag_grad: s += C x^i y^j, gx += i C x^(i-1) y^j, gy += j C x^i y^(j-1)
__device__ __forceinline__ void poly_sag_adjoint(
        const float* c, const float* ac, int nu, int nv, float xx, float yy,
        float ds, float dgx, float dgy, float& dxx, float& dyy, float& dri,
        float& dconic, float* da) {
    conic_base_adjoint(c[0], c[1], xx, yy, ds, dgx, dgy, dxx, dyy, dri, dconic);
    float xi = 1.0f, xim1 = 0.0f, xim2 = 0.0f;
    for (int i = 0; i < nu; ++i) {
        const float fi = (float)i;
        float yj = 1.0f, yjm1 = 0.0f, yjm2 = 0.0f;
        for (int j = 0; j < nv; ++j) {
            const float fj = (float)j;
            const float cij = ac[i * nv + j];
            da[i * nv + j] += ds * xi * yj + dgx * fi * xim1 * yj
                              + dgy * fj * xi * yjm1;
            dxx += cij * (ds * fi * xim1 * yj
                          + dgx * fi * (fi - 1.0f) * xim2 * yj
                          + dgy * fi * fj * xim1 * yjm1);
            dyy += cij * (ds * fj * xi * yjm1 + dgx * fi * fj * xim1 * yjm1
                          + dgy * fj * (fj - 1.0f) * xi * yjm2);
            yjm2 = yjm1;
            yjm1 = yj;
            yj *= yy;
        }
        xim2 = xim1;
        xim1 = xi;
        xi *= xx;
    }
}

// T_k(w), T'_k(w) and T''_k(w), k = 0, 1, ..., by the derivatives of the
// recurrence T_k = 2w T_{k-1} - T_{k-2}
struct Cheb2 {
    float w, t0, t1, d0, d1, e0, e1;
    int k;
    __device__ __forceinline__ void start(float w_) {
        w = w_;
        k = 0;
        t0 = d0 = e0 = d1 = e1 = 0.0f;
        t1 = 1.0f;
    }
    __device__ __forceinline__ void next() {
        ++k;
        float tn = w, dn = 1.0f, en = 0.0f;
        if (k > 1) {
            tn = 2.0f * w * t1 - t0;
            dn = 2.0f * t1 + 2.0f * w * d1 - d0;
            en = 4.0f * d1 + 2.0f * w * e1 - e0;
        }
        t0 = t1;
        t1 = tn;
        d0 = d1;
        d1 = dn;
        e0 = e1;
        e1 = en;
    }
};

// cheb_sag_grad: s += C T_i(u) T_j(v), gx += C T'_i T_j, gy += C T_i T'_j
// with u = x / nx, v = y / ny (the slopes without the 1/norm factor)
__device__ __forceinline__ void cheb_sag_adjoint(
        const float* c, const float* ac, int nu, int nv, float xx, float yy,
        float ds, float dgx, float dgy, float& dxx, float& dyy, float& dri,
        float& dconic, float& dnx, float& dny, float* da) {
    conic_base_adjoint(c[0], c[1], xx, yy, ds, dgx, dgy, dxx, dyy, dri, dconic);
    const float nx = c[24], ny = c[25];
    const float u = xx / nx, v = yy / ny;
    float du = 0.0f, dv = 0.0f;
    Cheb2 tx;
    tx.start(u);
    for (int i = 0; i < nu; ++i) {
        if (i > 0) tx.next();
        Cheb2 ty;
        ty.start(v);
        for (int j = 0; j < nv; ++j) {
            if (j > 0) ty.next();
            const float cij = ac[i * nv + j];
            da[i * nv + j] += ds * tx.t1 * ty.t1 + dgx * tx.d1 * ty.t1
                              + dgy * tx.t1 * ty.d1;
            du += cij * (ds * tx.d1 * ty.t1 + dgx * tx.e1 * ty.t1
                         + dgy * tx.d1 * ty.d1);
            dv += cij * (ds * tx.t1 * ty.d1 + dgx * tx.d1 * ty.d1
                         + dgy * tx.t1 * ty.e1);
        }
    }
    dxx += du / nx;
    dnx -= du * u / nx;
    dyy += dv / ny;
    dny -= dv * v / ny;
}

// toroidal_sag_grad: the y-curve (zy, dzy), then s = R - sign(dz) root,
// gx = ok ? sign(R) x / root : 0, gy = ok ? sign(R) dz dzy / root : 0 with
// dz = R - zy, root = sqrt(ok ? dz^2 - x^2 : eps); at an infinite rotation
// radius (s, gx, gy) = (zy, 0, dzy)
__device__ __forceinline__ void toroidal_sag_adjoint(
        const float* c, const float* ac, int nu, bool inf, float xx, float yy,
        float ds, float dgx, float dgy, float& dxx, float& dyy, float& dri,
        float& dconic, float& dR, float* da) {
    float zy, dzy;
    axis_conic(c[0], c[1], yy, zy, dzy);
    const float y2 = mul(yy, yy);
    {
        float term = y2, dterm = yy;
        for (int i = 0; i < nu; ++i) {
            zy = add(zy, mul(ac[i], term));
            dzy = add(dzy, mul(mul(2.0f * (float)(i + 1), ac[i]), dterm));
            term = mul(term, y2);
            dterm = mul(dterm, y2);
        }
    }
    float dzy_s = ds, dzy_g = dgy;            // the cotangents of zy, dzy
    if (!inf) {
        const float R = c[24];
        const float dz = sub(R, zy);
        const float inside = sub(mul(dz, dz), mul(xx, xx));
        const bool ok = inside > EPS_GUARD;
        const float root = sqt(ok ? inside : EPS_GUARD);
        const float sgn = dz >= 0.0f ? 1.0f : -1.0f;
        const float sgn_r = R >= 0.0f ? 1.0f : -1.0f;
        const float inv_root = 1.0f / root;
        float droot = -ds * sgn, ddz = 0.0f, dinv = 0.0f;
        dzy_g = 0.0f;
        if (ok) {
            dxx += dgx * sgn_r * inv_root;
            dinv = sgn_r * (dgx * xx + dgy * dz * dzy);
            ddz = dgy * sgn_r * dzy * inv_root;
            dzy_g = dgy * sgn_r * dz * inv_root;
        }
        droot -= dinv * inv_root * inv_root;
        const float dinside = ok ? droot / (2.0f * root) : 0.0f;
        ddz += 2.0f * dz * dinside;
        dxx -= 2.0f * xx * dinside;
        dR += ds + ddz;
        dzy_s = -ddz;
    }
    // zy = axis(y) + sum_i C_i y^(2(i+1)), dzy = axis'(y) + sum_i 2(i+1) C_i
    // y^(2i+1)
    axis_conic_adjoint(c[0], c[1], yy, dzy_s, dzy_g, dyy, dri, dconic);
    float term = y2, dterm = yy, eterm = 1.0f;   // y^(2i+2), y^(2i+1), y^(2i)
    for (int i = 0; i < nu; ++i) {
        const float kk = 2.0f * (float)(i + 1);
        da[i] += dzy_s * term + dzy_g * kk * dterm;
        dyy += ac[i] * kk * (dzy_s * dterm + dzy_g * (kk - 1.0f) * eterm);
        term *= y2;
        dterm *= y2;
        eterm *= y2;
    }
}

// R_j(rho) and its first two derivatives from the term's table row
__device__ __forceinline__ void zernike_radial(const float* t, float rho,
                                               float& R, float& R1,
                                               float& R2) {
    R = R1 = R2 = 0.0f;
    const int nc = (int)t[3];
    for (int k = 0; k < nc; ++k) {
        const int p = (int)t[4 + 3 * k];
        const float coef = t[5 + 3 * k], pc = t[6 + 3 * k];
        if (p == 0) {
            R += coef;
            continue;
        }
        float pw = 1.0f;                       // rho^(p - 1)
        for (int q = 1; q < p; ++q) pw *= rho;
        R += coef * pw * rho;
        R1 += pc * pw;
        if (p >= 2) R2 += (float)(p - 1) * pc * (pw / rho);
    }
}

// The angular factor A of a term of order m at (cos, sin) = (c, s), its phi
// derivative Ap, and the partials of both by c and s: T_mu(c) and s
// U_{mu-1}(c), mu = |m|, as the forward's recurrences make them.
struct Ang {
    float a, ap, a_c, a_s, ap_c, ap_s;
};

__device__ __forceinline__ Ang zernike_angular(int m, float c, float s) {
    Ang o = {1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (m == 0) return o;
    const int mu = m > 0 ? m : -m;
    float um2 = 0.0f, um1 = 1.0f, dm2 = 0.0f, dm1 = 0.0f;  // U, U' at k-1, k
    for (int k = 1; k < mu; ++k) {
        const float un = 2.0f * c * um1 - um2;
        const float dn = 2.0f * um1 + 2.0f * c * dm1 - dm2;
        um2 = um1;
        um1 = un;
        dm2 = dm1;
        dm1 = dn;
    }
    const float T = c * um1 - um2, fm = (float)mu;
    if (m > 0) {                               // A = T_mu, Ap = -mu sin_mu
        o.a = T;
        o.a_c = fm * um1;
        o.ap = -fm * s * um1;
        o.ap_c = -fm * s * dm1;
        o.ap_s = -fm * um1;
    } else {                                   // A = sin_mu, Ap = mu T_mu
        o.a = s * um1;
        o.a_c = s * dm1;
        o.a_s = um1;
        o.ap = fm * T;
        o.ap_c = fm * fm * um1;
    }
    return o;
}

// zernike_sag_grad: s += sum_j c_j R_j A_j; gx += Zr x irs / nr - Zp y irs^2,
// gy += Zr y irs / nr + Zp x irs^2 with Zr = sum_j c_j R_j' A_j, Zp = sum_j
// c_j R_j A_j', rho = r / nr, (cos, sin) = (x, y) irs, irs = 1 / max(r,
// 1e-12), c_j = C_j norm_j
__device__ __forceinline__ void zernike_sag_adjoint(
        const float* c, const float* ac, int nu, const float* zt, float xx,
        float yy, float ds, float dgx, float dgy, float& dxx, float& dyy,
        float& dri, float& dconic, float& dnr, float* da) {
    conic_base_adjoint(c[0], c[1], xx, yy, ds, dgx, dgy, dxx, dyy, dri, dconic);
    if (nu == 0) return;
    const float nr = c[24];
    const float r = sqt(add(mul(xx, xx), mul(yy, yy)));
    const float rs = fmaxf(r, 1e-12f);
    const float rho = r / nr, irs = 1.0f / rs;
    const float cost = xx * irs, sint = yy * irs;
    float Zr = 0.0f, Zp = 0.0f;
    for (int j = 0; j < nu; ++j) {
        const float* t = zt + j * ZT_W;
        float R, R1, R2;
        zernike_radial(t, rho, R, R1, R2);
        const Ang A = zernike_angular((int)t[1], cost, sint);
        const float cj = ac[j] * t[2];
        Zr += cj * R1 * A.a;
        Zp += cj * R * A.ap;
    }
    const float gr = dgx * xx + dgy * yy, gp = dgy * xx - dgx * yy;
    const float dZs = ds, dZr = gr * irs / nr, dZp = gp * irs * irs;
    dxx += dgx * Zr * irs / nr + dgy * Zp * irs * irs;
    dyy += dgy * Zr * irs / nr - dgx * Zp * irs * irs;
    const float dirs = Zr * gr / nr + 2.0f * irs * Zp * gp;
    dnr -= Zr * gr * irs / (nr * nr);
    float drho = 0.0f, dcost = 0.0f, dsint = 0.0f;
    for (int j = 0; j < nu; ++j) {
        const float* t = zt + j * ZT_W;
        float R, R1, R2;
        zernike_radial(t, rho, R, R1, R2);
        const Ang A = zernike_angular((int)t[1], cost, sint);
        const float norm = t[2], cj = ac[j] * norm;
        da[j] += norm * (dZs * R * A.a + dZr * R1 * A.a + dZp * R * A.ap);
        drho += cj * (dZs * R1 * A.a + dZr * R2 * A.a + dZp * R1 * A.ap);
        const float dA = cj * (dZs * R + dZr * R1), dAp = cj * dZp * R;
        dcost += dA * A.a_c + dAp * A.ap_c;
        dsint += dA * A.a_s + dAp * A.ap_s;
    }
    float dr = drho / nr;
    dnr -= drho * rho / nr;
    dxx += dcost * irs;
    dyy += dsint * irs;
    const float drs = -(dcost * cost + dsint * sint) * irs - dirs * irs * irs;
    if (r > 1e-12f) dr += drs;
    const float dr2 = dr / (2.0f * r);
    dxx += 2.0f * xx * dr2;
    dyy += 2.0f * yy * dr2;
}

// designed_slope: (dfdx, dfdy) = m (x, y) / rs, m = -P / Q, P = r / hyp,
// Q = n_design - f / hyp, hyp = sqrt(r^2 + f^2), rs = max(r, 1e-12)
__device__ __forceinline__ void designed_slope_adjoint(
        const float* c, float x, float y, float ddfdx, float ddfdy,
        float& dx, float& dy, float& df, float& dnd) {
    const float r2 = add(mul(x, x), mul(y, y));
    const float r = sqt(r2);
    const float rs = fmaxf(r, 1e-12f);
    const float f = c[24];
    const float hyp = sqt(add(r2, mul(f, f)));
    const float P = r / hyp, Q = c[25] - f / hyp;
    const float m = -P / Q;
    const float gxy = ddfdx * x + ddfdy * y;
    const float dm = gxy / rs;
    dx += ddfdx * m / rs;
    dy += ddfdy * m / rs;
    const float drs = -m * gxy / (rs * rs);
    const float dP = -dm / Q, dQ = dm * P / (Q * Q);
    dnd += dQ;
    df -= dQ / hyp;
    float dhyp = dQ * f / (hyp * hyp) - dP * P / hyp;
    float dr = dP / hyp;
    df += dhyp * f / hyp;
    float dr2 = dhyp / (2.0f * hyp);
    if (r > 1e-12f) dr += drs;
    dr2 += dr / (2.0f * r);
    dx += 2.0f * x * dr2;
    dy += 2.0f * y * dr2;
}

// ---- the Forbes sags' adjoints ---------------------------------------------
// A Clenshaw sum is linear in its coefficients: S(usq) = sum_j d_j v_j(usq)
// where the basis values v_j follow the transpose (forward) recurrence
// v_j = w_j + alpha_{j-1} v_{j-1} - C_{j-2} v_{j-2}, alpha_j = a_j + b_j usq,
// with the readout weights w (Qbfs: w_0 = w_1 = 2, alpha = 2 - 4 usq, C = 1;
// a Q2D group: w_0 = 1/2, w_3 = -2/5 for m = 1 and more than 3 terms). So
// the adjoint needs no stored alphas: one forward pass gives v_j, v_j' and
// v_j'' (by usq), adds gs v_j + gd v_j' to each coefficient's cotangent for
// the cotangents (gs, gd) of (S, S'), and returns S' and S''.
__device__ __forceinline__ void clenshaw_adjoint(
        const float* d, int ln, bool qbfs, const float* ta, const float* tb,
        const float* tc, int m, float usq, float gs, float gd, float* da,
        float& S1, float& S2) {
    float v1 = 0.0f, v2 = 0.0f, p1 = 0.0f, p2 = 0.0f, q1 = 0.0f, q2 = 0.0f;
    S1 = S2 = 0.0f;
    for (int j = 0; j < ln; ++j) {
        float v = qbfs ? (j < 2 ? 2.0f : 0.0f)
                       : (j == 0 ? 0.5f : (j == 3 && m == 1 && ln > 3 ? -0.4f
                                                                      : 0.0f));
        float p = 0.0f, q = 0.0f;
        if (j >= 1) {
            const float al = qbfs ? 2.0f - 4.0f * usq : ta[j - 1] + tb[j - 1] * usq;
            const float alp = qbfs ? -4.0f : tb[j - 1];
            v += al * v1;
            p += alp * v1 + al * p1;
            q += 2.0f * alp * p1 + al * q1;
            if (j >= 2) {
                const float cc = qbfs ? 1.0f : tc[j - 2];
                v -= cc * v2;
                p -= cc * p2;
                q -= cc * q2;
            }
        }
        da[j] += gs * v + gd * p;
        S1 += d[j] * p;
        S2 += d[j] * q;
        v2 = v1;
        v1 = v;
        p2 = p1;
        p1 = p;
        q2 = q1;
        q1 = q;
    }
}

// forbes_sigma: factor = nf / df, deriv = c2 rho / (nf df^3), nf = sqrt(num >
// 0 ? num : 1e-12), df = sqrt(den > 0 ? den : 1e-12), num = 1 - k c2 r2,
// den = 1 - (k + 1) c2 r2, c2 = ri^2
__device__ __forceinline__ void forbes_sigma_adjoint(
        float ri, float k, float r2, float rho, float dfac, float dder,
        float& dri, float& dk, float& dr2, float& drho) {
    const float c2 = mul(ri, ri);
    const float num = sub(1.0f, mul(mul(k, c2), r2));
    const float den = sub(1.0f, mul(mul(add(k, 1.0f), c2), r2));
    const bool okn = num > 0.0f, okd = den > 0.0f;
    const float nf = sqt(okn ? num : 1e-12f), df = sqt(okd ? den : 1e-12f);
    const float qd = nf * df * df * df;
    const float deriv = c2 * rho / qd;
    const float dnf = dfac / df - dder * deriv / nf;
    const float ddf = -dfac * nf / (df * df) - 3.0f * dder * deriv / df;
    float dc2 = dder * rho / qd;
    drho += dder * c2 / qd;
    const float dnum = okn ? dnf / (2.0f * nf) : 0.0f;
    const float dden = okd ? ddf / (2.0f * df) : 0.0f;
    dk -= (dnum + dden) * c2 * r2;
    dc2 -= dnum * k * r2 + dden * (k + 1.0f) * r2;
    dr2 -= dnum * k * c2 + dden * (k + 1.0f) * c2;
    dri += 2.0f * ri * dc2;
}

// The radial part shared by both Forbes sags: dS = dpref factor P + B dfac P
// + B factor dP_drho with dpref = (2u - 4u usq) / nr, B = usq - usq^2 and
// dP_drho = 2 P' u / nr, for the cotangent dA of dS: adds to the cotangents
// of factor, dfac, P, P', u, usq and nr.
__device__ __forceinline__ void forbes_radial_adjoint(
        float u, float usq, float nr, float factor, float dfac, float P,
        float Pd, float dA, float& dfactor, float& ddfac, float& dP,
        float& dPd, float& du, float& dusq, float& dnr) {
    const float B = usq - usq * usq;
    const float dpref = (2.0f * u - 4.0f * u * usq) / nr;
    const float dpd = 2.0f * Pd * u / nr;
    const float d_dpref = dA * factor * P;
    dfactor += dA * (dpref * P + B * dpd);
    dP += dA * (dpref * factor + B * dfac);
    const float dB = dA * (dfac * P + factor * dpd);
    ddfac += dA * B * P;
    const float d_dpd = dA * B * factor;
    dPd += d_dpd * 2.0f * u / nr;
    du += d_dpd * 2.0f * Pd / nr + d_dpref * (2.0f - 4.0f * usq) / nr;
    dnr -= d_dpd * dpd / nr + d_dpref * dpref / nr;
    dusq += dB * (1.0f - 2.0f * usq) - d_dpref * 4.0f * u / nr;
}

// qbfs_sag_grad's adjoint
__device__ __forceinline__ void qbfs_sag_adjoint(
        const float* c, const float* ac, int nu, float xx, float yy, float ds,
        float dgx, float dgy, float& dxx, float& dyy, float& dri,
        float& dconic, float& dnr, float* da) {
    conic_base_adjoint(c[0], c[1], xx, yy, ds, dgx, dgy, dxx, dyy, dri, dconic);
    if (nu == 0) return;
    const float nr = c[24];
    const float r2 = add(mul(xx, xx), mul(yy, yy));
    const float rho = sqt(add(r2, 1e-12f));
    const float u = dvd(rho, nr);
    const float usq_s = dvd(r2, mul(nr, nr));
    const float usq = mul(u, u);
    float factor, dfac, poly_s, dps, poly_g, dpoly;
    forbes_sigma(c[0], c[1], r2, rho, factor, dfac);
    qbfs_sum(ac, nu, usq_s, poly_s, dps);
    qbfs_sum(ac, nu, usq, poly_g, dpoly);
    const bool in_g = !(u >= 1.0f);
    const float B = usq - usq * usq;
    const float dS = in_g ? (2.0f * u - 4.0f * u * usq) / nr * factor * poly_g
                            + B * dfac * poly_g + B * factor * 2.0f * dpoly * u / nr
                          : 0.0f;
    const float inv_rho = 1.0f / rho;
    const float gr = dgx * xx + dgy * yy;
    dxx += dgx * dS * inv_rho;
    dyy += dgy * dS * inv_rho;
    float drho = -(gr * dS) * inv_rho * inv_rho;
    float dfactor = 0.0f, ddfac = 0.0f, dpg = 0.0f, ddp = 0.0f, du = 0.0f,
          dusq = 0.0f, dr2 = 0.0f;
    if (in_g)
        forbes_radial_adjoint(u, usq, nr, factor, dfac, poly_g, dpoly,
                              gr * inv_rho, dfactor, ddfac, dpg, ddp, du, dusq,
                              dnr);
    float S1, S2;
    clenshaw_adjoint(ac, nu, true, nullptr, nullptr, nullptr, 0, usq, dpg, ddp,
                     da, S1, S2);
    dusq += dpg * S1 + ddp * S2;
    if (!(usq_s > 1.0f)) {                     // the sag's departure
        const float w = usq_s * (1.0f - usq_s);
        float dus = ds * (1.0f - 2.0f * usq_s) * factor * poly_s;
        dfactor += ds * w * poly_s;
        const float dps_c = ds * w * factor;
        clenshaw_adjoint(ac, nu, true, nullptr, nullptr, nullptr, 0, usq_s,
                         dps_c, 0.0f, da, S1, S2);
        dus += dps_c * S1;
        dr2 += dus / (nr * nr);
        dnr -= 2.0f * dus * usq_s / nr;
    }
    du += 2.0f * u * dusq;
    drho += du / nr;
    dnr -= du * u / nr;
    forbes_sigma_adjoint(c[0], c[1], r2, rho, dfactor, ddfac, dri, dconic, dr2,
                         drho);
    dr2 += drho / (2.0f * rho);
    dxx += 2.0f * xx * dr2;
    dyy += 2.0f * yy * dr2;
}

// q2d_sag_grad's adjoint: the forward's sums are recomputed, then walked
// back group by group; cos m t = T_m(c) and sin m t = s U_{m-1}(c) give the
// angle's cotangents through (c, s) = (x, y) / r
__device__ __forceinline__ void q2d_sag_adjoint(
        const float* c, const float* ac, int nu, float xx, float yy, float ds,
        float dgx, float dgy, float& dxx, float& dyy, float& dri,
        float& dconic, float& dnr, float* da) {
    conic_base_adjoint(c[0], c[1], xx, yy, ds, dgx, dgy, dxx, dyy, dri, dconic);
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
    const float cost = ok ? xx / rho2 : 1.0f;
    const float sint = ok ? yy / rho2 : 0.0f;
    int n_m0 = 0;
    while (n_m0 < nu && code[n_m0] == 0.0f) ++n_m0;
    const int max_m = nu > n_m0 ? (int)code[nu - 1] / 2 : 0;
    float s_m0 = 0.0f, ds_dusq = 0.0f;
    if (n_m0) qbfs_sum(ac, n_m0, usq, s_m0, ds_dusq);
    // the forward's sums over m, by the same recurrences
    float poly = 0.0f, dr = 0.0f, dt = 0.0f;
    {
        float c0 = 1.0f, c1 = cost, s0 = 0.0f, s1 = sint, upm1 = 1.0f, upm = u;
        int off = n_m0;
        for (int m = 1; m <= max_m; ++m) {
            if (m >= 2) {
                const float cn = 2.0f * cost * c1 - c0, sn = 2.0f * cost * s1 - s0;
                c0 = c1;
                c1 = cn;
                s0 = s1;
                s1 = sn;
                upm1 = upm;
                upm *= u;
            }
            float sv[2] = {0.0f, 0.0f}, spv[2] = {0.0f, 0.0f};
            for (int b = 0; b < 2; ++b) {
                int ln = 0;
                while (off + ln < nu && (int)code[off + ln] == 2 * m + b) ++ln;
                if (!ln) continue;
                q2d_group(ac + off, ta + off, tb + off, tc + off, ln, m, usq,
                          sv[b], spv[b]);
                off += ln;
            }
            const float fm = (float)m;
            poly += upm * (c1 * sv[0] + s1 * sv[1]);
            dr += upm1 * (c1 * (2.0f * usq * spv[0] + fm * sv[0])
                          + s1 * (2.0f * usq * spv[1] + fm * sv[1]));
            dt += fm * upm * (-sv[0] * s1 + sv[1] * c1);
        }
    }
    float factor, dfac;
    forbes_sigma(c[0], c[1], r2, rho, factor, dfac);
    const bool in_g = !(u >= 1.0f);
    const float B = usq - usq * usq;
    const float dpref = (2.0f * u - 4.0f * u * usq) / nr;
    const float dS0 = dpref * factor * s_m0 + B * dfac * s_m0
                      + B * factor * 2.0f * ds_dusq * u / nr;
    const float dSr = in_g ? dS0 + dfac * poly + factor * dr / nr : 0.0f;
    const float dSt = in_g ? factor * dt : 0.0f;
    const float ir = 1.0f / rho;
    const float gr = dgx * xx + dgy * yy, gt = dgy * xx - dgx * yy;
    dxx += dgx * dSr * ir + dgy * dSt * ir * ir;
    dyy += dgy * dSr * ir - dgx * dSt * ir * ir;
    float drho = -(dSr * gr + 2.0f * ir * dSt * gt) * ir * ir;
    const float dA = in_g ? gr * ir : 0.0f;
    const float dT = in_g ? gt * ir * ir : 0.0f;
    float dfactor = dT * dt, ddfac = dA * poly, dpoly = dA * dfac;
    const float ddt = dT * factor, ddr = dA * factor / nr;
    dfactor += dA * dr / nr;
    dnr -= dA * factor * dr / (nr * nr);
    float dsm0 = 0.0f, ddsd = 0.0f, du = 0.0f, dusq = 0.0f, dr2 = 0.0f;
    forbes_radial_adjoint(u, usq, nr, factor, dfac, s_m0, ds_dusq, dA, dfactor,
                          ddfac, dsm0, ddsd, du, dusq, dnr);
    if (!(u > 1.0f)) {                         // the sag's departure
        dusq += ds * (1.0f - 2.0f * usq) * factor * s_m0;
        dfactor += ds * (usq * (1.0f - usq) * s_m0 + poly);
        dsm0 += ds * usq * (1.0f - usq) * factor;
        dpoly += ds * factor;
    }
    float S1, S2;
    if (n_m0) {
        clenshaw_adjoint(ac, n_m0, true, nullptr, nullptr, nullptr, 0, usq,
                         dsm0, ddsd, da, S1, S2);
        dusq += dsm0 * S1 + ddsd * S2;
    }
    // the groups, with U_{m-1}(c), U_{m-2}(c) and their derivatives
    float dcost = 0.0f, dsint = 0.0f;
    float U1 = 1.0f, U2 = 0.0f, dU1 = 0.0f, dU2 = 0.0f;
    float upm2 = 0.0f, upm1 = 1.0f, upm = u;
    int off = n_m0;
    for (int m = 1; m <= max_m; ++m) {
        if (m >= 2) {
            const float Un = 2.0f * cost * U1 - U2;
            const float dUn = 2.0f * U1 + 2.0f * cost * dU1 - dU2;
            U2 = U1;
            U1 = Un;
            dU2 = dU1;
            dU1 = dUn;
            upm2 = upm1;
            upm1 = upm;
            upm *= u;
        }
        const float cs = cost * U1 - U2, sn = sint * U1, fm = (float)m;
        int offs[2] = {off, off}, lns[2] = {0, 0};
        float sv[2] = {0.0f, 0.0f}, spv[2] = {0.0f, 0.0f};
        for (int b = 0; b < 2; ++b) {
            offs[b] = off;
            while (off + lns[b] < nu && (int)code[off + lns[b]] == 2 * m + b)
                ++lns[b];
            if (!lns[b]) continue;
            q2d_group(ac + off, ta + off, tb + off, tc + off, lns[b], m, usq,
                      sv[b], spv[b]);
            off += lns[b];
        }
        const float ea = 2.0f * usq * spv[0] + fm * sv[0];
        const float eb = 2.0f * usq * spv[1] + fm * sv[1];
        const float Ua = cs * sv[0] + sn * sv[1];
        const float DR = cs * ea + sn * eb;
        const float DT = -sv[0] * sn + sv[1] * cs;
        du += (dpoly * Ua + ddt * fm * DT) * fm * upm1
              + (m >= 2 ? ddr * DR * (fm - 1.0f) * upm2 : 0.0f);
        const float dUa = dpoly * upm, dDR = ddr * upm1, dDT = ddt * fm * upm;
        const float dcs = dUa * sv[0] + dDR * ea + dDT * sv[1];
        const float dsn = dUa * sv[1] + dDR * eb - dDT * sv[0];
        const float dsv[2] = {dUa * cs + dDR * cs * fm - dDT * sn,
                              dUa * sn + dDR * sn * fm + dDT * cs};
        const float dspv[2] = {dDR * cs * 2.0f * usq, dDR * sn * 2.0f * usq};
        dusq += dDR * (2.0f * cs * spv[0] + 2.0f * sn * spv[1]);
        for (int b = 0; b < 2; ++b) {
            if (!lns[b]) continue;
            const int o = offs[b];
            clenshaw_adjoint(ac + o, lns[b], false, ta + o, tb + o, tc + o, m,
                             usq, dsv[b], dspv[b], da + o, S1, S2);
            dusq += dsv[b] * S1 + dspv[b] * S2;
        }
        dcost += dcs * fm * U1 + dsn * sint * dU1;
        dsint += dsn * U1;
    }
    if (ok) {                                  // (c, s) = (x, y) / r
        const float irs = 1.0f / rho2;
        const float drs = -(dcost * cost + dsint * sint) * irs;
        dxx += dcost * irs + drs * xx * irs;
        dyy += dsint * irs + drs * yy * irs;
    }
    du += 2.0f * u * dusq;
    drho += du / nr;
    dnr -= du * u / nr;
    forbes_sigma_adjoint(c[0], c[1], r2, rho, dfactor, ddfac, dri, dconic, dr2,
                         drho);
    dr2 += drho / (2.0f * rho);
    dxx += 2.0f * xx * dr2;
    dyy += 2.0f * yy * dr2;
}

// The Newton sags' adjoint dispatch (sag_grad's): d24, d25 take the
// cotangents of columns 24 and 25.
template <int VAR>
__device__ __forceinline__ void sag_adjoint(
        int gk, int fl, const float* c, const float* ac, const float* ztab,
        float xx, float yy, float ds, float dgx, float dgy, float& dxx,
        float& dyy, float& dri, float& dconic, float& d24, float& d25,
        float* da) {
    const int nu = nu_of(fl);
    if (VAR < VAR_FREEFORM || gk == GK_EVEN || gk == GK_ODD)
        asphere_sag_adjoint(c[0], c[1], ac, nu, gk == GK_ODD, xx, yy, ds, dgx,
                            dgy, dxx, dyy, dri, dconic, da);
    else if (gk == GK_POLY)
        poly_sag_adjoint(c, ac, nu, nv_of(fl), xx, yy, ds, dgx, dgy, dxx, dyy,
                         dri, dconic, da);
    else if (gk == GK_CHEB)
        cheb_sag_adjoint(c, ac, nu, nv_of(fl), xx, yy, ds, dgx, dgy, dxx, dyy,
                         dri, dconic, d24, d25, da);
    else if (gk == GK_BICONIC) {
        axis_conic_adjoint(c[0], c[1], yy, ds, dgy, dyy, dri, dconic);
        axis_conic_adjoint(c[24], c[25], xx, ds, dgx, dxx, d24, d25);
    } else if (gk == GK_TORUS || gk == GK_TORUS_INF)
        toroidal_sag_adjoint(c, ac, nu, gk == GK_TORUS_INF, xx, yy, ds, dgx,
                             dgy, dxx, dyy, dri, dconic, d24, da);
    else if (VAR == VAR_FORBES && gk == GK_QBFS)
        qbfs_sag_adjoint(c, ac, nu, xx, yy, ds, dgx, dgy, dxx, dyy, dri,
                         dconic, d24, da);
    else if (VAR == VAR_FORBES && gk == GK_Q2D)
        q2d_sag_adjoint(c, ac, nu, xx, yy, ds, dgx, dgy, dxx, dyy, dri, dconic,
                        d24, da);
    else
        zernike_sag_adjoint(c, ac, nu,
                            ztab + (size_t)basis_of(fl) * MAX_TERMS * ZT_W, xx,
                            yy, ds, dgx, dgy, dxx, dyy, dri, dconic, d24, da);
}

// ---- the polarization chain's adjoints (sub-slice (e)) ----------------------
// Each surface's update of the E-vectors (gen_trace_common.cuh::
// polar_surface, polar_apply) is recomputed from the tape's directions and
// normal and the stored incoming vectors, then run back; a cross product
// c = a x b sends the cotangent gc to a as b x gc and to b as gc x a.

__device__ __forceinline__ void cross_acc(float ax, float ay, float az,
                                          float bx, float by, float bz,
                                          float* o) {
    o[0] += ay * bz - az * by;
    o[1] += az * bx - ax * bz;
    o[2] += ax * by - ay * bx;
}

// Adjoint of fresnel_diag: adds to (dcos, dn1, dn2) for the cotangents
// (gjs, gjp) of (js, jp), from the forward's intermediates in b; the
// clamped root gets none on its clamp.
__device__ __forceinline__ void fresnel_diag_adjoint(const PolSurf& b,
                                                     float n1, float c,
                                                     bool refl, float gjs,
                                                     float gjp, float& dcos,
                                                     float& dn1, float& dn2) {
    float gc = 0.0f, groot = 0.0f, gn2c = 0.0f, gda = 0.0f, gdb = 0.0f,
          ginv = 0.0f, gn = 0.0f;
    if (refl) {
        // js = ((c - root) db) finv, jp = -(((n2c - root) da) finv)
        const float gjr = -gjp;
        const float cm = c - b.root, nm = b.n2c - b.root;
        const float gcm = gjs * b.db * b.finv;
        gdb += gjs * cm * b.finv;
        ginv += gjs * cm * b.db;
        const float gnm = gjr * b.da * b.finv;
        gda += gjr * nm * b.finv;
        ginv += gjr * nm * b.da;
        gc += gcm;
        groot -= gcm + gnm;
        gn2c += gnm;
    } else {
        // js = ((2 c) db) finv, jp = (((2 n) c) da) finv
        gc += 2.0f * gjs * b.db * b.finv;
        gdb += gjs * 2.0f * c * b.finv;
        ginv += gjs * 2.0f * c * b.db;
        const float t = 2.0f * b.n * c;
        gn += gjp * 2.0f * c * b.da * b.finv;
        gc += gjp * 2.0f * b.n * b.da * b.finv;
        gda += gjp * t * b.finv;
        ginv += gjp * t * b.da;
    }
    // finv = 1 / (da db), da = c + root, db = n2c + root, n2c = (n n) c
    const float gprod = -ginv * b.finv * b.finv;
    gda += gprod * b.db;
    gdb += gprod * b.da;
    gc += gda;
    groot += gda + gdb;
    gn2c += gdb;
    gn += gn2c * c * 2.0f * b.n;
    gc += gn2c * b.n * b.n;
    // root = sqrt(rad > eps ? rad : eps), rad = n n - (1 - c c)
    const float grad = b.rad > EPS_GUARD ? groot / (2.0f * b.root) : 0.0f;
    gn += 2.0f * b.n * grad;
    gc += 2.0f * c * grad;
    // n = n2 / n1
    dn2 += gn / n1;
    dn1 -= gn * b.n / n1;
    dcos += gc;
}

// Adjoint of the s/p form, E' = ds s + dp p1 + dk k1 with ds = js (s.E),
// dp = jp (p0.E), dk = j3 (k0.E), on the forward's basis b (its fallback
// and guarded roots; polar_adjoint).
__device__ __forceinline__ void sp_adjoint(
        const PolSurf& b, bool plane, bool refl, float n1, float cos_i,
        float L0, float M0, float N0, float L1, float M1, float N1, float nx,
        float ny, float nz, const float (*ein)[3], float (*g)[3], int nev,
        float* gk0, float* gk1, float* gn, float& gcos, float& dn1,
        float& dn2) {
    // s' (s before the normalization) and the coefficients of a bare mirror
    const float spx = b.fb ? 0.0f : b.sx0, spy = b.fb ? N0 : b.sy0,
                spz = b.fb ? -M0 : b.sz0;
    const float js = b.fres ? b.js : 1.0f, jp = b.fres ? b.jp : 1.0f,
                j3 = b.fres ? b.j3 : 1.0f;
    float gs[3] = {0.0f, 0.0f, 0.0f}, gp0[3] = {0.0f, 0.0f, 0.0f},
          gp1[3] = {0.0f, 0.0f, 0.0f}, hk0[3] = {0.0f, 0.0f, 0.0f},
          hk1[3] = {0.0f, 0.0f, 0.0f}, hn[3] = {0.0f, 0.0f, 0.0f},
          gjs = 0.0f, gjp = 0.0f;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
        if (v >= nev) break;
        const float ex = ein[v][0], ey = ein[v][1], ez = ein[v][2];
        const float Gx = g[v][0], Gy = g[v][1], Gz = g[v][2];
        const float dsr = b.sx * ex + b.sy * ey + b.sz * ez;
        const float dpr = b.p0x * ex + b.p0y * ey + b.p0z * ez;
        const float dkr = L0 * ex + M0 * ey + N0 * ez;
        const float ds = js * dsr, dp = jp * dpr, dk = j3 * dkr;
        const float gds = Gx * b.sx + Gy * b.sy + Gz * b.sz;
        const float gdp = Gx * b.p1x + Gy * b.p1y + Gz * b.p1z;
        const float gdk = Gx * L1 + Gy * M1 + Gz * N1;
        gs[0] += ds * Gx;
        gs[1] += ds * Gy;
        gs[2] += ds * Gz;
        gp1[0] += dp * Gx;
        gp1[1] += dp * Gy;
        gp1[2] += dp * Gz;
        hk1[0] += dk * Gx;
        hk1[1] += dk * Gy;
        hk1[2] += dk * Gz;
        gjs += gds * dsr;
        gjp += gdp * dpr;
        const float gdsr = gds * js, gdpr = gdp * jp, gdkr = gdk * j3;
        gs[0] += gdsr * ex;
        gs[1] += gdsr * ey;
        gs[2] += gdsr * ez;
        gp0[0] += gdpr * ex;
        gp0[1] += gdpr * ey;
        gp0[2] += gdpr * ez;
        hk0[0] += gdkr * ex;
        hk0[1] += gdkr * ey;
        hk0[2] += gdkr * ez;
        g[v][0] = gdsr * b.sx + gdpr * b.p0x + gdkr * L0;
        g[v][1] = gdsr * b.sy + gdpr * b.p0y + gdkr * M0;
        g[v][2] = gdsr * b.sz + gdpr * b.p0z + gdkr * N0;
    }
    // p1 = k1 x s, p0 = k0 x s
    cross_acc(b.sx, b.sy, b.sz, gp1[0], gp1[1], gp1[2], hk1);
    cross_acc(gp1[0], gp1[1], gp1[2], L1, M1, N1, gs);
    cross_acc(b.sx, b.sy, b.sz, gp0[0], gp0[1], gp0[2], hk0);
    cross_acc(gp0[0], gp0[1], gp0[2], L0, M0, N0, gs);
    // s = s' inv, inv = 1 / sqrt(|s'|^2 > 0 ? |s'|^2 : 1)
    float gsp[3] = {gs[0] * b.inv, gs[1] * b.inv, gs[2] * b.inv};
    const float ginv = gs[0] * spx + gs[1] * spy + gs[2] * spz;
    const float gm2 = b.mag2f > 0.0f ? -ginv * b.inv * b.inv / (2.0f * b.sq)
                                     : 0.0f;
    if (b.fb) {
        // s' = (0, N0, -M0), |s'|^2 = N0 N0 + M0 M0
        hk0[2] += gsp[1] + 2.0f * N0 * gm2;
        hk0[1] += -gsp[2] + 2.0f * M0 * gm2;
    } else if (plane) {
        // s' = (-M0, L0, 0), |s'|^2 = L0 L0 + M0 M0
        hk0[0] += gsp[1] + 2.0f * L0 * gm2;
        hk0[1] += -gsp[0] + 2.0f * M0 * gm2;
    } else {
        // s' = k0 x n
        gsp[0] += 2.0f * b.sx0 * gm2;
        gsp[1] += 2.0f * b.sy0 * gm2;
        gsp[2] += 2.0f * b.sz0 * gm2;
        cross_acc(nx, ny, nz, gsp[0], gsp[1], gsp[2], hk0);
        cross_acc(gsp[0], gsp[1], gsp[2], L0, M0, N0, hn);
    }
    for (int j = 0; j < 3; ++j) {
        gk0[j] += hk0[j];
        gk1[j] += hk1[j];
        gn[j] += hn[j];
    }
    if (b.fres)
        fresnel_diag_adjoint(b, n1, cos_i, refl, gjs, gjp, gcos, dn1, dn2);
}

// Adjoint of one surface's update of the vectors ein[v], v < nev, with the
// basis b (polar_surface's, recomputed; its branches): g[v] holds the
// cotangent of the updated vector on entry and of ein[v] on return; adds
// the cotangents of k0 = (L0, M0, N0) (gk0), k1 (gk1), the normal (gn),
// cos_i (gcos), n1 and n2. The fallback's where and the guarded roots pass
// their cotangents to the taken branch only (the double where). Both forms
// run in float32, as autograd through the plain version does: near normal
// incidence the s basis's derivative grows as 1 / |k0 x n|, and so does
// the float32 rounding of its cotangent, in the kernel and the plain
// version alike.
__device__ __forceinline__ void polar_adjoint(
        const PolSurf& b, bool plane, bool refl, float n1, float cos_i,
        float L0, float M0, float N0, float L1, float M1, float N1, float nx,
        float ny, float nz, const float (*ein)[3], float (*g)[3], int nev,
        float* gk0, float* gk1, float* gn, float& gcos, float& dn1,
        float& dn2) {
    if (!b.rod) {
        sp_adjoint(b, plane, refl, n1, cos_i, L0, M0, N0, L1, M1, N1, nx, ny,
                   nz, ein, g, nev, gk0, gk1, gn, gcos, dn1, dn2);
        return;
    }
    // E' = ct E + u x E + u ue, ue = (u.E) inv1c, inv1c = 1 / (1 + ct),
    // ct = k0.k1, u = k0 x k1
    float gu[3] = {0.0f, 0.0f, 0.0f}, gct = 0.0f, ginv1c = 0.0f;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
        if (v >= nev) break;
        const float ex = ein[v][0], ey = ein[v][1], ez = ein[v][2];
        const float Gx = g[v][0], Gy = g[v][1], Gz = g[v][2];
        const float uE = b.ux * ex + b.uy * ey + b.uz * ez;
        const float ue = uE * b.inv1c;
        gct += Gx * ex + Gy * ey + Gz * ez;
        float h[3] = {b.ct * Gx, b.ct * Gy, b.ct * Gz};
        cross_acc(ex, ey, ez, Gx, Gy, Gz, gu);             // E x G
        cross_acc(Gx, Gy, Gz, b.ux, b.uy, b.uz, h);        // G x u
        gu[0] += ue * Gx;
        gu[1] += ue * Gy;
        gu[2] += ue * Gz;
        const float gue = Gx * b.ux + Gy * b.uy + Gz * b.uz;
        const float guE = gue * b.inv1c;
        ginv1c += gue * uE;
        gu[0] += guE * ex;
        gu[1] += guE * ey;
        gu[2] += guE * ez;
        g[v][0] = h[0] + guE * b.ux;
        g[v][1] = h[1] + guE * b.uy;
        g[v][2] = h[2] + guE * b.uz;
    }
    gct -= ginv1c * b.inv1c * b.inv1c;
    gk0[0] += gct * L1;
    gk0[1] += gct * M1;
    gk0[2] += gct * N1;
    gk1[0] += gct * L0;
    gk1[1] += gct * M0;
    gk1[2] += gct * N0;
    cross_acc(L1, M1, N1, gu[0], gu[1], gu[2], gk0);       // k1 x gu
    cross_acc(gu[0], gu[1], gu[2], L0, M0, N0, gk1);       // gu x k0
}

// Adjoint of polar_init: adds to (aL, aM, aN) the launch direction's
// cotangents and to dw the weight's, for the cotangents g[v] of the launch
// vectors.
__device__ __forceinline__ void polar_init_adjoint(const float* gen_row,
                                                   float L, float M, float N,
                                                   float w,
                                                   const PolLaunch& pl,
                                                   const float (*g)[3],
                                                   float& aL, float& aM,
                                                   float& aN, float& dw) {
    const float m2 = add(mul(N, N), mul(M, M));
    const float sqm = sqt(m2 > 0.0f ? m2 : 1.0f);
    const float inv = dvd(1.0f, sqm);
    const float pxv = mul(0.0f, inv), pyv = mul(N, inv), pzv = mul(-M, inv);
    const float sxv = sub(mul(pyv, N), mul(pzv, M));
    const float syv = sub(mul(pzv, L), mul(pxv, N));
    const float szv = sub(mul(pxv, M), mul(pyv, L));
    const bool apod = (int)gen_row[11] > 1;
    const float sa = w > 0.0f ? sqt(w) : 0.0f;
    float gsv[3] = {0.0f, 0.0f, 0.0f}, gpv[3] = {0.0f, 0.0f, 0.0f},
          gk[3] = {0.0f, 0.0f, 0.0f}, gsa = 0.0f;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
        if (v >= pl.nev) break;
        const float a = pl.a[v], bb = pl.b[v];
        float G[3] = {g[v][0], g[v][1], g[v][2]};
        if (apod) {
            gsa += G[0] * (a * sxv + bb * pxv) + G[1] * (a * syv + bb * pyv)
                   + G[2] * (a * szv + bb * pzv);
            G[0] *= sa;
            G[1] *= sa;
            G[2] *= sa;
        }
        for (int j = 0; j < 3; ++j) {
            gsv[j] += a * G[j];
            gpv[j] += bb * G[j];
        }
    }
    // s = p x k
    cross_acc(L, M, N, gsv[0], gsv[1], gsv[2], gpv);
    cross_acc(gsv[0], gsv[1], gsv[2], pxv, pyv, pzv, gk);
    // p = (0 inv, N inv, (-M) inv): no cotangent reaches inv through 0 inv
    gk[2] += gpv[1] * inv;
    gk[1] -= gpv[2] * inv;
    const float ginv = gpv[1] * N - gpv[2] * M;
    // inv = 1 / sqrt(m2 > 0 ? m2 : 1), m2 = N N + M M
    const float gm2 = m2 > 0.0f ? -ginv * inv * inv / (2.0f * sqm) : 0.0f;
    aL += gk[0];
    aM += gk[1] + 2.0f * M * gm2;
    aN += gk[2] + 2.0f * N * gm2;
    // sqrt(w) where w > 0
    if (apod && w > 0.0f) dw += gsa * 0.5f / sa;
}

// ---- the diffractive surfaces' adjoint (sub-slice (f)) ---------------------
// Reverse of doe_forward and of surface_step's updates with it, from the
// landed point (x, y) and the incoming direction (L, M, N) of the tape: the
// intermediates are recomputed (doe_forward), then run back. (gLo, gMo,
// gNo) are the cotangents of the new direction; a phase surface's take
// a.inten and a.opd (and a.opdc in the Kahan mode) from after its update
// to before it. Adds to (ax, ay) the landed point's cotangents, to (aL, aM,
// aN) the incoming direction's, to (dri, dconic, dn1, dn2) and (d24, d25,
// d7) those of consts columns 0, 1, 3, 4 and 24, 25, 7, to da a radial
// profile's terms'.
template <int MODE>
__device__ __forceinline__ void doe_adjoint(
        const float* c, const float* ac, int fl, float x, float y, float L,
        float M, float N, float gLo, float gMo, float gNo, Adj& a, float& ax,
        float& ay, float& aL, float& aM, float& aN, float& dri,
        float& dconic, float& dn1, float& dn2, float& d24, float& d25,
        float& d7, float* da) {
    DoeTape d;
    doe_forward(c, ac, fl, x, y, L, M, N, d);
    const float n1 = c[3], n2 = c[4];
    const bool refl = (fl & FLAG_REFL) != 0;
    // (Lo, Mo, No) = (ox, oy, oz) oinv, oinv = 1 / sqrt(o.o)
    const float goinv = gLo * d.ox + gMo * d.oy + gNo * d.oz;
    const float goo = -goinv * d.oinv * d.oinv / (2.0f * d.osq);
    const float gox = gLo * d.oinv + 2.0f * d.ox * goo;
    const float goy = gMo * d.oinv + 2.0f * d.oy * goo;
    const float goz = gNo * d.oinv + 2.0f * d.oz * goo;
    float gnx = 0.0f, gny = 0.0f, gnz = 0.0f, gdfdx = 0.0f, gdfdy = 0.0f;
    if (inter_of(fl) == INTER_GRATING) {
        // o = (t2 + kn na) / den, den = +-n2, kn = +-sqrt(ok ? disc : 1)
        const float gax = gox / d.den, gay = goy / d.den, gaz = goz / d.den;
        const float gden = -(gox * d.ox + goy * d.oy + goz * d.oz) / d.den;
        float gtx2 = gax, gty2 = gay, gtz2 = gaz;
        const float gkn = gax * d.nxa + gay * d.nya + gaz * d.nza;
        float gnxa = gax * d.kn, gnya = gay * d.kn, gnza = gaz * d.kn;
        dn2 += refl ? -gden : gden;
        const float gkn0 = refl ? -gkn : gkn;
        // disc = n2^2 - t2.t2; no cotangent from a lost ray's guarded root
        const float gdisc = d.ok ? gkn0 / (2.0f * d.kn0) : 0.0f;
        dn2 += 2.0f * n2 * gdisc;
        gtx2 -= 2.0f * d.tx2 * gdisc;
        gty2 -= 2.0f * d.ty2 * gdisc;
        gtz2 -= 2.0f * d.tz2 * gdisc;
        // t2 = k - kdn na + g f
        const float gkdn = -(gtx2 * d.nxa + gty2 * d.nya + gtz2 * d.nza);
        gnxa -= gtx2 * d.kdn;
        gnya -= gty2 * d.kdn;
        gnza -= gtz2 * d.kdn;
        const float gg = gtx2 * d.fx + gty2 * d.fy + gtz2 * d.fz;
        float gfx = gtx2 * d.g, gfy = gty2 * d.g, gfz = gtz2 * d.g;
        // kdn = k . na; k = n1 (L, M, N)
        const float gkx = gtx2 + gkdn * d.nxa, gky = gty2 + gkdn * d.nya,
                    gkz = gtz2 + gkdn * d.nza;
        gnxa += gkdn * d.kx;
        gnya += gkdn * d.ky;
        gnza += gkdn * d.kz;
        aL += gkx * n1;
        aM += gky * n1;
        aN += gkz * n1;
        dn1 += gkx * L + gky * M + gkz * N;
        // na = +-n: no cotangent through the sign
        gnx += d.flip ? gnxa : -gnxa;
        gny += d.flip ? gnya : -gnya;
        gnz += d.flip ? gnza : -gnza;
        // g = c24 sqrt(fx^2 + fy^2)
        d24 += gg * d.gsq;
        const float gfxy = gg * c[24] / (2.0f * d.gsq);
        gfx += 2.0f * d.fx * gfxy;
        gfy += 2.0f * d.fy * gfxy;
        // f = -f0 finv, finv = 1 / sqrt(f0.f0)
        const float gfinv = -(gfx * d.fx0 + gfy * d.fy0 + gfz * d.fz0);
        const float gff = -gfinv * d.finv * d.finv / (2.0f * d.fsq);
        const float gfx0 = -gfx * d.finv + 2.0f * d.fx0 * gff;
        const float gfy0 = -gfy * d.finv + 2.0f * d.fy0 * gff;
        const float gfz0 = -gfz * d.finv + 2.0f * d.fz0 * gff;
        // f0 = n x tg
        gnx += gfz0 * d.tgy - gfy0 * d.tgz;
        gny += gfx0 * d.tgz - gfz0 * d.tgx;
        gnz += gfy0 * d.tgx - gfx0 * d.tgy;
        const float gtgx = gfy0 * d.nz - gfz0 * d.ny;
        const float gtgy = gfz0 * d.nx - gfx0 * d.nz;
        const float gtgz = gfx0 * d.ny - gfy0 * d.nx;
        // tg = (1, ta, tz0) tinv, tinv = 1 / sqrt(1 + ta^2 + tz0^2)
        const float gtinv = gtgx + gtgy * d.ta + gtgz * d.tz0;
        const float gtt = -gtinv * d.tinv * d.tinv / (2.0f * d.tsq);
        float gta = gtgy * d.tinv + 2.0f * d.ta * gtt;
        const float gtz0 = gtgz * d.tinv + 2.0f * d.tz0 * gtt;
        // tz0 = dfdx + ta dfdy
        gdfdx = gtz0;
        gdfdy = gtz0 * d.ta;
        gta += gtz0 * d.dfdy;
        d25 += gta;
    } else {
        // intensity: (inten mask) eff; the mask and the efficiency are
        // constants
        a.inten = a.inten * c[EFF_COL] * d.mask;
        // the OPD shift, plain or compensated (surface_adjoint's form)
        float gshift = a.opd;
        if (MODE != OPD_PLAIN) {
            const float gtk = a.opd + a.opdc;
            gshift = gtk - a.opdc;
            a.opd = gshift;
            a.opdc = -gshift;
        }
        // shift = -phase / k0
        const float gphase = -gshift / d.k0;
        float gk0 = gshift * d.phase / (d.k0 * d.k0);
        // o = kp + alpha n; alpha = +-sqrt(R^2), 0 on an evanescent order
        float gkpx = gox, gkpy = goy, gkpz = goz;
        const float galpha = gox * d.nx + goy * d.ny + goz * d.nz;
        gnx += gox * d.alpha;
        gny += goy * d.alpha;
        gnz += goz * d.alpha;
        const float alpha0 = refl ? -d.alpha : d.alpha;
        const float grsq = d.evan ? 0.0f
                                  : (refl ? -galpha : galpha) / (2.0f * alpha0);
        // R^2 = nk^2 - kp.kp, nk = n2 k0
        const float gnk = 2.0f * d.nk * grsq;
        gkpx -= 2.0f * d.kpx * grsq;
        gkpy -= 2.0f * d.kpy * grsq;
        gkpz -= 2.0f * d.kpz * grsq;
        dn2 += gnk * d.k0;
        gk0 += gnk * n2;
        // kp = ki - pdn n + G; pdn = ki . n; ki = nk1 (L, M, N), nk1 = n1 k0
        const float gpdn = -(gkpx * d.nx + gkpy * d.ny + gkpz * d.nz);
        gnx += gpdn * d.kix - gkpx * d.pdn;
        gny += gpdn * d.kiy - gkpy * d.pdn;
        gnz += gpdn * d.kiz - gkpz * d.pdn;
        const float gkix = gkpx + gpdn * d.nx, gkiy = gkpy + gpdn * d.ny,
                    gkiz = gkpz + gpdn * d.nz;
        aL += gkix * d.nk1;
        aM += gkiy * d.nk1;
        aN += gkiz * d.nk1;
        const float gnk1 = gkix * L + gkiy * M + gkiz * N;
        dn1 += gnk1 * d.k0;
        gk0 += gnk1 * n1;
        // k0 = 2 pi / c7
        d7 += -gk0 * d.k0 / c[7];
        // G = pg - gdn n (Gz = -gdn nz); gdn = pgx nx + pgy ny
        const float ggdn = -(gkpx * d.nx + gkpy * d.ny + gkpz * d.nz);
        gnx += ggdn * d.pgx - gkpx * d.gdn;
        gny += ggdn * d.pgy - gkpy * d.gdn;
        gnz -= gkpz * d.gdn;
        const float gpgx = gkpx + ggdn * d.nx, gpgy = gkpy + ggdn * d.ny;
        const int pk = phase_of(fl);
        if (pk == PH_CONSTANT) {
            d24 += gphase;
        } else if (pk == PH_LINEAR) {
            d24 += gphase * x + gpgx;
            d25 += gphase * y + gpgy;
            ax += gphase * c[24];
            ay += gphase * c[25];
        } else {
            // pg = ratio (x, y), ratio = d_dr / (rp == 0 ? 1 : rp)
            const float gratio = gpgx * x + gpgy * y;
            ax += gpgx * d.ratio;
            ay += gpgy * d.ratio;
            const float safe = d.rp == 0.0f ? 1.0f : d.rp;
            const float gd_dr = gratio / safe;
            float grp = d.rp == 0.0f ? 0.0f : -gratio * d.ratio / safe;
            // phase = sum_i a_i r2p^(i+1), d_dr = sum_i a_i 2 (i + 1) rp
            // r2p^i
            float gr2p = 0.0f, p = 1.0f, pm = 0.0f;    // r2p^i, r2p^(i-1)
            const int nu = nu_of(fl);
            for (int i = 0; i < nu; ++i) {
                const float ci = ac[i], k = 2.0f * (float)(i + 1);
                da[i] += gphase * p * d.r2p + gd_dr * k * p * d.rp;
                gr2p += ci * (gphase * (float)(i + 1) * p
                              + gd_dr * k * (float)i * d.rp * pm);
                grp += gd_dr * ci * k * p;
                pm = p;
                p *= d.r2p;
            }
            // rp = sqrt(r2p): grad / (2 rp), as autograd forms it
            gr2p += grp / (2.0f * d.rp);
            ax += 2.0f * x * gr2p;
            ay += 2.0f * y * gr2p;
        }
        if (fl & FLAG_PLANE_CLS) gnx = gny = gnz = 0.0f;
    }
    // the substrate's normal (nx, ny, nz) = (dfdx, dfdy, -1) inv_n, inv_n =
    // 1 / sqrt(dfdx^2 + dfdy^2 + 1), dfdx = (x ri) inv_root, inv_root = 1 /
    // sqrt(arg > eps ? arg : 1), arg = 1 - (((1 + conic) ri) ri) r2; a
    // plane's is constant
    if (fl & FLAG_PLANE) return;
    gdfdx += gnx * d.inv_n;
    gdfdy += gny * d.inv_n;
    const float ginv_n = gnx * d.dfdx + gny * d.dfdy - gnz;
    const float gsum = -ginv_n * d.inv_n * d.inv_n / (2.0f * d.sn);
    gdfdx += 2.0f * d.dfdx * gsum;
    gdfdy += 2.0f * d.dfdy * gsum;
    const float ri = c[0], conic = c[1];
    const float gxr = gdfdx * d.inv_root, gyr = gdfdy * d.inv_root;
    const float ginv_root = gdfdx * x * ri + gdfdy * y * ri;
    ax += gxr * ri;
    ay += gyr * ri;
    dri += gxr * x + gyr * y;
    const float gsr = -ginv_root * d.inv_root * d.inv_root;
    const float garg = d.arg > EPS_GUARD ? gsr / (2.0f * d.sr) : 0.0f;
    const float B = (1.0f + conic) * ri;
    const float A = B * ri;
    const float gA = -garg * d.r2;
    const float gr2 = -garg * A;
    const float gB = gA * ri;
    dri += gA * B + gB * (1.0f + conic);
    dconic += gB * ri;
    ax += 2.0f * x * gr2;
    ay += 2.0f * y * gr2;
}

// Adjoint of surface_step. ``in`` is the surface's input state, ``tp`` its
// recomputed intermediates. ``a`` holds the cotangent of the output state on
// entry and of the input state on return; dc receives the cotangents of
// consts columns 0-6, 8-19 (dc[7 + j - 8] for column j in 8-19), 24-25
// (dc[19], dc[20]) and 7 (dc[21], a phase surface's), da those of the
// surface's sag coefficients (or a radial phase profile's), dgap that of
// column 27 (the split mode). POL: pin holds the surface's input E-vectors,
// gE their updated ones' cotangents on entry and their own on return.
template <int VAR, int MODE, bool POL>
__device__ __forceinline__ void surface_adjoint(const float* c, const float* ac,
                                                const float* ztab, int fl,
                                                float sigma,
                                                const RayState& in,
                                                const SurfTape& tp, Adj& a,
                                                float dc[NDC], float* da,
                                                float& dgap,
                                                const PolState* pin,
                                                float (*gE)[3]) {
    constexpr bool WIDE = VAR != VAR_NARROW;
    constexpr bool FF = VAR >= VAR_FREEFORM;
    const float ri = c[0], conic = c[1];
    const float n1 = c[3], n2 = c[4], alpha = c[5];
    const bool cs = WIDE && (fl & FLAG_CS);
    const int gk = WIDE ? gkind_of(fl) : GK_CONIC;
    const bool fresnel = FF && (gk == GK_FZONE || gk == GK_FDESIGNED);
    const bool newton = gk != GK_CONIC && !fresnel;
    const bool conic_like = gk == GK_CONIC || (FF && gk == GK_FZONE);
#if WITH_DOE
    const bool doe = WIDE && inter_of(fl) != INTER_NONE;
#endif
    // the incoming direction and the landing point, in the surface's frame
    const float L = tp.Ll, M = tp.Ml, N = tp.Nl;
    const float x2 = tp.x2, y2 = tp.y2;
    const float t = tp.t;
    float dri = 0.0f, dconic = 0.0f, dpz = 0.0f, dn1 = 0.0f, dn2 = 0.0f,
          dalpha = 0.0f;
    dgap = 0.0f;
#pragma unroll
    for (int j = 0; j < NDC; ++j) dc[j] = 0.0f;

    // ---- globalize: (x, L)_out = R (x2, Lo)_local + t; else z_out = z2 +
    // pos_z ---------------------------------------------------------------------
    float ax2, ay2, az2, aLo, aMo, aNo;
    if (cs) {
        const float axg = a.x, ayg = a.y, azg = a.z;
        const float aLg = a.L, aMg = a.M, aNg = a.N;
        ax2 = c[8] * axg + c[11] * ayg + c[14] * azg;
        ay2 = c[9] * axg + c[12] * ayg + c[15] * azg;
        az2 = c[10] * axg + c[13] * ayg + c[16] * azg;
        aLo = c[8] * aLg + c[11] * aMg + c[14] * aNg;
        aMo = c[9] * aLg + c[12] * aMg + c[15] * aNg;
        aNo = c[10] * aLg + c[13] * aMg + c[16] * aNg;
        // rotation entry (i, j), column 8 + 3 i + j, in dc[7 + 3 i + j]
        dc[7] = axg * x2 + aLg * tp.Lo;
        dc[8] = axg * y2 + aLg * tp.Mo;
        dc[9] = axg * tp.z2 + aLg * tp.No;
        dc[10] = ayg * x2 + aMg * tp.Lo;
        dc[11] = ayg * y2 + aMg * tp.Mo;
        dc[12] = ayg * tp.z2 + aMg * tp.No;
        dc[13] = azg * x2 + aNg * tp.Lo;
        dc[14] = azg * y2 + aNg * tp.Mo;
        dc[15] = azg * tp.z2 + aNg * tp.No;
        dc[16] = axg;
        dc[17] = ayg;
        dc[18] = azg;
    } else {
        // the split mode's z_out is the refreshed z (no position added)
        if (MODE != OPD_SPLIT) dpz += a.z;
        ax2 = a.x;
        ay2 = a.y;
        az2 = a.z;
        aLo = a.L;
        aMo = a.M;
        aNo = a.N;
    }

    // ---- coating: inten_out = inten * coat ---------------------------------
    if (WIDE && (fl & FLAG_COAT)) {
        dc[6] = a.inten * tp.inten_pc;
        a.inten = a.inten * c[6];
    }

    // ---- the polarization chain: E' from (L, M, N), (Lo, Mo, No), the
    // normal and cos_i (|N| on a plane, |dot| else) ----------------------------
    float gk0[3] = {0.0f, 0.0f, 0.0f}, gnrm[3] = {0.0f, 0.0f, 0.0f},
          gcos = 0.0f;
    // (a grating or phase step leaves the E-vectors as they are)
#if WITH_DOE
    if constexpr (POL) if (!doe) {
#else
    if constexpr (POL) {
#endif
        const bool plane = conic_like && (fl & FLAG_PLANE);
        const float cos_i = plane ? fabsf(N) : fabsf(tp.dot);
        PolSurf b;
        polar_surface(b, fl, n1, n2, plane, cos_i, L, M, N, tp.Lo, tp.Mo,
                      tp.No, tp.nx, tp.ny, tp.nz);
        float gk1[3] = {0.0f, 0.0f, 0.0f};
        polar_adjoint(b, plane, (fl & FLAG_REFL) != 0, n1, cos_i, L, M, N,
                      tp.Lo, tp.Mo, tp.No, tp.nx, tp.ny, tp.nz, pin->e, gE,
                      pin->nev, gk0, gk1, gnrm, gcos, dn1, dn2);
        aLo += gk1[0];
        aMo += gk1[1];
        aNo += gk1[2];
    }

    // ---- refract or reflect, or the grating or phase step ------------------
    float aL = 0.0f, aM = 0.0f, aN = 0.0f;     // cotangents of L, M, N in
#if WITH_DOE
    if (doe) {
        doe_adjoint<MODE>(c, ac, fl, x2, y2, L, M, N, aLo, aMo, aNo, a, ax2,
                          ay2, aL, aM, aN, dri, dconic, dn1, dn2, dc[19],
                          dc[20], dc[21], da);
    } else
#endif
    if (conic_like && (fl & FLAG_PLANE)) {
        if (fl & FLAG_REFL) {                  // N_out = -N
            aL = aLo;
            aM = aMo;
            aN = -aNo;
        } else {                               // plane Snell
            const float u = tp.u;
            float du = aLo * L + aMo * M;
            aL = aLo * u;
            aM = aMo * u;
            const float droot = aNo * sgn(N);  // N_out = sign(N) * root_r
            const float ddisc = tp.ok_r ? droot / (2.0f * tp.root_r) : 0.0f;
            // disc_r = 1 - (u*u) * (1 - N*N)
            const float duu = -ddisc * (1.0f - N * N);
            const float d1m = -ddisc * (u * u);
            du += 2.0f * u * duu;
            aN = -2.0f * N * d1m;
            dn1 += du / n2;                    // u = n1 / n2
            dn2 -= du * u / n2;
        }
        if constexpr (POL) aN += gcos * sgn(N);     // cos_i = |N|
    } else {
        float dnx, dny, dnz, ddot;
        if (fl & FLAG_REFL) {                  // d - 2 (d.n) n
            const float two_dot = 2.0f * tp.dot;
            aL = aLo;
            aM = aMo;
            aN = aNo;
            const float dtwo = -(aLo * tp.nx + aMo * tp.ny + aNo * tp.nz);
            dnx = -aLo * two_dot;
            dny = -aMo * two_dot;
            dnz = -aNo * two_dot;
            ddot = 2.0f * dtwo;
        } else {                               // u d + w n
            const float u = tp.u, w = tp.w, dot = tp.dot;
            aL = aLo * u;
            aM = aMo * u;
            aN = aNo * u;
            float du = aLo * L + aMo * M + aNo * N;
            dnx = aLo * w;
            dny = aMo * w;
            dnz = aNo * w;
            const float dw = aLo * tp.nx + aMo * tp.ny + aNo * tp.nz;
            // w = sign(dot) * root_r - u * dot
            const float droot = dw * sgn(dot);
            du -= dw * dot;
            ddot = -dw * u;
            const float ddisc = tp.ok_r ? droot / (2.0f * tp.root_r) : 0.0f;
            // disc_r = 1 - (u*u) * (1 - dot*dot)
            const float duu = -ddisc * (1.0f - dot * dot);
            const float d1m = -ddisc * (u * u);
            du += 2.0f * u * duu;
            ddot -= 2.0f * dot * d1m;
            dn1 += du / n2;
            dn2 -= du * u / n2;
        }
        if constexpr (POL) {
            dnx += gnrm[0];
            dny += gnrm[1];
            dnz += gnrm[2];
            ddot += gcos * sgn(tp.dot);
        }
        // dot = L nx + M ny + N nz
        aL += ddot * tp.nx;
        aM += ddot * tp.ny;
        aN += ddot * tp.nz;
        dnx += ddot * L;
        dny += ddot * M;
        dnz += ddot * N;
        // (nx, ny, nz) = (dfdx, dfdy, -1) * inv_n
        float ddfdx = dnx * tp.inv_n;
        float ddfdy = dny * tp.inv_n;
        const float dinv_n = dnx * tp.dfdx + dny * tp.dfdy - dnz;
        // inv_n = 1 / sqrt(dfdx^2 + dfdy^2 + 1)
        const float dsn = -dinv_n * (tp.inv_n * tp.inv_n);
        const float dsum = dsn / (2.0f * tp.sn);
        ddfdx += 2.0f * tp.dfdx * dsum;
        ddfdy += 2.0f * tp.dfdy * dsum;
        if (FF && gk == GK_FDESIGNED) {
            // (dfdx, dfdy) = the designed facet's slope at (x2, y2)
            designed_slope_adjoint(c, x2, y2, ddfdx, ddfdy, ax2, ay2, dc[19],
                                   dc[20]);
        } else if (!conic_like) {
            // (dfdx, dfdy) = the Newton sag's slope at (x2, y2)
            sag_adjoint<VAR>(gk, fl, c, ac, ztab, x2, y2, 0.0f, ddfdx, ddfdy,
                             ax2, ay2, dri, dconic, dc[19], dc[20], da);
        } else {
            // dfdx = (x2 * ri) * inv_root
            const float xr = x2 * ri, yr = y2 * ri;
            const float dxr = ddfdx * tp.inv_root, dyr = ddfdy * tp.inv_root;
            const float dinv_root = ddfdx * xr + ddfdy * yr;
            ax2 += dxr * ri;
            ay2 += dyr * ri;
            dri += dxr * x2 + dyr * y2;
            // inv_root = 1 / sqrt(arg > eps ? arg : 1)
            const float dsr = -dinv_root * (tp.inv_root * tp.inv_root);
            const float darg = tp.arg > EPS_GUARD ? dsr / (2.0f * tp.sr) : 0.0f;
            // arg = 1 - (((1 + conic) * ri) * ri) * r2
            const float B = (1.0f + conic) * ri;
            const float A = B * ri;
            const float dA = -darg * tp.r2;
            const float dr2 = -darg * A;
            const float dB = dA * ri;
            dri += dA * B + dB * (1.0f + conic);
            dconic += dB * ri;
            ax2 += 2.0f * x2 * dr2;
            ay2 += 2.0f * y2 * dr2;
        }
    }
    if constexpr (POL) {
        aL += gk0[0];
        aM += gk0[1];
        aN += gk0[2];
    }

    // ---- aperture: inten *= mask (no cotangent to the extents) -------------
    if (WIDE && (fl & FLAG_AP)) a.inten = a.inten * tp.mask;

    // ---- absorption: inten_out = inten * exp(((-alpha) * t) * 1000) ------
    float dt = 0.0f;
    if (fl & FLAG_ABSORB) {
        const float de = a.inten * in.inten;
        a.inten = a.inten * tp.e;
        const float dat = de * tp.e * 1000.0f;
        dalpha -= dat * t;
        dt -= dat * alpha;
    }
    // ---- split: z_out = sag(x2, y2) = (r2 ri) / (1 + sq), sq = sqrt(arg >
    // eps ? arg : eps), arg = 1 - (((1 + conic) ri) ri) r2; 0 on a plane.
    // The propagated z it replaces gets no cotangent -------------------------
    if (MODE == OPD_SPLIT) {
        const float azs = az2;
        az2 = 0.0f;
        if (!(fl & FLAG_PLANE)) {
            const float r2 = x2 * x2 + y2 * y2;
            const float den = 1.0f + tp.sq_z;
            const float zs = r2 * ri / den;
            const float dnum = azs / den;
            const float dsq = -azs * zs / den;
            float dr2 = dnum * ri;
            dri += dnum * r2;
            const float darg = tp.arg_z > EPS_GUARD ? dsq / (2.0f * tp.sq_z)
                                                    : 0.0f;
            const float B = (1.0f + conic) * ri;
            const float A = B * ri;
            const float dA = -darg * r2;
            dr2 -= darg * A;
            const float dB = dA * ri;
            dri += dA * B + dB * (1.0f + conic);
            dconic += dB * ri;
            ax2 += 2.0f * x2 * dr2;
            ay2 += 2.0f * y2 * dr2;
        }
    }
    // ---- the OPD sum: opd_out = opd + v, plain or compensated ---------------
    float gv = a.opd;                          // the cotangent of v
    if (MODE != OPD_PLAIN) {
        const float gtk = a.opd + a.opdc;
        gv = gtk - a.opdc;
        a.opd = gv;
        a.opdc = -gv;
    }
    float gtq = 0.0f, gzp = 0.0f;
    if (MODE == OPD_SPLIT) {
        // v = dev = ((n1 sigma) gap) ratio - ((sigma n1) zp) / nabs [+ n1 tq],
        // ratio = onem / nabs, onem = (L^2 + M^2) / den, den = 1 + nabs,
        // nabs = sigma N
        const float gap = c[27];
        const float A = n1 * sigma * gap;
        const float Bv = sigma * n1 * tp.zp;
        const float gratio = gv * A;
        const float gB = -gv / tp.nabs;
        float gnabs = gv * Bv / (tp.nabs * tp.nabs);
        const float gonem = gratio / tp.nabs;
        gnabs -= gratio * tp.ratio / tp.nabs;
        const float gnum = gonem / tp.den;
        gnabs -= gonem * tp.onem / tp.den;
        aL += 2.0f * L * gnum;
        aM += 2.0f * M * gnum;
        aN += sigma * gnabs;
        const float gA = gv * tp.ratio;
        dn1 += gA * sigma * gap + gB * sigma * tp.zp;
        dgap += gA * n1 * sigma;
        gzp = gB * sigma * n1;
        if (!(fl & FLAG_PLANE)) {
            dn1 += gv * tp.tq;
            gtq = gv * n1;
        }
    } else {
        // v = |t * n1|
        const float dtn1 = gv * sgn(t * n1);
        dt += dtn1 * n1;
        dn1 += dtn1 * t;
    }
    // ---- propagation: (x2, y2, z2) = (x, y, z1) + t (L, M, N) --------------
    dt += ax2 * L + ay2 * M + az2 * N;
    aL += ax2 * t;
    aM += ay2 * t;
    aN += az2 * t;
    float ax = ax2, ay = ay2, az1 = az2;

    // ---- intersection ----------------------------------------------------------
    if (newton) {
        // the live Newton step t = t_it - f / eps_guard(dd), with f = s(xx,
        // yy) - zz, dd = (gx L + gy M) - N at (xx, yy, zz) = (x, y, z1) +
        // t_it (L, M, N); t_it and the warm start get no cotangent
        const float dq = -dt;                  // of f / dg
        const float df = dq / tp.dg;
        const float ddg = -dq * tp.f / (tp.dg * tp.dg);
        const float ddd = fabsf(tp.dd) > EPS_GUARD ? ddg : 0.0f;
        aL += ddd * tp.ngx;
        aM += ddd * tp.ngy;
        aN -= ddd;
        float dxx = 0.0f, dyy = 0.0f;
        sag_adjoint<VAR>(gk, fl, c, ac, ztab, tp.xx, tp.yy, df, ddd * L,
                         ddd * M, dxx, dyy, dri, dconic, dc[19], dc[20], da);
        const float dzz = -df;
        ax += dxx;
        ay += dyy;
        az1 += dzz;
        aL += dxx * tp.t_it;
        aM += dyy * tp.t_it;
        aN += dzz * tp.t_it;
    } else if ((fl & FLAG_PLANE) || fresnel) { // t = (-z1) / N
        az1 -= dt / N;
        aN -= dt * t / N;
    } else {
        float dt0 = dt;
        // t = t0 + tq; the split deviation reads tq too
        const float dtq = tp.ok ? dt + gtq : 0.0f;
        const float dtn = tp.near ? dtq : 0.0f;
        const float dtf = tp.near ? 0.0f : dtq;
        // t_near = cc / eps_guard(q), t_far = q / eps_guard(a)
        float dcc = dtn / tp.qg;
        const float dqg = -dtn * tp.t_near / tp.qg;
        float dq = fabsf(tp.q) > EPS_GUARD ? dqg : 0.0f;
        dq += dtf / tp.ag;
        const float dag = -dtf * tp.t_far / tp.ag;
        float da_ = fabsf(tp.a) > EPS_GUARD ? dag : 0.0f;
        // q = -(bh + (bh >= 0 ? sq : -sq))
        float dbh = -dq;
        const float dsq = tp.bh >= 0.0f ? -dq : dq;
        // sq = sqrt(ok ? disc : 1), disc = bh^2 - a cc
        const float ddisc = tp.ok ? dsq / (2.0f * tp.sq) : 0.0f;
        dbh += 2.0f * tp.bh * ddisc;
        da_ -= ddisc * tp.cc;
        dcc -= ddisc * tp.a;
        // cc = (x0^2 + y0^2) ri
        const float x0 = tp.x0, y0 = tp.y0;
        const float dss = dcc * ri;
        dri += dcc * (x0 * x0 + y0 * y0);
        float dx0 = 2.0f * x0 * dss;
        float dy0 = 2.0f * y0 * dss;
        // bh = (L x0 + M y0) ri - N
        aN -= dbh;
        const float dlin = dbh * ri;
        dri += dbh * (L * x0 + M * y0);
        aL += dlin * x0;
        aM += dlin * y0;
        dx0 += dlin * L;
        dy0 += dlin * M;
        // a = ((conic N) N + 1) ri
        const float dinn = da_ * ri;
        dri += da_ * (conic * N * N + 1.0f);
        dconic += dinn * N * N;
        aN += 2.0f * dinn * conic * N;
        // (x0, y0) = (x, y) + t0 (L, M)
        ax += dx0;
        ay += dy0;
        dt0 += dx0 * L + dy0 * M;
        aL += dx0 * tp.t0;
        aM += dy0 * tp.t0;
        // t0 = (-z1) / N
        az1 -= dt0 / N;
        aN -= dt0 * tp.t0 / N;
    }

    // ---- localize: (x, L)_local = R^T ((x, L) - t); else z1 = z - pos_z -----
    if (cs) {
        const float dx0 = sub(in.x, c[17]), dy0 = sub(in.y, c[18]);
        const float dz0 = sub(in.z, c[19]);
        a.x = c[8] * ax + c[9] * ay + c[10] * az1;
        a.y = c[11] * ax + c[12] * ay + c[13] * az1;
        a.z = c[14] * ax + c[15] * ay + c[16] * az1;
        a.L = c[8] * aL + c[9] * aM + c[10] * aN;
        a.M = c[11] * aL + c[12] * aM + c[13] * aN;
        a.N = c[14] * aL + c[15] * aM + c[16] * aN;
        dc[7] += ax * dx0 + aL * in.L;
        dc[8] += ay * dx0 + aM * in.L;
        dc[9] += az1 * dx0 + aN * in.L;
        dc[10] += ax * dy0 + aL * in.M;
        dc[11] += ay * dy0 + aM * in.M;
        dc[12] += az1 * dy0 + aN * in.M;
        dc[13] += ax * dz0 + aL * in.N;
        dc[14] += ay * dz0 + aM * in.N;
        dc[15] += az1 * dz0 + aN * in.N;
        dc[16] -= a.x;
        dc[17] -= a.y;
        dc[18] -= a.z;
    } else {
        // z1 = z - pos_z; in the split mode z1 = zp - gap, and zp also
        // enters the deviation
        if (MODE == OPD_SPLIT) {
            dgap -= az1;
            a.z = az1 + gzp;
        } else {
            dpz -= az1;
            a.z = az1;
        }
        a.x = ax;
        a.y = ay;
        a.L = aL;
        a.M = aM;
        a.N = aN;
    }
    dc[0] = dri;
    dc[1] = dconic;
    dc[2] = dpz;
    dc[3] = dn1;
    dc[4] = dn2;
    dc[5] = dalpha;
}

template <int MAXS, int VAR, int MODE, bool POL>
__global__ void __launch_bounds__(GBLOCK)
gen_grad_kernel(const float* __restrict__ gen, const float* __restrict__ consts,
                const float* __restrict__ acoef, const float* __restrict__ ztab,
                const float* __restrict__ px,
                const float* __restrict__ py, const float* __restrict__ cot,
                float* __restrict__ part, float* __restrict__ dpx_wf,
                float* __restrict__ dpy_wf, const GradLayout layout, int S,
                int F, int W, int C, long long n, int nblk, int final_prop,
                const PolLaunch pl) {
    __shared__ float sc[MAXS * CONST_W];
    __shared__ float sg[GEN_W];
    // the per-warp sums, [NWARP][nq]
    extern __shared__ float sw[];
    const int nq = layout.qoff[S] + NGEN;
    const int f = blockIdx.y;
    const int w = blockIdx.z;
    const float* cw = consts + (size_t)w * S * CONST_W;
    for (int j = threadIdx.x; j < S * CONST_W; j += blockDim.x) sc[j] = cw[j];
    if (threadIdx.x < GEN_W) sg[threadIdx.x] = gen[(size_t)f * GEN_W + threadIdx.x];
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long i = (long long)blockIdx.x * GBLOCK + threadIdx.x;
    // threads past the tail run a dummy ray and add 0, so that every lane
    // takes part in the warp sums
    const bool active = i < n;
    const float Px = active ? px[i] : 0.0f;
    const float Py = active ? py[i] : 0.0f;

    // ---- forward, keeping each surface's input state (a polarized launch's
    // E-vectors too: 3 n_ev more floats) -------------------------------------
    float st[MAXS][POL ? 13 : 7];
    RayState s;
    PolState ps;
    gen_prologue<MODE>(sg, Px, Py, s);
    if constexpr (POL) polar_init(sg, s.L, s.M, s.N, s.inten, pl, ps);
    float sigma = 1.0f;
    for (int k = 0; k < S; ++k) {
        st[k][0] = s.x;
        st[k][1] = s.y;
        st[k][2] = s.z;
        st[k][3] = s.L;
        st[k][4] = s.M;
        st[k][5] = s.N;
        st[k][6] = s.inten;
        if constexpr (POL) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                if (v >= pl.nev) break;
                st[k][7 + 3 * v] = ps.e[v][0];
                st[k][8 + 3 * v] = ps.e[v][1];
                st[k][9 + 3 * v] = ps.e[v][2];
            }
        }
        SurfTape tp;
        surface_step<VAR, MODE, POL>(sc + k * CONST_W, acoef + (size_t)k * C,
                                     ztab, layout.f[k], sigma, s, tp, &ps);
        if (layout.f[k] & FLAG_REFL) sigma = -sigma;
    }

    // ---- cotangents; the NaN step's transpose zeroes lost rays' ------------
    const size_t plane = (size_t)W * F * n;
    const size_t o = ((size_t)w * F + f) * n + (active ? i : 0);
    Adj a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (active) {
        a.inten = cot[6 * plane + o];
        if (s.valid) {
            a.x = cot[o];
            a.y = cot[plane + o];
            a.z = cot[2 * plane + o];
            a.L = cot[3 * plane + o];
            a.M = cot[4 * plane + o];
            a.N = cot[5 * plane + o];
            a.opd = cot[7 * plane + o];
        }
    }
    // a polarized launch's intensity is scale sum |E|^2, and the traced
    // intensity gets no cotangent
    float gE[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
    if constexpr (POL) {
        const float gi = 2.0f * pl.scale * a.inten;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
            if (v >= pl.nev) break;
            gE[v][0] = gi * ps.e[v][0];
            gE[v][1] = gi * ps.e[v][1];
            gE[v][2] = gi * ps.e[v][2];
        }
        a.inten = 0.0f;
    }

    // ---- epilogue: (x, y, z) += t_img (L, M, N) ----------------------------
    float dg6 = 0.0f;
    if (final_prop) {
        const float t_img = sg[6];
        dg6 = a.x * s.L + a.y * s.M + a.z * s.N;
        a.L += a.x * t_img;
        a.M += a.y * t_img;
        a.N += a.z * t_img;
    }

    // ---- surfaces in reverse -----------------------------------------------
    constexpr bool WIDE = VAR != VAR_NARROW;
    for (int k = S - 1; k >= 0; --k) {
        const float* c = sc + k * CONST_W;
        const float* ac = acoef + (size_t)k * C;
        const int fl = layout.f[k];
        if (fl & FLAG_REFL) sigma = -sigma;    // the sign before surface k
        RayState in;
        in.x = st[k][0];
        in.y = st[k][1];
        in.z = st[k][2];
        in.L = st[k][3];
        in.M = st[k][4];
        in.N = st[k][5];
        in.inten = st[k][6];
        in.opd = 0.0f;
        in.opd_c = 0.0f;
        in.valid = true;
        PolState pin;
        if constexpr (POL) {
            pin.nev = pl.nev;
#pragma unroll
            for (int v = 0; v < 2; ++v) {
                if (v >= pl.nev) break;
                pin.e[v][0] = st[k][7 + 3 * v];
                pin.e[v][1] = st[k][8 + 3 * v];
                pin.e[v][2] = st[k][9 + 3 * v];
            }
        }
        RayState out = in;
        SurfTape tp;
        // the tape does not depend on the E-vectors: recompute without them
        surface_step<VAR, MODE>(c, ac, ztab, fl, sigma, out, tp);
        float dc[NDC];
        float da[WIDE ? MAX_TERMS : 1];
        const int nu = WIDE ? ncoef_of(fl) : 0;
        for (int j = 0; j < nu; ++j) da[j] = 0.0f;
        float dgap;
        surface_adjoint<VAR, MODE, POL>(c, ac, ztab, fl, sigma, in, tp, a, dc,
                                        da, dgap, &pin, gE);
        if (MODE == OPD_SPLIT) {
            const float v = warp_sum(active ? dgap : 0.0f);
            if (lane == 0) sw[warp * nq + layout.qoff[k] + n_slots(fl)] = v;
        }
        int q = layout.qoff[k];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
            const float v = warp_sum(active ? dc[j] : 0.0f);
            if (lane == 0) sw[warp * nq + q + j] = v;
        }
        if (WIDE) {
            q += 6;
            if (fl & FLAG_COAT) {
                const float v = warp_sum(active ? dc[6] : 0.0f);
                if (lane == 0) sw[warp * nq + q] = v;
                ++q;
            }
            if (fl & FLAG_CS) {
#pragma unroll
                for (int j = 7; j < 19; ++j) {        // columns 8-19
                    const float v = warp_sum(active ? dc[j] : 0.0f);
                    if (lane == 0) sw[warp * nq + q + j - 7] = v;
                }
                q += 12;
            }
            for (int j = 0; j < nu; ++j) {
                const float v = warp_sum(active ? da[j] : 0.0f);
                if (lane == 0) sw[warp * nq + q + j] = v;
            }
            if (VAR >= VAR_FREEFORM && n_extra(fl)) {
                q += nu;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const float v = warp_sum(active ? dc[19 + j] : 0.0f);
                    if (lane == 0) sw[warp * nq + q + j] = v;
                }
            }
#if WITH_DOE
            // a grating's columns 24-25, a phase surface's and its 7
            const int nd = n_doe(fl);
            for (int j = 0; j < nd; ++j) {
                const float v = warp_sum(active ? dc[19 + j] : 0.0f);
                if (lane == 0)
                    sw[warp * nq + layout.qoff[k] + n_slots(fl) + j] = v;
            }
#endif
        }
    }

    // ---- prologue ------------------------------------------------------------
    const float* g = sg;
    const float x = add(mul(Px, g[0]), g[2]);
    const float y = add(mul(Py, g[1]), g[3]);
    const float z = g[4];
    const bool tele = g[10] != 0.0f;           // dxr = Px g8, dzr = g5
    const float dxr = tele ? mul(Px, g[8]) : sub(mul(Px, g[8]), x);
    const float dyr = tele ? mul(Py, g[9]) : sub(mul(Py, g[9]), y);
    const float dzr = tele ? g[5] : sub(g[5], z);
    const float smag = sqt(add(add(mul(dxr, dxr), mul(dyr, dyr)), mul(dzr, dzr)));
    const float inv_mag = dvd(1.0f, smag);
    // the launch vectors of a polarized launch, from (L, M, N) and the
    // weight
    float dw_pol = 0.0f;
    if constexpr (POL)
        polar_init_adjoint(g, mul(dxr, inv_mag), mul(dyr, inv_mag),
                           mul(dzr, inv_mag), apod_weight(g, Px, Py), pl, gE,
                           a.L, a.M, a.N, dw_pol);
    // (L, M, N) = (dxr, dyr, dzr) * inv_mag
    const float dinv = a.L * dxr + a.M * dyr + a.N * dzr;
    float ddxr = a.L * inv_mag, ddyr = a.M * inv_mag, ddzr = a.N * inv_mag;
    const float dsm = -dinv * (inv_mag * inv_mag) / (2.0f * smag);
    ddxr += 2.0f * dxr * dsm;
    ddyr += 2.0f * dyr * dsm;
    ddzr += 2.0f * dzr * dsm;
    float ax = tele ? a.x : a.x - ddxr, ay = tele ? a.y : a.y - ddyr;
    // the split frame's launch z is 0, not g4
    const float az = (MODE == OPD_SPLIT ? 0.0f : a.z) - (tele ? 0.0f : ddzr);
    float dgv[NGEN];
    dgv[0] = ax * Px;            // x = Px g0 + g2
    dgv[1] = ay * Py;            // y = Py g1 + g3
    dgv[2] = ax;
    dgv[3] = ay;
    dgv[4] = az;                 // z = g4
    dgv[5] = ddzr;               // dzr = g5 - z
    dgv[6] = dg6;
    dgv[7] = ddxr * Px;          // dxr = Px g8 - x
    dgv[8] = ddyr * Py;
    if (active && dpx_wf != nullptr) {
        float dpx = ddxr * g[8] + ax * g[0], dpy = ddyr * g[9] + ay * g[1];
        apod_adjoint(g, Px, Py, POL ? a.inten + dw_pol : a.inten, dpx, dpy);
        dpx_wf[o] = dpx;
        dpy_wf[o] = dpy;
    }
    const int qg = layout.qoff[S];
#pragma unroll
    for (int j = 0; j < NGEN; ++j) {
        const float v = warp_sum(active ? dgv[j] : 0.0f);
        if (lane == 0) sw[warp * nq + qg + j] = v;
    }
    __syncthreads();

    // ---- one partial per block and slot, warps summed in order --------------
    const size_t nb = (size_t)W * F * nblk;
    const size_t b = ((size_t)w * F + f) * nblk + blockIdx.x;
    for (int qq = threadIdx.x; qq < nq; qq += GBLOCK) {
        float v = 0.0f;
        for (int j = 0; j < NWARP; ++j) v += sw[j * nq + qq];
        part[(size_t)qq * nb + b] = v;
    }
}

// The narrow, plain-OPD, unpolarized instances (the Cooke triplet's, the
// double Gauss's, the UV lens's): the fused design of gen_grad_narrow.cuh,
// whose forward is K1 narrow's (gen_trace_narrow.cuh). A library with the
// diffractive surfaces, a polarized one or another OPD mode's keeps the
// template above for every instance.
#if NARROW_FUSED
#include "gen_grad_narrow.cuh"
#endif
// The WIDE, plain-OPD, polarized instances (the polarized double Gauss's,
// the tilted coated singlet's) in the plain polarized library: the design
// of gen_grad_pol_wide.cuh, whose forward is K1 (e)'s.
#if POL_WIDE_FUSED
#include "gen_grad_pol_wide.cuh"
#endif

// gen columns 0-15 -> slot after the surfaces' (-1: no cotangent)
__device__ __forceinline__ int gen_slot(int col) {
    return col <= 6 ? col : (col == 8 ? 7 : (col == 9 ? 8 : -1));
}

// One block per element of dconsts [W, S, 32], dgen [F, 16], dacoef [S, C],
// in that order. The element's partials are nseg segments of seglen
// contiguous floats, seg_stride apart.
__global__ void __launch_bounds__(RBLOCK)
gen_grad_reduce(const float* __restrict__ part, float* __restrict__ dgen,
                float* __restrict__ dconsts, float* __restrict__ dacoef,
                const GradLayout layout, int S, int F, int W, int nblk, int C) {
    __shared__ double red[RBLOCK];
    const long long e = blockIdx.x;
    const long long n_dc = (long long)W * S * CONST_W;
    const long long n_dg = (long long)F * GEN_W;
    const size_t nb = (size_t)W * F * nblk;
    float* dst;
    size_t base = 0, seg_stride = 0;
    long long nseg = 0, seglen = 0;
    if (e < n_dc) {
        dst = dconsts + e;
        const int w = (int)(e / ((long long)S * CONST_W));
        const int k = (int)((e / CONST_W) % S);
        const int q = const_slot(layout, k, (int)(e % CONST_W));
        if (q >= 0) {                          // sum over f and blocks
            base = (size_t)q * nb + (size_t)w * F * nblk;
            nseg = 1;
            seglen = (long long)F * nblk;
        }
    } else if (e < n_dc + n_dg) {
        dst = dgen + (e - n_dc);
        const int f = (int)((e - n_dc) / GEN_W);
        const int slot = gen_slot((int)((e - n_dc) % GEN_W));
        if (slot >= 0) {                       // sum over w and blocks
            base = (size_t)(layout.qoff[S] + slot) * nb + (size_t)f * nblk;
            seg_stride = (size_t)F * nblk;
            nseg = W;
            seglen = nblk;
        }
    } else {
        const long long ea = e - n_dc - n_dg;
        dst = dacoef + ea;
        const int q = acoef_slot(layout, (int)(ea / C), (int)(ea % C));
        if (q >= 0) {                          // sum over w, f and blocks
            base = (size_t)q * nb;
            nseg = 1;
            seglen = (long long)nb;
        }
    }
    double acc = 0.0;
    for (long long sgi = 0; sgi < nseg; ++sgi) {
        const float* p = part + base + (size_t)sgi * seg_stride;
        for (long long t = threadIdx.x; t < seglen; t += RBLOCK) acc += (double)p[t];
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int h = RBLOCK / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) *dst = (float)red[0];
}

// dst[i] = sum over the WF planes of src[plane][i], in order, in float64
__global__ void __launch_bounds__(RBLOCK)
sum_wf(const float* __restrict__ src, float* __restrict__ dst, int WF,
       long long n) {
    const long long i = (long long)blockIdx.x * RBLOCK + threadIdx.x;
    if (i >= n) return;
    double acc = 0.0;
    for (int j = 0; j < WF; ++j) acc += (double)src[(size_t)j * n + i];
    dst[i] = (float)acc;
}

static int n_blocks(long long n) { return (int)((n + GBLOCK - 1) / GBLOCK); }

// The flag words and slot offsets of S surfaces in this library's OPD
// mode; false if a word is invalid or the mode cannot take it.
static bool make_layout(const int32_t* flags, int S, int C, GradLayout& g) {
    int q = 0;
    g.split = GRAD_MODE == OPD_SPLIT;
    for (int k = 0; k < MAX_SURF; ++k) {
        g.f[k] = k < S ? flags[k] : 0;
        if (ncoef_of(g.f[k]) > (C < MAX_TERMS ? C : MAX_TERMS)) return false;
        g.qoff[k] = q;
        if (k < S) q += n_slots(g.f[k]) + n_doe(g.f[k]) + g.split;
    }
    g.qoff[MAX_SURF] = q;
    return kinds_ok(g.f, S) && (!g.split || split_ok(g.f, S));
}

// Floats of the partials buffer gen_grad_launch needs (-1 for bad flags or
// another library's mode).
extern "C" long long gen_grad_partials_size(const int32_t* flags, int S, int F,
                                            int W, long long n, int opd_mode) {
    GradLayout g;
    if (S < 1 || S > MAX_SURF || opd_mode != GRAD_MODE ||
        !make_layout(flags, S, MAX_TERMS, g))
        return -1;
    return (long long)(g.qoff[S] + NGEN) * W * F * n_blocks(n);
}

template <int MAXS, int VAR>
static int launch_bucket(dim3 grid, cudaStream_t stream, const float* gen,
                         const float* consts, const float* acoef,
                         const float* ztab, const float* px, const float* py,
                         const float* cot,
                         float* part, float* dpx_wf, float* dpy_wf,
                         const GradLayout& g, int S, int F, int W, int C,
                         long long n, int nblk, int final_prop,
                         const PolLaunch& pl) {
    size_t shmem = (size_t)NWARP * (g.qoff[S] + NGEN) * sizeof(float);
#if NARROW_FUSED
    if constexpr (VAR == VAR_NARROW) shmem = narrow_shmem(S);
#endif
#if POL_WIDE_FUSED
    if constexpr (VAR == VAR_WIDE) shmem = polw_shmem(g, S);
#endif
    if (shmem > 48 * 1024) {
        const int err = (int)cudaFuncSetAttribute(
            gen_grad_kernel<MAXS, VAR, GRAD_MODE, (bool)GRAD_POL>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
        if (err) return err;
    }
    gen_grad_kernel<MAXS, VAR, GRAD_MODE, (bool)GRAD_POL>
        <<<grid, GBLOCK, shmem, stream>>>(
        gen, consts, acoef, ztab, px, py, cot, part, dpx_wf, dpy_wf, g, S, F,
        W, C, n, nblk, final_prop, pl);
    return (int)cudaGetLastError();
}

template <int VAR>
static int launch_grad(dim3 grid, cudaStream_t st, const float* gen,
                       const float* consts, const float* acoef,
                       const float* ztab, const float* px, const float* py,
                       const float* cot, float* part, float* dpx_wf,
                       float* dpy_wf, const GradLayout& g, int S, int F, int W,
                       int C, long long n, int nblk, int final_prop,
                       const PolLaunch& pl) {
    if (S <= 8)
        return launch_bucket<8, VAR>(grid, st, gen, consts, acoef, ztab, px, py,
                                     cot, part, dpx_wf, dpy_wf, g, S, F, W, C, n,
                                     nblk, final_prop, pl);
    if (S <= 16)
        return launch_bucket<16, VAR>(grid, st, gen, consts, acoef, ztab, px, py,
                                      cot, part, dpx_wf, dpy_wf, g, S, F, W, C,
                                      n, nblk, final_prop, pl);
    if (S <= 32)
        return launch_bucket<32, VAR>(grid, st, gen, consts, acoef, ztab, px, py,
                                      cot, part, dpx_wf, dpy_wf, g, S, F, W, C,
                                      n, nblk, final_prop, pl);
    return launch_bucket<64, VAR>(grid, st, gen, consts, acoef, ztab, px, py,
                                  cot, part, dpx_wf, dpy_wf, g, S, F, W, C, n,
                                  nblk, final_prop, pl);
}

// Launch the three kernels on ``stream``; returns cudaGetLastError() after
// each launch (0 on success). flags is a host array of S words; acoef has C
// floats per surface; ztab is the device Zernike table; opd_mode must be
// this library's GRAD_MODE; polar is a polarized launch's host array
// [n_ev, scale, a0, b0, a1, b1], which only a polarized library (GRAD_POL
// 1) takes, or null, which only the others take; part holds
// gen_grad_partials_size floats;
// dpx_wf/dpy_wf hold W*F*n floats each, or are null (then dpx/dpy are not
// written). On success *variant, when not null, is the variant launched
// (VAR_NARROW, VAR_WIDE, VAR_FREEFORM or VAR_FORBES). Allocates nothing
// and does not
// synchronise.
extern "C" int gen_grad_launch(const float* gen, const float* consts,
                               const float* acoef, const float* ztab,
                               const float* px,
                               const float* py, const float* cot, float* part,
                               float* dpx_wf, float* dpy_wf, float* dgen,
                               float* dconsts, float* dacoef, float* dpx,
                               float* dpy, const int32_t* flags, int S, int F,
                               int W, int C, long long n, int final_prop,
                               int opd_mode, const float* polar, void* stream,
                               int* variant) {
    GradLayout g;
    if (S < 1 || S > MAX_SURF || F < 1 || W < 1 || F > 65535 || W > 65535 ||
        n < 1 || C < 0 || (dpx_wf == nullptr) != (dpy_wf == nullptr) ||
        opd_mode != GRAD_MODE || (polar != nullptr) != (bool)GRAD_POL ||
        !make_layout(flags, S, C, g))
        return (int)cudaErrorInvalidValue;
    PolLaunch pl;
    if (!polar_launch_of(polar, pl)) return (int)cudaErrorInvalidValue;
    for (int k = 0; k < S; ++k)
        if (acoef_width_of(g.f[k]) > C) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int nblk = n_blocks(n);
    const dim3 grid((unsigned)nblk, (unsigned)F, (unsigned)W);
    const int var = variant_of(g.f, S);
    int err = 0;
    if constexpr (GRAD_MODE != OPD_SPLIT) {
        // the split mode takes no freeform sag (make_layout), so its
        // FREEFORM and FORBES variants are not built
        if (var == VAR_FORBES)
            err = launch_grad<VAR_FORBES>(grid, st, gen, consts, acoef, ztab,
                                          px, py, cot, part, dpx_wf, dpy_wf, g,
                                          S, F, W, C, n, nblk, final_prop, pl);
        if (var == VAR_FREEFORM)
            err = launch_grad<VAR_FREEFORM>(grid, st, gen, consts, acoef, ztab,
                                            px, py, cot, part, dpx_wf, dpy_wf, g,
                                            S, F, W, C, n, nblk, final_prop, pl);
    }
    if (var == VAR_WIDE)
        err = launch_grad<VAR_WIDE>(grid, st, gen, consts, acoef, ztab, px, py,
                                    cot, part, dpx_wf, dpy_wf, g, S, F, W, C, n,
                                    nblk, final_prop, pl);
    else if (var == VAR_NARROW)
        err = launch_grad<VAR_NARROW>(grid, st, gen, consts, acoef, ztab, px,
                                      py, cot, part, dpx_wf, dpy_wf, g, S, F, W,
                                      C, n, nblk, final_prop, pl);
    if (err) return err;
    if (variant != nullptr) *variant = var;
    const long long n_out = (long long)W * S * CONST_W + (long long)F * GEN_W
                            + (long long)S * C;
    gen_grad_reduce<<<(unsigned)n_out, RBLOCK, 0, st>>>(part, dgen, dconsts,
                                                        dacoef, g, S, F, W,
                                                        nblk, C);
    err = (int)cudaGetLastError();
    if (err || dpx_wf == nullptr) return err;
    const unsigned g1 = (unsigned)((n + RBLOCK - 1) / RBLOCK);
    sum_wf<<<g1, RBLOCK, 0, st>>>(dpx_wf, dpx, W * F, n);
    err = (int)cudaGetLastError();
    if (err) return err;
    sum_wf<<<g1, RBLOCK, 0, st>>>(dpy_wf, dpy, W * F, n);
    return (int)cudaGetLastError();
}
