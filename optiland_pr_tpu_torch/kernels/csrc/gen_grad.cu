// K2, sub-slices (a), (b), the even/odd aspheres of (c) and the OPD modes
// of (g): the vector-Jacobian product of K1 (gen_trace.cu) by per-ray
// recompute and a per-surface reverse sweep, one ray per thread.
//
// One library per OPD mode: this file builds the plain mode's, and
// gen_grad_kahan.cu and gen_grad_split.cu include it with GRAD_MODE set to
// OPD_KAHAN and OPD_SPLIT. Each library holds its mode's 8 template
// instances, and the three build in parallel.
//
// Replaces the TPU kernel optiland_pr_tpu/kernels/pallas_grad.py::
// _pallas_gen_bwd_2d (body _gen_bwd_kernel -> _manual_vjp) for conic, plane
// and even/odd aspheric surfaces that refract or reflect, with absorption in
// the pre-material, tilt/decenter, radial and offset-radial apertures and
// simple coatings. The TPU kernel ran jax.vjp inside the kernel; here the
// adjoint of every branch is written out by hand, and it follows the
// derivative conventions of PyTorch autograd on the plain version
// (kernels/gen_grad.py::gen_trace_bwd_plain), which it is held against:
//   - where(c, a, b) sends the cotangent to the taken branch only; the
//     guarded square roots (sqrt(ok ? d : 1), sqrt(arg > eps ? arg : eps))
//     get none on the guarded side, max(r^2, 1e-24) none below the floor;
//   - eps_guard passes the cotangent on |v| > eps and none on its clamp;
//   - sign() has zero derivative; |v| has derivative sign(v), 0 at 0;
//   - 1/sqrt(s) is differentiated as reciprocal(sqrt(s));
//   - the asphere's Newton steps are not differentiated: only its live last
//     step is, so the cotangent is the implicit-function-theorem one, and
//     the conic warm start gets none;
//   - the aperture mask passes the intensity cotangent inside and none
//     outside, and gives the aperture extents none;
//   - the Kahan update (opd, opd_c) <- (opd + (v - opd_c), ((opd + (v -
//     opd_c)) - opd) - (v - opd_c)) is linear: with g, gc the cotangents of
//     the new opd and opd_c, the sum's gtk = g + gc, and opd, v and opd_c
//     get gtk - gc, gtk - gc and -(gtk - gc), as autograd forms them;
//   - the split mode's sag refresh clamps its root's argument at eps, which
//     passes no cotangent, and the propagated z it replaces gets none.
//
// Inputs: the forward's tables and pupil samples (gen_trace_common.cuh,
// gen_trace.cu) and the cotangents of its 8 outputs, cot [8, W, F, n].
// Outputs:
//   dgen    [F, 16]    columns 0-6, 8, 9 (the rest are 0), summed over W
//   dconsts [W, S, 32] columns 0-5; 6 on a coated surface; 8-19 on a tilted
//                      or decentered one; 27 (the vertex gap) in the split
//                      mode (the rest are 0)
//   dacoef  [S, C]     the asphere terms' (the rest are 0), summed over W
//   dPx, dPy [n]       summed over W and F (optional)
//
// Design.
//   1. gen_grad_kernel, grid (ceil(n/256), F, W) as in K1. Each thread runs
//      the shared forward (gen_trace_common.cuh), so its lost-ray mask is
//      K1's bit for bit, and keeps the boundary state of every surface
//      (x, y, z, L, M, N, intensity: 7 floats) in a local array. The kernel
//      is a template on a stack-depth bucket (8, 16, 32, 64 surfaces) so the
//      local array is sized for the system, not for the 64-surface maximum;
//      it is indexed by the runtime surface number, so it lives in local
//      memory (L1/L2), not in registers. Recompute from checkpoints would
//      save that memory at O(S^2) arithmetic, and the kernel is bound by
//      arithmetic (PERF.md). It is a template on WIDE too, as K1: the
//      variant without (b) and (c) runs for conic/plane systems.
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
//      columns 0-5, then 6 if coated, then 8-19 if tilted, then its asphere
//      terms, then column 27 in the split mode; dgen's 9 follow the last
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
// bound, so it is bound by instruction issue, as K1 is (PERF.md).
#include "gen_trace_common.cuh"

#ifndef GRAD_MODE
#define GRAD_MODE OPD_PLAIN
#endif

#define GBLOCK 256
#define NWARP (GBLOCK / 32)
#define NGEN 9        // gen columns with a cotangent: 0-6, 8, 9
#define NDC 19        // consts columns with a cotangent: 0-6, 8-19
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

__host__ __device__ __forceinline__ int n_slots(int fl) {
    return 6 + ((fl & FLAG_COAT) ? 1 : 0) + ((fl & FLAG_CS) ? 12 : 0) + nu_of(fl);
}

// Slot of consts column j of surface k, or -1 if it has no cotangent.
__device__ __forceinline__ int const_slot(const GradLayout& g, int k, int j) {
    const int fl = g.f[k];
    const int coat = (fl & FLAG_COAT) ? 1 : 0;
    if (j < 6) return g.qoff[k] + j;
    if (j == 6) return coat ? g.qoff[k] + 6 : -1;
    if (j >= 8 && j <= 19 && (fl & FLAG_CS)) return g.qoff[k] + 6 + coat + (j - 8);
    if (j == 27 && g.split) return g.qoff[k] + n_slots(fl);
    return -1;
}

// Slot of asphere term i of surface k, or -1.
__device__ __forceinline__ int acoef_slot(const GradLayout& g, int k, int i) {
    const int fl = g.f[k];
    if (i >= nu_of(fl)) return -1;
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

// Adjoint of surface_step. ``in`` is the surface's input state, ``tp`` its
// recomputed intermediates. ``a`` holds the cotangent of the output state on
// entry and of the input state on return; dc receives the cotangents of
// consts columns 0-6 and 8-19 (dc[7 + j - 8] for column j >= 8), da those of
// the surface's asphere terms, dgap that of column 27 (the split mode).
template <bool WIDE, int MODE>
__device__ __forceinline__ void surface_adjoint(const float* c, const float* ac,
                                                int fl, float sigma,
                                                const RayState& in,
                                                const SurfTape& tp, Adj& a,
                                                float dc[NDC], float* da,
                                                float& dgap) {
    const float ri = c[0], conic = c[1];
    const float n1 = c[3], n2 = c[4], alpha = c[5];
    const bool cs = WIDE && (fl & FLAG_CS);
    const int gk = WIDE ? gkind_of(fl) : GK_CONIC;
    const bool odd = gk == GK_ODD;
    const int nu = WIDE ? nu_of(fl) : 0;
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

    // ---- refract or reflect ------------------------------------------------
    float aL = 0.0f, aM = 0.0f, aN = 0.0f;     // cotangents of L, M, N in
    if (gk == GK_CONIC && (fl & FLAG_PLANE)) {
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
        if (gk != GK_CONIC) {
            // (dfdx, dfdy) = the asphere's slope at (x2, y2)
            asphere_sag_adjoint(ri, conic, ac, nu, odd, x2, y2, 0.0f, ddfdx,
                                ddfdy, ax2, ay2, dri, dconic, da);
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
    if (gk != GK_CONIC) {
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
        asphere_sag_adjoint(ri, conic, ac, nu, odd, tp.xx, tp.yy, df,
                            ddd * L, ddd * M, dxx, dyy, dri, dconic, da);
        const float dzz = -df;
        ax += dxx;
        ay += dyy;
        az1 += dzz;
        aL += dxx * tp.t_it;
        aM += dyy * tp.t_it;
        aN += dzz * tp.t_it;
    } else if (fl & FLAG_PLANE) {              // t = (-z1) / N
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

template <int MAXS, bool WIDE, int MODE>
__global__ void __launch_bounds__(GBLOCK)
gen_grad_kernel(const float* __restrict__ gen, const float* __restrict__ consts,
                const float* __restrict__ acoef, const float* __restrict__ px,
                const float* __restrict__ py, const float* __restrict__ cot,
                float* __restrict__ part, float* __restrict__ dpx_wf,
                float* __restrict__ dpy_wf, const GradLayout layout, int S,
                int F, int W, int C, long long n, int nblk, int final_prop) {
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

    // ---- forward, keeping each surface's input state ----------------------
    float st[MAXS][7];
    RayState s;
    gen_prologue<MODE>(sg, Px, Py, s);
    float sigma = 1.0f;
    for (int k = 0; k < S; ++k) {
        st[k][0] = s.x;
        st[k][1] = s.y;
        st[k][2] = s.z;
        st[k][3] = s.L;
        st[k][4] = s.M;
        st[k][5] = s.N;
        st[k][6] = s.inten;
        SurfTape tp;
        surface_step<WIDE, MODE>(sc + k * CONST_W, acoef + (size_t)k * C,
                                 layout.f[k], sigma, s, tp);
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
        RayState out = in;
        SurfTape tp;
        surface_step<WIDE, MODE>(c, ac, fl, sigma, out, tp);
        float dc[NDC];
        float da[WIDE ? MAX_TERMS : 1];
        const int nu = WIDE ? nu_of(fl) : 0;
        for (int j = 0; j < nu; ++j) da[j] = 0.0f;
        float dgap;
        surface_adjoint<WIDE, MODE>(c, ac, fl, sigma, in, tp, a, dc, da, dgap);
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
                for (int j = 7; j < NDC; ++j) {
                    const float v = warp_sum(active ? dc[j] : 0.0f);
                    if (lane == 0) sw[warp * nq + q + j - 7] = v;
                }
                q += 12;
            }
            for (int j = 0; j < nu; ++j) {
                const float v = warp_sum(active ? da[j] : 0.0f);
                if (lane == 0) sw[warp * nq + q + j] = v;
            }
        }
    }

    // ---- prologue ------------------------------------------------------------
    const float* g = sg;
    const float x = add(mul(Px, g[0]), g[2]);
    const float y = add(mul(Py, g[1]), g[3]);
    const float z = g[4];
    const float dxr = sub(mul(Px, g[8]), x);
    const float dyr = sub(mul(Py, g[9]), y);
    const float dzr = sub(g[5], z);
    const float smag = sqt(add(add(mul(dxr, dxr), mul(dyr, dyr)), mul(dzr, dzr)));
    const float inv_mag = dvd(1.0f, smag);
    // (L, M, N) = (dxr, dyr, dzr) * inv_mag
    const float dinv = a.L * dxr + a.M * dyr + a.N * dzr;
    float ddxr = a.L * inv_mag, ddyr = a.M * inv_mag, ddzr = a.N * inv_mag;
    const float dsm = -dinv * (inv_mag * inv_mag) / (2.0f * smag);
    ddxr += 2.0f * dxr * dsm;
    ddyr += 2.0f * dyr * dsm;
    ddzr += 2.0f * dzr * dsm;
    float ax = a.x - ddxr, ay = a.y - ddyr;
    // the split frame's launch z is 0, not g4
    const float az = (MODE == OPD_SPLIT ? 0.0f : a.z) - ddzr;
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
        dpx_wf[o] = ddxr * g[8] + ax * g[0];
        dpy_wf[o] = ddyr * g[9] + ay * g[1];
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
        if (nu_of(g.f[k]) > (C < MAX_TERMS ? C : MAX_TERMS)) return false;
        g.qoff[k] = q;
        if (k < S) q += n_slots(g.f[k]) + g.split;
    }
    g.qoff[MAX_SURF] = q;
    return !g.split || split_ok(g.f, S);
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

template <int MAXS, bool WIDE>
static int launch_bucket(dim3 grid, cudaStream_t stream, const float* gen,
                         const float* consts, const float* acoef,
                         const float* px, const float* py, const float* cot,
                         float* part, float* dpx_wf, float* dpy_wf,
                         const GradLayout& g, int S, int F, int W, int C,
                         long long n, int nblk, int final_prop) {
    const size_t shmem = (size_t)NWARP * (g.qoff[S] + NGEN) * sizeof(float);
    if (shmem > 48 * 1024) {
        const int err = (int)cudaFuncSetAttribute(
            gen_grad_kernel<MAXS, WIDE, GRAD_MODE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
        if (err) return err;
    }
    gen_grad_kernel<MAXS, WIDE, GRAD_MODE><<<grid, GBLOCK, shmem, stream>>>(
        gen, consts, acoef, px, py, cot, part, dpx_wf, dpy_wf, g, S, F, W, C,
        n, nblk, final_prop);
    return (int)cudaGetLastError();
}

template <bool WIDE>
static int launch_grad(dim3 grid, cudaStream_t st, const float* gen,
                       const float* consts, const float* acoef,
                       const float* px, const float* py, const float* cot,
                       float* part, float* dpx_wf, float* dpy_wf,
                       const GradLayout& g, int S, int F, int W, int C,
                       long long n, int nblk, int final_prop) {
    if (S <= 8)
        return launch_bucket<8, WIDE>(grid, st, gen, consts, acoef, px, py, cot,
                                      part, dpx_wf, dpy_wf, g, S, F, W, C, n,
                                      nblk, final_prop);
    if (S <= 16)
        return launch_bucket<16, WIDE>(grid, st, gen, consts, acoef, px, py, cot,
                                       part, dpx_wf, dpy_wf, g, S, F, W, C, n,
                                       nblk, final_prop);
    if (S <= 32)
        return launch_bucket<32, WIDE>(grid, st, gen, consts, acoef, px, py, cot,
                                       part, dpx_wf, dpy_wf, g, S, F, W, C, n,
                                       nblk, final_prop);
    return launch_bucket<64, WIDE>(grid, st, gen, consts, acoef, px, py, cot,
                                   part, dpx_wf, dpy_wf, g, S, F, W, C, n,
                                   nblk, final_prop);
}

// Launch the three kernels on ``stream``; returns cudaGetLastError() after
// each launch (0 on success). flags is a host array of S words; acoef has C
// floats per surface; opd_mode must be this library's GRAD_MODE; part holds
// gen_grad_partials_size floats;
// dpx_wf/dpy_wf hold W*F*n floats each, or are null (then dpx/dpy are not
// written). Allocates nothing and does not synchronise.
extern "C" int gen_grad_launch(const float* gen, const float* consts,
                               const float* acoef, const float* px,
                               const float* py, const float* cot, float* part,
                               float* dpx_wf, float* dpy_wf, float* dgen,
                               float* dconsts, float* dacoef, float* dpx,
                               float* dpy, const int32_t* flags, int S, int F,
                               int W, int C, long long n, int final_prop,
                               int opd_mode, void* stream) {
    GradLayout g;
    if (S < 1 || S > MAX_SURF || F < 1 || W < 1 || F > 65535 || W > 65535 ||
        n < 1 || C < 0 || (dpx_wf == nullptr) != (dpy_wf == nullptr) ||
        opd_mode != GRAD_MODE || !make_layout(flags, S, C, g))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int nblk = n_blocks(n);
    const dim3 grid((unsigned)nblk, (unsigned)F, (unsigned)W);
    int err = needs_wide(g.f, S)
        ? launch_grad<true>(grid, st, gen, consts, acoef, px, py, cot, part,
                            dpx_wf, dpy_wf, g, S, F, W, C, n, nblk, final_prop)
        : launch_grad<false>(grid, st, gen, consts, acoef, px, py, cot, part,
                             dpx_wf, dpy_wf, g, S, F, W, C, n, nblk, final_prop);
    if (err) return err;
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
