// Device code of K1 shared by the forward kernel (gen_trace.cu) and the
// backward kernel K2 (gen_grad.cu): the launch prologue, the surface step
// and the image epilogue, for sub-slices (a) conic and plane surfaces that
// refract, reflect and absorb, (b) tilt/decenter, radial and offset-radial
// apertures and simple coatings, and the even/odd aspheres of (c).
//
// Both kernels run this one forward, so K2's recomputed forward is bit for
// bit K1's, lost-ray masks included.
//
// Counterpart of optiland_pr_tpu/kernels/pallas_trace.py: _gen_prologue
// (non-split path, 2008-2054), _surface_step (1308-1754: localize
// 1345-1360, the conic root 1371-1404, the Newton refinement 1406-1440, the
// aperture 1493-1500, the freeform normal 1663-1671, the coating 1733-1736,
// globalize 1738-1748), _asphere_sag_grad (396-432) and _gen_epilogue
// (2123-2140).
//
// Layout (shared with the plain version, kernels/gen_trace.py):
//   gen    [F, 16]     per-field launch constants (origin/aim coefficients,
//                      field offsets, launch z, EPL, image thickness)
//   consts [W, S, 32]  per-wavelength, per-surface scalars; columns
//                      0 radius_inv 1 conic 2 pos_z 3 n1 4 n2 5 alpha_abs
//                      6 coating factor 8-16 rotation (row-major)
//                      17-19 translation (tx, ty, pos_z + dz)
//                      20 r_min^2 21 r_max^2 22-23 aperture offset
//   acoef  [S, C]      asphere terms, row k for surface k
//   flags  [S]         bits 0 plane, 1 reflective, 2 absorbing, 3 tilted or
//                      decentered, 4 aperture, 5 simple coating; bits 6-7 the
//                      sag (0 conic, 1 even asphere, 2 odd asphere); bits
//                      8-15 the number of asphere terms
//
// Rounding: every operation is an explicit IEEE round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts
// into an FMA, in the order of the plain PyTorch version. The kernels and the
// plain version on the card therefore agree bit for bit. Built without
// --use_fast_math.
//
// Variants: surface_step is a template on WIDE. With WIDE false it compiles
// only sub-slice (a), the code that ran before (b) and (c) existed, so a
// conic/plane system keeps its register count and speed; the host launches
// the WIDE variant only when a flag word has a bit of (b) or (c).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CONST_W 32
#define GEN_W 16
#define MAX_SURF 64
#define MAX_TERMS 32
#define NEWTON_ITERS 8

enum { FLAG_PLANE = 1, FLAG_REFL = 2, FLAG_ABSORB = 4, FLAG_CS = 8,
       FLAG_AP = 16, FLAG_COAT = 32 };
enum { GK_CONIC = 0, GK_EVEN = 1, GK_ODD = 2 };
#define GKIND_SHIFT 6
#define NU_SHIFT 8
// the bits that need the WIDE variant
#define WIDE_MASK (FLAG_CS | FLAG_AP | FLAG_COAT | (3 << GKIND_SHIFT))

__host__ __device__ __forceinline__ int gkind_of(int fl) { return (fl >> GKIND_SHIFT) & 3; }
__host__ __device__ __forceinline__ int nu_of(int fl) { return (fl >> NU_SHIFT) & 255; }

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
    bool valid;
};

// Intermediates of one surface step. K1 discards them (the stores are dead
// code after inlining); K2's reverse sweep reads them back.
struct SurfTape {
    // the state in the surface's frame before the intersection
    float xl, yl, zl, Ll, Ml, Nl;
    // intersection
    float t0, x0, y0, a, bh, cc, sq, q, ag, qg, t_far, t_near, t;
    bool ok, near;
    // the asphere's live Newton step: root estimate, point, residual, raw
    // and guarded slope, sag gradient there
    float t_it, xx, yy, f, dd, dg, ngx, ngy;
    // absorption factor; the position after propagation (local frame); the
    // aperture mask; the intensity before the coating
    float e, x2, y2, z2, mask, inten_pc;
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

// ---- prologue: launch by generalized aiming (_gen_prologue) -------------
__device__ __forceinline__ void gen_prologue(const float* g, float Px, float Py,
                                             RayState& s) {
    s.x = add(mul(Px, g[0]), g[2]);
    s.y = add(mul(Py, g[1]), g[3]);
    s.z = g[4];
    const float dxr = sub(mul(Px, g[8]), s.x);
    const float dyr = sub(mul(Py, g[9]), s.y);
    const float dzr = sub(g[5], s.z);
    const float inv_mag = rsq(add(add(mul(dxr, dxr), mul(dyr, dyr)), mul(dzr, dzr)));
    s.L = mul(dxr, inv_mag);
    s.M = mul(dyr, inv_mag);
    s.N = mul(dzr, inv_mag);
    s.inten = 1.0f;
    s.opd = 0.0f;
    s.valid = true;
}

// ---- one surface (_surface_step) -------------------------------------------
// c: the surface's constant row; ac: its asphere terms (read only by WIDE).
template <bool WIDE>
__device__ __forceinline__ void surface_step(const float* c, const float* ac,
                                             int fl, RayState& s,
                                             SurfTape& tp) {
    const float ri = c[0], conic = c[1], pos_z = c[2];
    const float n1 = c[3], n2 = c[4], alpha = c[5];
    const bool cs = WIDE && (fl & FLAG_CS);
    const int gk = WIDE ? gkind_of(fl) : GK_CONIC;
    const bool odd = gk == GK_ODD;
    const int nu = WIDE ? nu_of(fl) : 0;
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
    } else {
        z = sub(s.z, pos_z);
    }
    tp.xl = x;
    tp.yl = y;
    tp.zl = z;
    tp.Ll = L;
    tp.Ml = M;
    tp.Nl = N;

    // the conic root (the asphere's warm start)
    float t;
    if (fl & FLAG_PLANE) {
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
        const float tq = tp.near ? tp.t_near : tp.t_far;
        t = add(tp.t0, tp.ok ? tq : 0.0f);
        s.valid = s.valid && tp.ok;
    }

    // asphere: NEWTON_ITERS steps from the warm start, then the live step
    // (the plain version runs the steps without gradient)
    if (gk != GK_CONIC) {
        float t_it = t;
        for (int it = 0; it <= NEWTON_ITERS; ++it) {
            const float xx = add(x, mul(t_it, L));
            const float yy = add(y, mul(t_it, M));
            const float zz = add(z, mul(t_it, N));
            const Sag g = asphere_sag_grad(ri, conic, ac, nu, odd, xx, yy);
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
    s.opd = add(s.opd, fabsf(mul(t, n1)));
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
    if (gk == GK_CONIC && (fl & FLAG_PLANE)) {
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
        if (gk == GK_CONIC) {
            tp.r2 = add(mul(x, x), mul(y, y));
            tp.arg = sub(1.0f, mul(mul(mul(add(1.0f, conic), ri), ri), tp.r2));
            tp.sr = sqt(tp.arg > EPS_GUARD ? tp.arg : 1.0f);
            tp.inv_root = dvd(1.0f, tp.sr);
            tp.dfdx = mul(mul(x, ri), tp.inv_root);
            tp.dfdy = mul(mul(y, ri), tp.inv_root);
        } else {                               // the asphere's own slope
            const Sag g = asphere_sag_grad(ri, conic, ac, nu, odd, x, y);
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
        s.z = add(z, pos_z);
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

// True when a flag word needs the WIDE variant.
static inline bool needs_wide(const int32_t* flags, int S) {
    for (int k = 0; k < S; ++k)
        if (flags[k] & WIDE_MASK) return true;
    return false;
}
