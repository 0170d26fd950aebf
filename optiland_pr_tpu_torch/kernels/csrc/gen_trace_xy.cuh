// Device code of sub-slice (h), the coord_split mode of K1 and K2: the
// launch, the surface step and the image propagation with the ray state
// (x, y, z, L, M, N, opd) in float64, shared by the forward kernel
// (gen_trace_xy.cu) and the backward kernel (gen_grad_xy.cu), so that K2's
// recomputed forward is K1's bit for bit.
//
// Counterpart of optiland_pr_tpu/kernels/pallas_trace.py: the split == "xy"
// branch of _gen_prologue (1969-2007), _surface_step_xy (1261-1309) with
// _df32_chain (1153-1258), and the split == "xy" branch of _gen_epilogue
// (2103-2122). The TPU has no float64 and its multiply-add is not an IEEE
// FMA, so the JAX kernel carries the state as two-float (hi, lo) pairs of
// float32 built from bitmask splits (_two_prod, _split12) behind XLA
// optimization barriers (_ob), ~47 bits of significand. The H100 has IEEE
// float64 at half its float32 rate: one instruction per operation against
// ~8 (multiply) to ~20 (add) float32 instructions for a two-float one, and
// 53 bits. So this is the same mathematics in the same order on the same
// float32 inputs, rounded to float32 once at the end; only the working
// precision differs.
//
// Scope (supports_split_xy, xy_ok): untilted conic and plane surfaces that
// refract or reflect, with absorption, radial apertures and simple coatings
// as runtime branches on the flag word, an unpolarized launch at the
// entrance pupil or object-space telecentric, with or without a closed-form
// apodization. The state's z is local to the previous vertex (0 at the
// launch plane), each surface shifts it by its signed gap (column 27,
// surface 1's from the launch plane), and the curvature is the two-float
// pair's sum c[0] + c[28] (column 28: the low word of 1 / R against its
// float32-rounded high word). The scalars the JAX chain keeps in float32
// stay float32: u = n1 / n2, -(u u), -(1 + conic) and the aim's axial
// distance g5 - g4. Absorption, the aperture and the coating act in float32
// on the rounded t and position, as _surface_step_xy does (1290-1300).
//
// Why not the float32 conic step of gen_trace_common.cuh on a template
// real type: the JAX chain differs from the float32 step in its operation
// order (the normal is (x / sqrt(arg)) c, not (x c) / sqrt(arg); the root
// pairing takes t_far = q_guarded / a_guarded; the OPD adds t n1, not
// |t n1|; the refraction's sign of 0 is +1; the split sag refresh is
// absent), so a shared template would need a branch at each of those and
// would change nothing that either instance computes.
//
// Rounding: every float64 operation is an explicit IEEE round-to-nearest
// intrinsic (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn, __dsqrt_rn), which
// nvcc never contracts, in the order of the plain PyTorch version
// (kernels/gen_trace.py::_xy_surface), so the kernel and the plain version
// on the card agree bit for bit.
#pragma once

#include "gen_trace_common.cuh"

__device__ __forceinline__ double mul64(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add64(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub64(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double div64(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqt64(double a) { return __dsqrt_rn(a); }

#define EPS_GUARD_D 1e-14

// |v| > eps ? v : (v >= 0 ? eps : -eps)  (pallas_trace.py:1195-1198)
__device__ __forceinline__ double eps_guard_d(double v) {
    return fabs(v) > EPS_GUARD_D ? v : (v >= 0.0 ? EPS_GUARD_D : -EPS_GUARD_D);
}

// The ray state; the intensity and validity as the float32 modes carry them.
struct XyRay {
    double x, y, z, L, M, N, opd;
    float inten;
    bool valid;
};

// The launch's aim and its normalization (K2 reads them back).
struct XyLaunch {
    double dxr, dyr, dzr, sm, im;
};

// Intermediates of one surface step. K1 discards them (dead stores after
// inlining); K2's reverse sweep reads them back.
struct XyTape {
    double ci;                                  // c[0] + c[28]
    double t0, x0, y0, a, bh, cc, sq, q, qg, ag, t_near, t_far, t;
    bool ok, near;
    double x2, y2;                              // the landing point
    float t32, e, mask, inten_pc;               // the float32 factors
    double r2, ci2, k1, arg, sr, ir, xir, yir, dfdx, dfdy, sn, im;
    double nx, ny, nz, dot;                     // the conic's normal
    float u32;                                  // n1 / n2 in float32
    double u, nuu, root, w;                     // the refraction
    bool ok_r;
};

// ---- the launch (_gen_prologue, split == "xy") ----------------------------
// origin Px g0 + g2, local z 0; the aim Px g8 - x at the axial distance
// g5 - g4 (float32), or the telecentric aim Px g8 at g5 (column 10)
__device__ __forceinline__ void xy_launch(const float* g, float Px, float Py,
                                          XyRay& s, XyLaunch& lt) {
    const double px = Px, py = Py;
    s.x = add64(mul64(px, g[0]), g[2]);
    s.y = add64(mul64(py, g[1]), g[3]);
    s.z = 0.0;
    const bool tele = g[10] != 0.0f;
    lt.dxr = tele ? mul64(px, g[8]) : sub64(mul64(px, g[8]), s.x);
    lt.dyr = tele ? mul64(py, g[9]) : sub64(mul64(py, g[9]), s.y);
    lt.dzr = tele ? (double)g[5] : (double)__fsub_rn(g[5], g[4]);
    lt.sm = sqt64(add64(add64(mul64(lt.dxr, lt.dxr), mul64(lt.dyr, lt.dyr)),
                      mul64(lt.dzr, lt.dzr)));
    lt.im = div64(1.0, lt.sm);
    s.L = mul64(lt.dxr, lt.im);
    s.M = mul64(lt.dyr, lt.im);
    s.N = mul64(lt.dzr, lt.im);
    s.inten = apod_weight(g, Px, Py);
    s.opd = 0.0;
    s.valid = true;
}

// ---- one surface (_surface_step_xy) ---------------------------------------
__device__ __forceinline__ void xy_step(const float* c, int fl, XyRay& s,
                                        XyTape& tp) {
    const double conic = c[1], n1 = c[3];
    const bool plane = fl & FLAG_PLANE, refl = fl & FLAG_REFL;
    tp.ci = add64((double)c[0], (double)c[28]);
    const double x = s.x, y = s.y, L = s.L, M = s.M, N = s.N;
    const double z = sub64(s.z, (double)c[27]);

    // the conic root, paired for the near intersection (citardauq)
    double t;
    if (plane) {
        t = div64(-z, N);
    } else {
        tp.t0 = div64(-z, N);
        tp.x0 = add64(x, mul64(tp.t0, L));
        tp.y0 = add64(y, mul64(tp.t0, M));
        tp.a = mul64(add64(mul64(mul64(N, N), conic), 1.0), tp.ci);
        tp.bh = sub64(mul64(add64(mul64(L, tp.x0), mul64(M, tp.y0)), tp.ci), N);
        tp.cc = mul64(add64(mul64(tp.x0, tp.x0), mul64(tp.y0, tp.y0)), tp.ci);
        const double disc = sub64(mul64(tp.bh, tp.bh), mul64(tp.a, tp.cc));
        tp.ok = disc >= 0.0;
        tp.sq = sqt64(tp.ok ? disc : 1.0);
        // sign(0) := +1 for the root pairing (_sign_pm)
        tp.q = -add64(tp.bh, tp.bh >= 0.0 ? tp.sq : -tp.sq);
        tp.qg = eps_guard_d(tp.q);
        tp.ag = eps_guard_d(tp.a);
        tp.t_near = div64(tp.cc, tp.qg);
        tp.t_far = div64(tp.qg, tp.ag);
        tp.near = fabs(tp.t_near) <= fabs(tp.t_far);
        t = add64(tp.t0, tp.ok ? (tp.near ? tp.t_near : tp.t_far) : 0.0);
        s.valid = s.valid && tp.ok;
    }
    tp.t = t;
    tp.x2 = add64(x, mul64(t, L));
    tp.y2 = add64(y, mul64(t, M));
    s.z = add64(z, mul64(t, N));
    s.opd = add64(s.opd, mul64(t, n1));

    // reflect or refract
    double Lo = L, Mo = M, No = N;
    if (!(plane && refl)) {
        tp.u32 = __fdiv_rn(c[3], c[4]);
        tp.u = tp.u32;
        tp.nuu = (double)__fmul_rn(-tp.u32, tp.u32);
    }
    if (plane && refl) {
        No = -N;
    } else if (plane) {
        const double disc_r = add64(1.0, mul64(sub64(1.0, mul64(N, N)), tp.nuu));
        tp.ok_r = disc_r >= 0.0;
        tp.root = sqt64(tp.ok_r ? disc_r : 1.0);
        s.valid = s.valid && tp.ok_r;
        Lo = mul64(L, tp.u);
        Mo = mul64(M, tp.u);
        No = mul64(tp.root, N >= 0.0 ? 1.0 : -1.0);
    } else {
        const double x2 = tp.x2, y2 = tp.y2;
        tp.r2 = add64(mul64(x2, x2), mul64(y2, y2));
        tp.ci2 = mul64(tp.ci, tp.ci);
        tp.k1 = (double)(-__fadd_rn(1.0f, c[1]));
        tp.arg = add64(1.0, mul64(mul64(tp.r2, tp.ci2), tp.k1));
        tp.sr = sqt64(tp.arg > EPS_GUARD_D ? tp.arg : 1.0);
        tp.ir = div64(1.0, tp.sr);
        tp.xir = mul64(x2, tp.ir);
        tp.yir = mul64(y2, tp.ir);
        tp.dfdx = mul64(tp.xir, tp.ci);
        tp.dfdy = mul64(tp.yir, tp.ci);
        tp.sn = sqt64(add64(add64(mul64(tp.dfdx, tp.dfdx), mul64(tp.dfdy, tp.dfdy)), 1.0));
        tp.im = div64(1.0, tp.sn);
        tp.nx = mul64(tp.dfdx, tp.im);
        tp.ny = mul64(tp.dfdy, tp.im);
        tp.nz = -tp.im;
        tp.dot = add64(add64(mul64(L, tp.nx), mul64(M, tp.ny)), mul64(N, tp.nz));
        if (refl) {
            const double td = mul64(tp.dot, 2.0);
            Lo = sub64(L, mul64(td, tp.nx));
            Mo = sub64(M, mul64(td, tp.ny));
            No = sub64(N, mul64(td, tp.nz));
        } else {
            const double disc_r = add64(1.0, mul64(sub64(1.0, mul64(tp.dot, tp.dot)),
                                                 tp.nuu));
            tp.ok_r = disc_r >= 0.0;
            tp.root = sqt64(tp.ok_r ? disc_r : 1.0);
            s.valid = s.valid && tp.ok_r;
            tp.w = add64(mul64(tp.root, tp.dot >= 0.0 ? 1.0 : -1.0),
                        mul64(tp.dot, -tp.u));
            Lo = add64(mul64(L, tp.u), mul64(tp.nx, tp.w));
            Mo = add64(mul64(M, tp.u), mul64(tp.ny, tp.w));
            No = add64(mul64(N, tp.u), mul64(tp.nz, tp.w));
        }
    }

    // the float32 factors on the rounded t and landing point
    if (fl & FLAG_ABSORB) {
        tp.t32 = (float)t;
        tp.e = expf(__fmul_rn(__fmul_rn(-c[5], tp.t32), 1000.0f));
        s.inten = __fmul_rn(s.inten, tp.e);
    }
    if (fl & FLAG_AP) {
        const float xa = __fsub_rn((float)tp.x2, c[22]);
        const float ya = __fsub_rn((float)tp.y2, c[23]);
        const float r2a = __fadd_rn(__fmul_rn(xa, xa), __fmul_rn(ya, ya));
        tp.mask = (r2a >= c[20] && r2a <= c[21]) ? 1.0f : 0.0f;
        s.inten = __fmul_rn(s.inten, tp.mask);
    }
    if (fl & FLAG_COAT) {
        tp.inten_pc = s.inten;
        s.inten = __fmul_rn(s.inten, c[6]);
    }
    s.x = tp.x2;
    s.y = tp.y2;
    s.L = Lo;
    s.M = Mo;
    s.N = No;
}

// ---- the image propagation (_gen_epilogue, split == "xy") -----------------
__device__ __forceinline__ void xy_epilogue(const float* g, int final_prop,
                                            XyRay& s) {
    if (final_prop) {
        const double t_img = g[6];
        s.x = add64(s.x, mul64(s.L, t_img));
        s.y = add64(s.y, mul64(s.M, t_img));
        s.z = add64(s.z, mul64(s.N, t_img));
    }
}

// True when the coord_split mode can take the flag words: the split mode's
// surfaces (no tilt, no sag but the conic, no grating or phase surface) and
// no Fresnel coating.
static inline bool xy_ok(const int32_t* flags, int S) {
    if (!split_ok(flags, S)) return false;
    for (int k = 0; k < S; ++k)
        if (flags[k] & FLAG_FRESNEL) return false;
    return true;
}
