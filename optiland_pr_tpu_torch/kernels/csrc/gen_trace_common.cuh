// Device code of K1, sub-slice (a), shared by the forward kernel
// (gen_trace.cu) and the backward kernel K2 (gen_grad.cu): the launch
// prologue, the conic/plane surface step and the image epilogue.
//
// Both kernels run this one forward, so K2's recomputed forward is bit for
// bit K1's, lost-ray masks included.
//
// Counterpart of optiland_pr_tpu/kernels/pallas_trace.py: _gen_prologue
// (non-split path, 2008-2054), the conic path of _surface_step (1308-1754)
// and _gen_epilogue (2123-2140).
//
// Layout (shared with the plain version, kernels/gen_trace.py):
//   gen    [F, 16]     per-field launch constants (origin/aim coefficients,
//                      field offsets, launch z, EPL, image thickness)
//   consts [W, S, 32]  per-wavelength, per-surface scalars; columns
//                      0 radius_inv 1 conic 2 pos_z 3 n1 4 n2 5 alpha_abs
//   flags  [S]         bit 0 plane, bit 1 reflective, bit 2 absorbing
//
// Rounding: every operation is an explicit IEEE round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts
// into an FMA, in the order of the plain PyTorch version. The kernels and the
// plain version on the card therefore agree bit for bit. Built without
// --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CONST_W 32
#define GEN_W 16
#define MAX_SURF 64

enum { FLAG_PLANE = 1, FLAG_REFL = 2, FLAG_ABSORB = 4 };

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
    // intersection
    float t0, x0, y0, a, bh, cc, sq, q, ag, qg, t_far, t_near, t;
    bool ok, near;
    // absorption factor
    float e;
    // refraction
    float u, root_r, w;
    bool ok_r;
    // conic normal
    float r2, arg, sr, inv_root, dfdx, dfdy, sn, inv_n, nx, ny, nz, dot;
};

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

// ---- one surface (_surface_step, conic path) ------------------------------
__device__ __forceinline__ void surface_step(const float* c, int fl, RayState& s,
                                             SurfTape& tp) {
    const float ri = c[0], conic = c[1], pos_z = c[2];
    const float n1 = c[3], n2 = c[4], alpha = c[5];
    const float L = s.L, M = s.M, N = s.N;
    float x = s.x, y = s.y;
    float z = sub(s.z, pos_z);

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
    tp.t = t;

    x = add(x, mul(t, L));
    y = add(y, mul(t, M));
    z = add(z, mul(t, N));
    s.opd = add(s.opd, fabsf(mul(t, n1)));
    if (fl & FLAG_ABSORB) {
        tp.e = expf(mul(mul(-alpha, t), 1000.0f));
        s.inten = mul(s.inten, tp.e);
    }

    float Lo = L, Mo = M, No = N;
    if (fl & FLAG_PLANE) {
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
        tp.r2 = add(mul(x, x), mul(y, y));
        tp.arg = sub(1.0f, mul(mul(mul(add(1.0f, conic), ri), ri), tp.r2));
        tp.sr = sqt(tp.arg > EPS_GUARD ? tp.arg : 1.0f);
        tp.inv_root = dvd(1.0f, tp.sr);
        tp.dfdx = mul(mul(x, ri), tp.inv_root);
        tp.dfdy = mul(mul(y, ri), tp.inv_root);
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
    s.x = x;
    s.y = y;
    s.z = add(z, pos_z);
    s.L = Lo;
    s.M = Mo;
    s.N = No;
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
