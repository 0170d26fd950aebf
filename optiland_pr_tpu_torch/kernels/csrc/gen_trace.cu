// K1, sub-slice (a): fused ray generation + conic/plane surface stack +
// image propagation, one ray per thread.
//
// Replaces the TPU kernel optiland_pr_tpu/kernels/pallas_trace.py::
// _pallas_gen_trace_2d (body _gen_kernel -> _gen_pipeline = _gen_prologue,
// _surface_step per surface, _gen_epilogue, _nanify8) for conic and plane
// surfaces that refract or reflect, with absorption in the pre-material.
//
// Layout (shared with the plain version, kernels/gen_trace.py):
//   gen    [F, 16]     per-field launch constants (origin/aim coefficients,
//                      field offsets, launch z, EPL, image thickness)
//   consts [W, S, 32]  per-wavelength, per-surface scalars; columns
//                      0 radius_inv 1 conic 2 pos_z 3 n1 4 n2 5 alpha_abs
//   Px, Py [n]         normalized pupil samples, shared by every (w, f)
//   out    [8, W, F, n] x, y, z, L, M, N, intensity, opd
//   flags  [S]         bit 0 plane, bit 1 reflective, bit 2 absorbing
//
// Design: grid (ceil(n/256), F, W); the block stages its wavelength's [S, 32]
// constant rows and its field's gen row in shared memory (every thread reads
// the same word: a broadcast), keeps the ray state in registers through the
// whole stack, masks the ragged tail, and writes the 8 outputs once. The
// surface loop branches on a flag word that is uniform across the grid, so
// no warp diverges on it.
//
// Bounds on an H100: per ray the kernel reads 8 B and writes 32 B; at
// 36M rays (3 fields x 3 wavelengths x 4M) that is ~1.4 GB, ~0.43 ms at
// 3.35 TB/s. The arithmetic is larger: per conic surface about 60 FP32
// operations plus ~6 IEEE divisions and ~4 IEEE square roots, each a
// multi-instruction sequence with a quarter-rate MUFU step. Measured on an
// H100 (700 W): 1.92 ms for that case, 750 GB/s of output, so the kernel is
// bound by instruction issue, not by memory bandwidth (PERF.md).
//
// Rounding: every operation is an explicit IEEE round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts
// into an FMA, in the order of the plain PyTorch version. The kernel and the
// plain version on the card therefore agree bit for bit, lost-ray masks
// included. Built without --use_fast_math.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CONST_W 32
#define GEN_W 16
#define MAX_SURF 64
#define BLOCK 256

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

// |v| > eps ? v : (v >= 0 ? eps : -eps)  (pallas_trace.py:1397-1400)
__device__ __forceinline__ float eps_guard(float v) {
    const float eps = 1e-14f;
    return fabsf(v) > eps ? v : (v >= 0.0f ? eps : -eps);
}

// jnp.sign(d) * r: sign(0) == 0 here (pallas_trace.py:1513, 1707), unlike
// the +-1 pairing sign of the intersection root
__device__ __forceinline__ float sign_times(float d, float r) {
    return d > 0.0f ? r : (d < 0.0f ? -r : 0.0f);
}

__global__ void __launch_bounds__(BLOCK)
gen_trace_kernel(const float* __restrict__ gen, const float* __restrict__ consts,
                 const float* __restrict__ px, const float* __restrict__ py,
                 float* __restrict__ out, const SurfFlags flags, int S, int F,
                 int W, long long n, int final_prop) {
    __shared__ float sc[MAX_SURF * CONST_W];
    __shared__ float sg[GEN_W];
    const int f = blockIdx.y;
    const int w = blockIdx.z;
    const float* cw = consts + (size_t)w * S * CONST_W;
    for (int j = threadIdx.x; j < S * CONST_W; j += blockDim.x) sc[j] = cw[j];
    if (threadIdx.x < GEN_W) sg[threadIdx.x] = gen[(size_t)f * GEN_W + threadIdx.x];
    __syncthreads();

    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    // ---- prologue: launch by generalized aiming (_gen_prologue) ----------
    const float Px = px[i];
    const float Py = py[i];
    float x = add(mul(Px, sg[0]), sg[2]);
    float y = add(mul(Py, sg[1]), sg[3]);
    float z = sg[4];
    const float dxr = sub(mul(Px, sg[8]), x);
    const float dyr = sub(mul(Py, sg[9]), y);
    const float dzr = sub(sg[5], z);
    const float inv_mag = rsq(add(add(mul(dxr, dxr), mul(dyr, dyr)), mul(dzr, dzr)));
    float L = mul(dxr, inv_mag);
    float M = mul(dyr, inv_mag);
    float N = mul(dzr, inv_mag);
    float inten = 1.0f;
    float opd = 0.0f;
    bool valid = true;

    // ---- surface stack (_surface_step, conic path) -----------------------
    for (int k = 0; k < S; ++k) {
        const float* c = sc + k * CONST_W;
        const int fl = flags.f[k];
        const float ri = c[0], conic = c[1], pos_z = c[2];
        const float n1 = c[3], n2 = c[4], alpha = c[5];
        z = sub(z, pos_z);

        float t;
        if (fl & FLAG_PLANE) {
            t = dvd(-z, N);
        } else {
            const float t0 = dvd(-z, N);
            const float x0 = add(x, mul(t0, L));
            const float y0 = add(y, mul(t0, M));
            const float a = mul(add(mul(mul(conic, N), N), 1.0f), ri);
            const float bh = sub(mul(add(mul(L, x0), mul(M, y0)), ri), N);
            const float cc = mul(add(mul(x0, x0), mul(y0, y0)), ri);
            const float disc = sub(mul(bh, bh), mul(a, cc));
            const bool ok = disc >= 0.0f;
            const float sq = sqt(ok ? disc : 1.0f);
            // sign(0) := +1 for the root pairing (_sign_pm)
            const float q = -add(bh, bh >= 0.0f ? sq : -sq);
            const float t_far = dvd(q, eps_guard(a));
            const float t_near = dvd(cc, eps_guard(q));
            float tq = fabsf(t_near) <= fabsf(t_far) ? t_near : t_far;
            tq = ok ? tq : 0.0f;
            t = add(t0, tq);
            valid = valid && ok;
        }

        x = add(x, mul(t, L));
        y = add(y, mul(t, M));
        z = add(z, mul(t, N));
        opd = add(opd, fabsf(mul(t, n1)));
        if (fl & FLAG_ABSORB) inten = mul(inten, expf(mul(mul(-alpha, t), 1000.0f)));

        if (fl & FLAG_PLANE) {
            if (fl & FLAG_REFL) {
                N = -N;
            } else {
                const float u = dvd(n1, n2);
                const float disc_r = sub(1.0f, mul(mul(u, u), sub(1.0f, mul(N, N))));
                const bool ok_r = disc_r >= 0.0f;
                const float root_r = sqt(ok_r ? disc_r : 1.0f);
                valid = valid && ok_r;
                L = mul(u, L);
                M = mul(u, M);
                N = sign_times(N, root_r);
            }
        } else {
            const float r2 = add(mul(x, x), mul(y, y));
            const float arg = sub(1.0f, mul(mul(mul(add(1.0f, conic), ri), ri), r2));
            const float inv_root = rsq(arg > 1e-14f ? arg : 1.0f);
            const float dfdx = mul(mul(x, ri), inv_root);
            const float dfdy = mul(mul(y, ri), inv_root);
            const float inv_n = rsq(add(add(mul(dfdx, dfdx), mul(dfdy, dfdy)), 1.0f));
            const float nx = mul(dfdx, inv_n);
            const float ny = mul(dfdy, inv_n);
            const float nz = -inv_n;
            const float dot = add(add(mul(L, nx), mul(M, ny)), mul(N, nz));
            if (fl & FLAG_REFL) {
                const float two_dot = mul(2.0f, dot);
                L = sub(L, mul(two_dot, nx));
                M = sub(M, mul(two_dot, ny));
                N = sub(N, mul(two_dot, nz));
            } else {
                const float u = dvd(n1, n2);
                const float disc_r = sub(1.0f, mul(mul(u, u), sub(1.0f, mul(dot, dot))));
                const bool ok_r = disc_r >= 0.0f;
                const float root_r = sqt(ok_r ? disc_r : 1.0f);
                const float wgt = sub(sign_times(dot, root_r), mul(u, dot));
                L = add(mul(u, L), mul(nx, wgt));
                M = add(mul(u, M), mul(ny, wgt));
                N = add(mul(u, N), mul(nz, wgt));
                valid = valid && ok_r;
            }
        }
        z = add(z, pos_z);
    }

    // ---- epilogue: image propagation + NaN for lost rays (_gen_epilogue) -
    if (final_prop) {
        const float t_img = sg[6];
        x = add(x, mul(t_img, L));
        y = add(y, mul(t_img, M));
        z = add(z, mul(t_img, N));
    }
    if (!valid) {
        x = y = z = L = M = N = opd = __int_as_float(0x7fc00000);  // NaN
    }
    const size_t plane = (size_t)W * F * n;
    const size_t o = ((size_t)w * F + f) * n + i;
    out[o] = x;
    out[plane + o] = y;
    out[2 * plane + o] = z;
    out[3 * plane + o] = L;
    out[4 * plane + o] = M;
    out[5 * plane + o] = N;
    out[6 * plane + o] = inten;
    out[7 * plane + o] = opd;
}

// Launch on ``stream``; returns cudaGetLastError() (0 on success). flags is a
// host array of S words. Allocates nothing and does not synchronise.
extern "C" int gen_trace_launch(const float* gen, const float* consts,
                                const float* px, const float* py, float* out,
                                const int32_t* flags, int S, int F, int W,
                                long long n, int final_prop, void* stream) {
    if (S < 1 || S > MAX_SURF || F < 1 || W < 1 || F > 65535 || W > 65535 || n < 1)
        return (int)cudaErrorInvalidValue;
    SurfFlags fl;
    for (int k = 0; k < MAX_SURF; ++k) fl.f[k] = k < S ? flags[k] : 0;
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK), (unsigned)F, (unsigned)W);
    gen_trace_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        gen, consts, px, py, out, fl, S, F, W, n, final_prop);
    return (int)cudaGetLastError();
}
