// K1, sub-slices (a), (b), (c), (d), (e) and the OPD modes of (g): fused ray
// generation + surface stack + image propagation, one ray per thread.
//
// Replaces the TPU kernel optiland_pr_tpu/kernels/pallas_trace.py::
// _pallas_gen_trace_2d (body _gen_kernel -> _gen_pipeline = _gen_prologue,
// _surface_step per surface, _gen_epilogue, _nanify8) for conic, plane,
// even/odd aspheric, XY-polynomial, Chebyshev, biconic, toroidal, Zernike,
// Forbes Qbfs and Q2D and thin Fresnel surfaces that refract or reflect,
// with absorption in the pre-material, tilt/decenter, radial and
// offset-radial apertures and simple coatings, launched at the entrance
// pupil or object-space telecentric, with or without a closed-form
// apodization, with the plain, Kahan-compensated or split OPD sum
// (gen_trace_common.cuh describes the sags, the launch and the modes). The device code of the three
// stages is gen_trace_common.cuh, which the backward kernel (gen_grad.cu)
// shares.
//
// Layout (shared with the plain version, kernels/gen_trace.py): the tables of
// gen_trace_common.cuh (acoef [S, C] with row stride C), plus
//   Px, Py [n]         normalized pupil samples, shared by every (w, f)
//   out    [8, W, F, n] x, y, z, L, M, N, intensity, opd
//
// Design: grid (ceil(n/256), F, W); the block stages its wavelength's [S, 32]
// constant rows and its field's gen row in shared memory (every thread reads
// the same word: a broadcast), keeps the ray state in registers through the
// whole stack, masks the ragged tail, and writes the 8 outputs once. The
// surface loop branches on a flag word that is uniform across the grid, so
// no warp diverges on it. The sag coefficients and the Zernike table are
// read from device memory (every thread of a block the same word: cached
// broadcasts). Three variants (gen_trace_common.cuh): the host launches the
// WIDE one for a system with a tilt, an aperture, a coating or an even/odd
// asphere, the FREEFORM one for a system with another sag of (c).
//
// Bounds on an H100: the kernel reads the 8 B of each pupil sample and
// writes 32 B per ray; at 36M rays (3 fields x 3 wavelengths x 4M) that is
// ~1.18 GB, 0.35 ms at 3.35 TB/s. Per conic surface it does about 60 FP32
// operations plus ~6 IEEE divisions and ~4 IEEE square roots, each a
// multi-instruction sequence with a quarter-rate MUFU step. Measured on an
// H100 (700 W): 1.92 ms for that case, 600 GB/s of output, so the kernel is
// bound by instruction issue, not by memory bandwidth (PERF.md). An asphere
// adds 10 evaluations of its sag (8 Newton steps, the live step, the normal),
// each ~20 operations and a division plus 6 per term: the aspheric cases are
// bound by operations too. The OPD modes are templates too: the Kahan sum
// adds 3 operations per surface, the split mode 29 per conic surface (the
// deviation with two divisions, the compensated sum and the sag refresh
// with a division and a square root) and 15 per plane, and one register
// for the compensation; the plain mode compiles the code that ran before
// them (measured on an H100: split +36% on the Cooke triplet, PERF.md). The
// freeform sags are bound by operations too: each Newton evaluation of a
// 4 x 4 Chebyshev grid is ~17 operations of the conic base and ~130 of the
// grid and its recurrences, 10 evaluations a surface. A polarized launch
// (e) adds per surface and vector ~30 operations (the s/p update; the basis
// ~40 more per surface) and its E-vectors' 3 n_ev registers.
//
// Sub-slice (e), a polarized launch, is the template flag POL: the E-vectors
// (gen_trace_common.cuh) live in registers beside the ray state, and the
// launch state (n_ev, the scale, each vector's amplitudes) is a kernel
// argument. Its instances are a library of their own, gen_trace_pol.cu
// (this file with TRACE_POL 1), built in parallel with this one, so that
// the unpolarized instances compile as they did before it. One template
// flag, not n_ev: a linear state's second vector is skipped by a branch
// uniform over the launch, which halves the instances to build; measured on
// an H100, a compile-time n_ev = 1 is 2-4% faster on the linear launches
// (probes/nev_template.py, PERF.md).
#define WITH_DOE 1
#include "gen_trace_common.cuh"

#ifndef TRACE_POL
#define TRACE_POL 0
#endif

#define BLOCK 256

template <int VAR, int MODE, bool POL>
__global__ void __launch_bounds__(BLOCK)
gen_trace_kernel(const float* __restrict__ gen, const float* __restrict__ consts,
                 const float* __restrict__ acoef, const float* __restrict__ ztab,
                 const float* __restrict__ px,
                 const float* __restrict__ py, float* __restrict__ out,
                 const SurfFlags flags, int S, int F, int W, int C, long long n,
                 int final_prop, const PolLaunch pl) {
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

    RayState s;
    PolState ps;
    gen_prologue<MODE>(sg, px[i], py[i], s);
    if constexpr (POL) polar_init(sg, s.L, s.M, s.N, s.inten, pl, ps);
    float sigma = 1.0f;
    for (int k = 0; k < S; ++k) {
        SurfTape tp;
        surface_step<VAR, MODE, POL>(sc + k * CONST_W, acoef + (size_t)k * C,
                                     ztab, flags.f[k], sigma, s, tp, &ps);
        if (flags.f[k] & FLAG_REFL) sigma = -sigma;
    }
    gen_epilogue(sg, final_prop, s);
    // a polarized launch's intensity is the chain's (_gen_epilogue
    // :2128-2134)
    if constexpr (POL) s.inten = polar_intensity(ps, pl.scale);

    // NaN for lost rays (_nanify8); intensity is never masked
    if (!s.valid) {
        s.x = s.y = s.z = s.L = s.M = s.N = s.opd = __int_as_float(0x7fc00000);
    }
    const size_t plane = (size_t)W * F * n;
    const size_t o = ((size_t)w * F + f) * n + i;
    out[o] = s.x;
    out[plane + o] = s.y;
    out[2 * plane + o] = s.z;
    out[3 * plane + o] = s.L;
    out[4 * plane + o] = s.M;
    out[5 * plane + o] = s.N;
    out[6 * plane + o] = s.inten;
    out[7 * plane + o] = s.opd;
}

template <int VAR, int MODE>
static void launch(dim3 grid, cudaStream_t st, const float* gen,
                   const float* consts, const float* acoef, const float* ztab,
                   const float* px, const float* py, float* out,
                   const SurfFlags& fl, int S, int F, int W, int C, long long n,
                   int final_prop, const PolLaunch& pl) {
    gen_trace_kernel<VAR, MODE, (bool)TRACE_POL><<<grid, BLOCK, 0, st>>>(
        gen, consts, acoef, ztab, px, py, out, fl, S, F, W, C, n, final_prop,
        pl);
}

// the split mode takes no freeform sag (split_ok), so its FREEFORM variant
// is not built
template <int MODE>
static void launch_mode(int var, dim3 grid, cudaStream_t st,
                        const float* gen, const float* consts,
                        const float* acoef, const float* ztab, const float* px,
                        const float* py, float* out, const SurfFlags& fl,
                        int S, int F, int W, int C, long long n,
                        int final_prop, const PolLaunch& pl) {
    if constexpr (MODE != OPD_SPLIT) {
        if (var == VAR_FORBES) {
            launch<VAR_FORBES, MODE>(grid, st, gen, consts, acoef, ztab, px,
                                     py, out, fl, S, F, W, C, n, final_prop, pl);
            return;
        }
        if (var == VAR_FREEFORM) {
            launch<VAR_FREEFORM, MODE>(grid, st, gen, consts, acoef, ztab, px,
                                       py, out, fl, S, F, W, C, n, final_prop, pl);
            return;
        }
    }
    if (var == VAR_WIDE)
        launch<VAR_WIDE, MODE>(grid, st, gen, consts, acoef, ztab, px, py, out,
                               fl, S, F, W, C, n, final_prop, pl);
    else
        launch<VAR_NARROW, MODE>(grid, st, gen, consts, acoef, ztab, px, py,
                                 out, fl, S, F, W, C, n, final_prop, pl);
}

// Launch on ``stream``; returns cudaGetLastError() (0 on success). flags is a
// host array of S words; acoef has C floats per surface; ztab is the device
// Zernike table; opd_mode is OPD_PLAIN, OPD_KAHAN or OPD_SPLIT (the last for
// untilted conic/plane stacks only); polar is a host array [n_ev, scale,
// a0, b0, a1, b1] of a polarized launch, which only the polarized library
// (TRACE_POL 1) takes, or null, which only the other takes. On success
// *variant, when not null, is the variant launched (VAR_NARROW, VAR_WIDE,
// VAR_FREEFORM or VAR_FORBES). Allocates nothing and does not synchronise.
extern "C" int gen_trace_launch(const float* gen, const float* consts,
                                const float* acoef, const float* ztab,
                                const float* px,
                                const float* py, float* out,
                                const int32_t* flags, int S, int F, int W,
                                int C, long long n, int final_prop,
                                int opd_mode, const float* polar, void* stream,
                                int* variant) {
    if (S < 1 || S > MAX_SURF || F < 1 || W < 1 || F > 65535 || W > 65535 ||
        n < 1 || C < 0 || opd_mode < OPD_PLAIN || opd_mode > OPD_SPLIT ||
        (polar != nullptr) != (bool)TRACE_POL)
        return (int)cudaErrorInvalidValue;
    PolLaunch pl;
    if (!polar_launch_of(polar, pl)) return (int)cudaErrorInvalidValue;
    SurfFlags fl;
    for (int k = 0; k < MAX_SURF; ++k) {
        fl.f[k] = k < S ? flags[k] : 0;
        if (ncoef_of(fl.f[k]) > (C < MAX_TERMS ? C : MAX_TERMS) ||
            acoef_width_of(fl.f[k]) > C)
            return (int)cudaErrorInvalidValue;
    }
    if (!kinds_ok(fl.f, S) || (opd_mode == OPD_SPLIT && !split_ok(fl.f, S)))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK), (unsigned)F, (unsigned)W);
    const int var = variant_of(fl.f, S);
    cudaStream_t st = (cudaStream_t)stream;
    if (opd_mode == OPD_SPLIT)
        launch_mode<OPD_SPLIT>(var, grid, st, gen, consts, acoef, ztab, px, py,
                               out, fl, S, F, W, C, n, final_prop, pl);
    else if (opd_mode == OPD_KAHAN)
        launch_mode<OPD_KAHAN>(var, grid, st, gen, consts, acoef, ztab, px, py,
                               out, fl, S, F, W, C, n, final_prop, pl);
    else
        launch_mode<OPD_PLAIN>(var, grid, st, gen, consts, acoef, ztab, px, py,
                               out, fl, S, F, W, C, n, final_prop, pl);
    const int err = (int)cudaGetLastError();
    if (err == 0 && variant != nullptr) *variant = var;
    return err;
}
