// K1, sub-slices (a), (b), the even/odd aspheres of (c) and the OPD modes of
// (g): fused ray generation + surface stack + image propagation, one ray per
// thread.
//
// Replaces the TPU kernel optiland_pr_tpu/kernels/pallas_trace.py::
// _pallas_gen_trace_2d (body _gen_kernel -> _gen_pipeline = _gen_prologue,
// _surface_step per surface, _gen_epilogue, _nanify8) for conic, plane and
// even/odd aspheric surfaces that refract or reflect, with absorption in the
// pre-material, tilt/decenter, radial and offset-radial apertures and simple
// coatings, with the plain, Kahan-compensated or split OPD sum
// (gen_trace_common.cuh describes the modes). The device code of the three
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
// no warp diverges on it. The asphere terms are read from device memory
// (every thread of a block the same word: cached broadcasts). Two variants
// (gen_trace_common.cuh): the host launches the WIDE one only for a system
// with a tilt, an aperture, a coating or an asphere.
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
// them (measured on an H100: split +36% on the Cooke triplet, PERF.md).
#include "gen_trace_common.cuh"

#define BLOCK 256

template <bool WIDE, int MODE>
__global__ void __launch_bounds__(BLOCK)
gen_trace_kernel(const float* __restrict__ gen, const float* __restrict__ consts,
                 const float* __restrict__ acoef, const float* __restrict__ px,
                 const float* __restrict__ py, float* __restrict__ out,
                 const SurfFlags flags, int S, int F, int W, int C, long long n,
                 int final_prop) {
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
    gen_prologue<MODE>(sg, px[i], py[i], s);
    float sigma = 1.0f;
    for (int k = 0; k < S; ++k) {
        SurfTape tp;
        surface_step<WIDE, MODE>(sc + k * CONST_W, acoef + (size_t)k * C,
                                 flags.f[k], sigma, s, tp);
        if (flags.f[k] & FLAG_REFL) sigma = -sigma;
    }
    gen_epilogue(sg, final_prop, s);

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

template <bool WIDE, int MODE>
static void launch(dim3 grid, cudaStream_t st, const float* gen,
                   const float* consts, const float* acoef, const float* px,
                   const float* py, float* out, const SurfFlags& fl, int S,
                   int F, int W, int C, long long n, int final_prop) {
    gen_trace_kernel<WIDE, MODE><<<grid, BLOCK, 0, st>>>(
        gen, consts, acoef, px, py, out, fl, S, F, W, C, n, final_prop);
}

template <int MODE>
static void launch_mode(bool wide, dim3 grid, cudaStream_t st,
                        const float* gen, const float* consts,
                        const float* acoef, const float* px, const float* py,
                        float* out, const SurfFlags& fl, int S, int F, int W,
                        int C, long long n, int final_prop) {
    if (wide)
        launch<true, MODE>(grid, st, gen, consts, acoef, px, py, out, fl, S,
                           F, W, C, n, final_prop);
    else
        launch<false, MODE>(grid, st, gen, consts, acoef, px, py, out, fl, S,
                            F, W, C, n, final_prop);
}

// Launch on ``stream``; returns cudaGetLastError() (0 on success). flags is a
// host array of S words; acoef has C floats per surface; opd_mode is
// OPD_PLAIN, OPD_KAHAN or OPD_SPLIT (the last for untilted conic/plane
// stacks only). Allocates nothing and does not synchronise.
extern "C" int gen_trace_launch(const float* gen, const float* consts,
                                const float* acoef, const float* px,
                                const float* py, float* out,
                                const int32_t* flags, int S, int F, int W,
                                int C, long long n, int final_prop,
                                int opd_mode, void* stream) {
    if (S < 1 || S > MAX_SURF || F < 1 || W < 1 || F > 65535 || W > 65535 ||
        n < 1 || C < 0 || opd_mode < OPD_PLAIN || opd_mode > OPD_SPLIT)
        return (int)cudaErrorInvalidValue;
    SurfFlags fl;
    for (int k = 0; k < MAX_SURF; ++k) {
        fl.f[k] = k < S ? flags[k] : 0;
        if (nu_of(fl.f[k]) > (C < MAX_TERMS ? C : MAX_TERMS))
            return (int)cudaErrorInvalidValue;
    }
    if (opd_mode == OPD_SPLIT && !split_ok(fl.f, S))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK), (unsigned)F, (unsigned)W);
    const bool wide = needs_wide(fl.f, S);
    cudaStream_t st = (cudaStream_t)stream;
    if (opd_mode == OPD_SPLIT)
        launch_mode<OPD_SPLIT>(wide, grid, st, gen, consts, acoef, px, py, out,
                               fl, S, F, W, C, n, final_prop);
    else if (opd_mode == OPD_KAHAN)
        launch_mode<OPD_KAHAN>(wide, grid, st, gen, consts, acoef, px, py, out,
                               fl, S, F, W, C, n, final_prop);
    else
        launch_mode<OPD_PLAIN>(wide, grid, st, gen, consts, acoef, px, py, out,
                               fl, S, F, W, C, n, final_prop);
    return (int)cudaGetLastError();
}
