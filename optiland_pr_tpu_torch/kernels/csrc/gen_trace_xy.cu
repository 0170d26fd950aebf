// K1, sub-slice (h): the coord_split mode, fused ray generation + surface
// stack + image propagation with the ray state in float64, one ray per
// thread.
//
// Replaces the split == "xy" branch of the TPU kernel
// optiland_pr_tpu/kernels/pallas_trace.py::_pallas_gen_trace_2d (body
// _gen_kernel -> _gen_pipeline with _gen_prologue, _surface_step_xy per
// surface, _gen_epilogue; entry pallas_gen_trace_conic(coord_split=True)),
// whose tiles each carried a scalar chief ray beside their rays in two-float
// arithmetic (gen_trace_xy.cuh says why float64 here). The device code is
// gen_trace_xy.cuh, which the backward kernel (gen_grad_xy.cu) shares.
//
// Layout (shared with the plain version, kernels/gen_trace.py): gen [F, 16]
// and consts [W, S, 32] as in gen_trace_common.cuh (column 27 the vertex
// gaps, column 28 the curvatures' low words), Px, Py [n], and
//   out   [8, W, F, n]  x, y, z (local to the image vertex), L, M, N,
//                       intensity, opd (the deviation from the chief's)
//   chief [W, F]        float64, the chief ray's OPD (scratch)
//   base  [W, F]        float32, the same rounded once
//
// Design: the chief ray (the pupil-centre ray of each wavelength and field)
// is traced once per (w, f) by xy_chief_kernel, not by every thread beside
// its own ray, which would double each thread's work; the ray kernel reads
// its (w, f)'s float64 OPD once per block. The chief runs the same
// xy_launch/xy_step on Px = Py = 0, so its OPD is bit for bit that of any
// exact pupil-centre ray of the main launch. The ray kernel: grid
// (ceil(n/256), F, W), the block's constant rows and gen row in shared
// memory (broadcast reads), the state in registers through the stack, the
// 8 outputs rounded to float32 once and written once. Absorption, the
// aperture and the coating are branches on a flag word uniform over the
// grid: the mode has no variants.
//
// Bounds on an H100: the kernel reads 8 B of pupil samples and writes 32 B
// per ray, as the float32 K1 does; its arithmetic is float64, at 34 TFLOP/s
// against float32's 67 (NVIDIA's H100 SXM data sheet): per conic mirror
// about 70 float64 operations (the curvature's sum and the shift 2, the
// intersection 26 with three divisions and a square root, the propagation
// and OPD 8, the normal 26 with two of each, the reflection 7), each IEEE
// division and square root a multi-instruction sequence. chip_smoke.py
// counts them (xy_ops) and PERF.md holds the times.
#include "gen_trace_xy.cuh"

#define BLOCK 256
#define CHIEF_BLOCK 64

__global__ void __launch_bounds__(CHIEF_BLOCK)
xy_chief_kernel(const float* __restrict__ gen, const float* __restrict__ consts,
                const SurfFlags flags, int S, int F, int W,
                double* __restrict__ chief, float* __restrict__ base) {
    const int j = blockIdx.x * CHIEF_BLOCK + threadIdx.x;
    if (j >= W * F) return;
    const float* g = gen + (size_t)(j % F) * GEN_W;
    const float* cw = consts + (size_t)(j / F) * S * CONST_W;
    XyRay s;
    XyLaunch lt;
    xy_launch(g, 0.0f, 0.0f, s, lt);
    for (int k = 0; k < S; ++k) {
        XyTape tp;
        xy_step(cw + k * CONST_W, flags.f[k], s, tp);
    }
    chief[j] = s.opd;
    base[j] = (float)s.opd;
}

__global__ void __launch_bounds__(BLOCK)
gen_trace_xy_kernel(const float* __restrict__ gen,
                    const float* __restrict__ consts,
                    const float* __restrict__ px, const float* __restrict__ py,
                    const double* __restrict__ chief, float* __restrict__ out,
                    const SurfFlags flags, int S, int F, int W, long long n,
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

    XyRay s;
    XyLaunch lt;
    xy_launch(sg, px[i], py[i], s, lt);
    for (int k = 0; k < S; ++k) {
        XyTape tp;
        xy_step(sc + k * CONST_W, flags.f[k], s, tp);
    }
    xy_epilogue(sg, final_prop, s);

    // one rounding per output; NaN for lost rays (_nanify8), the intensity
    // never masked
    const float nan = __int_as_float(0x7fc00000);
    const float opd = (float)sub64(s.opd, chief[(size_t)w * F + f]);
    const size_t plane = (size_t)W * F * n;
    const size_t o = ((size_t)w * F + f) * n + i;
    out[o] = s.valid ? (float)s.x : nan;
    out[plane + o] = s.valid ? (float)s.y : nan;
    out[2 * plane + o] = s.valid ? (float)s.z : nan;
    out[3 * plane + o] = s.valid ? (float)s.L : nan;
    out[4 * plane + o] = s.valid ? (float)s.M : nan;
    out[5 * plane + o] = s.valid ? (float)s.N : nan;
    out[6 * plane + o] = s.inten;
    out[7 * plane + o] = s.valid ? opd : nan;
}

// Launch the chief kernel and then the ray kernel on ``stream``; returns
// cudaGetLastError() after each (0 on success). flags is a host array of S
// words that xy_ok accepts; chief is float64 scratch of W * F; base
// receives the chief's OPD rounded to float32. Allocates nothing and does
// not synchronise.
extern "C" int gen_trace_xy_launch(const float* gen, const float* consts,
                                   const float* px, const float* py,
                                   float* out, float* base, double* chief,
                                   const int32_t* flags, int S, int F, int W,
                                   long long n, int final_prop, void* stream) {
    if (S < 1 || S > MAX_SURF || F < 1 || W < 1 || F > 65535 || W > 65535 ||
        n < 1 || !xy_ok(flags, S))
        return (int)cudaErrorInvalidValue;
    SurfFlags fl;
    for (int k = 0; k < MAX_SURF; ++k) fl.f[k] = k < S ? flags[k] : 0;
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned nchief = (unsigned)((W * F + CHIEF_BLOCK - 1) / CHIEF_BLOCK);
    xy_chief_kernel<<<nchief, CHIEF_BLOCK, 0, st>>>(gen, consts, fl, S, F, W,
                                                    chief, base);
    int err = (int)cudaGetLastError();
    if (err) return err;
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK), (unsigned)F, (unsigned)W);
    gen_trace_xy_kernel<<<grid, BLOCK, 0, st>>>(gen, consts, px, py, chief, out,
                                                fl, S, F, W, n, final_prop);
    return (int)cudaGetLastError();
}
