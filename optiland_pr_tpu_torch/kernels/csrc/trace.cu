// K3: the surface stack on given rays, one ray per thread: no ray generation
// and no image propagation (the rays end on the image surface), lost rays
// NaN at the end.
//
// Replaces the TPU kernel optiland_pr_tpu/kernels/pallas_trace.py::
// _pallas_call_2d (body _kernel: _surface_step per surface with validity
// starting true, then _nanify8), entered through pallas_trace_conic, for the
// surfaces K1 covers (sub-slices (a), (b), (c)) in the plain OPD mode. The surface step is K1's (gen_trace_common.cuh::
// surface_step), so K3 rounds every operation as K1 and its plain version do.
//
// Layout (shared with the plain version, kernels/trace_conic.py):
//   consts [S, 32]  one wavelength's constant rows (gen_trace_common.cuh)
//   acoef  [S, C]   sag coefficients
//   ztab            the Zernike table
//   rays   [8, n]   x, y, z, L, M, N, intensity, opd in; the same out
//
// Design: K1's, without the generation: grid ceil(n/256) blocks, the [S, 32]
// rows staged in shared memory, the ray state in registers through the whole
// stack, the ragged tail masked, the 8 outputs written once. The host picks
// the variant (narrow, WIDE, FREEFORM, FORBES) from the flag words as for
// K1.
//
// Bounds on an H100: 64 B moved per ray (8 floats in, 8 out), ~500 FP32
// operations per ray on the Cooke triplet's 7 surfaces (chip_smoke.py's
// k1_ops without the prologue and the image propagation): at 4M rays 0.080
// ms by bytes, 0.031 ms by operations; instruction issue bounds it as it does
// K1.
#include "gen_trace_common.cuh"

#define BLOCK 256

template <int VAR>
__global__ void __launch_bounds__(BLOCK)
trace_kernel(const float* __restrict__ consts, const float* __restrict__ acoef,
             const float* __restrict__ ztab, const float* __restrict__ in,
             float* __restrict__ out, const SurfFlags flags, int S, int C,
             long long n) {
    __shared__ float sc[MAX_SURF * CONST_W];
    for (int j = threadIdx.x; j < S * CONST_W; j += blockDim.x) sc[j] = consts[j];
    __syncthreads();

    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    RayState s;
    s.x = in[i];
    s.y = in[n + i];
    s.z = in[2 * n + i];
    s.L = in[3 * n + i];
    s.M = in[4 * n + i];
    s.N = in[5 * n + i];
    s.inten = in[6 * n + i];
    s.opd = in[7 * n + i];
    s.opd_c = 0.0f;
    s.valid = true;
    for (int k = 0; k < S; ++k) {
        SurfTape tp;
        surface_step<VAR, OPD_PLAIN>(sc + k * CONST_W, acoef + (size_t)k * C,
                                     ztab, flags.f[k], 1.0f, s, tp);
    }
    // NaN for lost rays (_nanify8); intensity is never masked
    if (!s.valid) {
        s.x = s.y = s.z = s.L = s.M = s.N = s.opd = __int_as_float(0x7fc00000);
    }
    out[i] = s.x;
    out[n + i] = s.y;
    out[2 * n + i] = s.z;
    out[3 * n + i] = s.L;
    out[4 * n + i] = s.M;
    out[5 * n + i] = s.N;
    out[6 * n + i] = s.inten;
    out[7 * n + i] = s.opd;
}

// Launch on ``stream``; returns cudaGetLastError() (0 on success). flags is a
// host array of S words; acoef has C floats per surface; ztab is the device
// Zernike table; rays and out are [8, n]. On success *variant, when not
// null, is the variant launched (VAR_NARROW, VAR_WIDE, VAR_FREEFORM or
// VAR_FORBES). Allocates nothing and does not synchronise.
extern "C" int trace_launch(const float* consts, const float* acoef,
                            const float* ztab, const float* rays, float* out,
                            const int32_t* flags, int S, int C, long long n,
                            void* stream, int* variant) {
    if (S < 1 || S > MAX_SURF || n < 1 || C < 0 ||
        (n + BLOCK - 1) / BLOCK > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    SurfFlags fl;
    for (int k = 0; k < MAX_SURF; ++k) {
        fl.f[k] = k < S ? flags[k] : 0;
        if (ncoef_of(fl.f[k]) > (C < MAX_TERMS ? C : MAX_TERMS) ||
            acoef_width_of(fl.f[k]) > C)
            return (int)cudaErrorInvalidValue;
    }
    if (!kinds_ok(fl.f, S)) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((n + BLOCK - 1) / BLOCK);
    const int var = variant_of(fl.f, S);
    cudaStream_t st = (cudaStream_t)stream;
    if (var == VAR_FORBES)
        trace_kernel<VAR_FORBES><<<grid, BLOCK, 0, st>>>(consts, acoef, ztab,
                                                         rays, out, fl, S, C, n);
    else if (var == VAR_FREEFORM)
        trace_kernel<VAR_FREEFORM><<<grid, BLOCK, 0, st>>>(consts, acoef, ztab,
                                                           rays, out, fl, S, C, n);
    else if (var == VAR_WIDE)
        trace_kernel<VAR_WIDE><<<grid, BLOCK, 0, st>>>(consts, acoef, ztab,
                                                       rays, out, fl, S, C, n);
    else
        trace_kernel<VAR_NARROW><<<grid, BLOCK, 0, st>>>(consts, acoef, ztab,
                                                         rays, out, fl, S, C, n);
    const int err = (int)cudaGetLastError();
    if (err == 0 && variant != nullptr) *variant = var;
    return err;
}
