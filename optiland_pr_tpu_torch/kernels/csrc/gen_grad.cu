// K2, sub-slice (a): the vector-Jacobian product of K1 (gen_trace.cu) by
// per-ray recompute and a per-surface reverse sweep, one ray per thread.
//
// Replaces the TPU kernel optiland_pr_tpu/kernels/pallas_grad.py::
// _pallas_gen_bwd_2d (body _gen_bwd_kernel -> _manual_vjp) for conic and
// plane surfaces that refract or reflect, with absorption in the
// pre-material. The TPU kernel ran jax.vjp inside the kernel; here the
// adjoint of every branch is written out by hand, and it follows the
// derivative conventions of PyTorch autograd on the plain version
// (kernels/gen_grad.py::gen_trace_bwd_plain), which it is held against:
//   - where(c, a, b) sends the cotangent to the taken branch only; the
//     guarded square roots (sqrt(ok ? d : 1)) get none on the guarded side;
//   - eps_guard passes the cotangent on |v| > eps and none on its clamp;
//   - sign() has zero derivative; |v| has derivative sign(v), 0 at 0;
//   - 1/sqrt(s) is differentiated as reciprocal(sqrt(s)).
//
// Inputs: the forward's tables and pupil samples (gen_trace_common.cuh,
// gen_trace.cu) and the cotangents of its 8 outputs, cot [8, W, F, n].
// Outputs:
//   dgen    [F, 16]    columns 0-6, 8, 9 (the rest are 0), summed over W
//   dconsts [W, S, 32] columns 0-5 (the rest are 0)
//   dacoef  [S, C]     0: sub-slice (a) reads no geometry coefficients
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
//      arithmetic (PERF.md).
//      The cotangents of x, y, z, L, M, N, opd are zeroed for lost rays (the
//      transpose of _nanify8: a NaN cotangent from an unmasked consumer
//      becomes 0); the intensity cotangent is not masked. The reverse sweep
//      runs the epilogue's adjoint, then each surface's (recomputing that
//      surface's intermediates from its boundary state), then the
//      prologue's.
//      Each surface's 6 constant cotangents (and the 9 of gen at the end)
//      are summed over the block as soon as they are made: a warp shuffle
//      tree, then the 8 warp sums in order from shared memory, into one
//      partial per block, part[q][w][f][block], q = 6*k + column for
//      surface k, 6*S + j for gen.
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
//
// Bounds on an H100: per ray it reads 8 B of pupil and 32 B of cotangents
// and writes 8 B of pupil cotangents per (w, f) plane; the arithmetic is
// K1's forward twice (the sweep recomputes each surface) plus the adjoint,
// ~3.4x K1's operations. Measured on an H100 (700 W): 1.03 ms for the
// Cooke triplet at 4M rays, ~5x K1's time per ray and ~9x the operation
// bound, so it is bound by instruction issue, as K1 is (PERF.md).
#include "gen_trace_common.cuh"

#define GBLOCK 256
#define NWARP (GBLOCK / 32)
#define NGEN 9        // gen columns with a cotangent: 0-6, 8, 9
#define RBLOCK 256    // threads of the reduction kernels

struct Adj {
    float x, y, z, L, M, N, inten, opd;
};

__device__ __forceinline__ float sgn(float v) {
    return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// Adjoint of surface_step. ``in`` is the surface's input state, (x2, y2) its
// output position, ``tp`` its recomputed intermediates. ``a`` holds the
// cotangent of the output state on entry and of the input state on return;
// dc receives the cotangents of consts columns 0-5.
__device__ __forceinline__ void surface_adjoint(const float* c, int fl,
                                                const RayState& in, float x2,
                                                float y2, const SurfTape& tp,
                                                Adj& a, float dc[6]) {
    const float ri = c[0], conic = c[1];
    const float n1 = c[3], n2 = c[4], alpha = c[5];
    const float L = in.L, M = in.M, N = in.N;
    const float t = tp.t;
    float dri = 0.0f, dconic = 0.0f, dpz = 0.0f, dn1 = 0.0f, dn2 = 0.0f,
          dalpha = 0.0f;

    // z_out = z2 + pos_z
    dpz += a.z;
    float ax2 = a.x, ay2 = a.y;
    const float az2 = a.z;
    float aL = 0.0f, aM = 0.0f, aN = 0.0f;    // cotangents of L, M, N in

    // ---- refract or reflect ------------------------------------------------
    if (fl & FLAG_PLANE) {
        if (fl & FLAG_REFL) {                  // N_out = -N
            aL = a.L;
            aM = a.M;
            aN = -a.N;
        } else {                               // plane Snell
            const float u = tp.u;
            float du = a.L * L + a.M * M;
            aL = a.L * u;
            aM = a.M * u;
            const float droot = a.N * sgn(N);  // N_out = sign(N) * root_r
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
            aL = a.L;
            aM = a.M;
            aN = a.N;
            const float dtwo = -(a.L * tp.nx + a.M * tp.ny + a.N * tp.nz);
            dnx = -a.L * two_dot;
            dny = -a.M * two_dot;
            dnz = -a.N * two_dot;
            ddot = 2.0f * dtwo;
        } else {                               // u d + w n
            const float u = tp.u, w = tp.w, dot = tp.dot;
            aL = a.L * u;
            aM = a.M * u;
            aN = a.N * u;
            float du = a.L * L + a.M * M + a.N * N;
            dnx = a.L * w;
            dny = a.M * w;
            dnz = a.N * w;
            const float dw = a.L * tp.nx + a.M * tp.ny + a.N * tp.nz;
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

    // ---- absorption: inten_out = inten * exp(((-alpha) * t) * 1000) ------
    float dt = 0.0f;
    if (fl & FLAG_ABSORB) {
        const float de = a.inten * in.inten;
        a.inten = a.inten * tp.e;
        const float dat = de * tp.e * 1000.0f;
        dalpha -= dat * t;
        dt -= dat * alpha;
    }
    // ---- opd_out = opd + |t * n1| ------------------------------------------
    const float dtn1 = a.opd * sgn(t * n1);
    dt += dtn1 * n1;
    dn1 += dtn1 * t;
    // ---- propagation: (x2, y2, z2) = (x, y, z1) + t (L, M, N) --------------
    dt += ax2 * L + ay2 * M + az2 * N;
    aL += ax2 * t;
    aM += ay2 * t;
    aN += az2 * t;
    float ax = ax2, ay = ay2, az1 = az2;

    // ---- intersection ----------------------------------------------------------
    if (fl & FLAG_PLANE) {                     // t = (-z1) / N
        az1 -= dt / N;
        aN -= dt * t / N;
    } else {
        float dt0 = dt;
        const float dtq = tp.ok ? dt : 0.0f;
        const float dtn = tp.near ? dtq : 0.0f;
        const float dtf = tp.near ? 0.0f : dtq;
        // t_near = cc / eps_guard(q), t_far = q / eps_guard(a)
        float dcc = dtn / tp.qg;
        const float dqg = -dtn * tp.t_near / tp.qg;
        float dq = fabsf(tp.q) > EPS_GUARD ? dqg : 0.0f;
        dq += dtf / tp.ag;
        const float dag = -dtf * tp.t_far / tp.ag;
        float da = fabsf(tp.a) > EPS_GUARD ? dag : 0.0f;
        // q = -(bh + (bh >= 0 ? sq : -sq))
        float dbh = -dq;
        const float dsq = tp.bh >= 0.0f ? -dq : dq;
        // sq = sqrt(ok ? disc : 1), disc = bh^2 - a cc
        const float ddisc = tp.ok ? dsq / (2.0f * tp.sq) : 0.0f;
        dbh += 2.0f * tp.bh * ddisc;
        da -= ddisc * tp.cc;
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
        const float dinn = da * ri;
        dri += da * (conic * N * N + 1.0f);
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
    // z1 = z - pos_z
    dpz -= az1;

    a.x = ax;
    a.y = ay;
    a.z = az1;
    a.L = aL;
    a.M = aM;
    a.N = aN;
    dc[0] = dri;
    dc[1] = dconic;
    dc[2] = dpz;
    dc[3] = dn1;
    dc[4] = dn2;
    dc[5] = dalpha;
}

template <int MAXS>
__global__ void __launch_bounds__(GBLOCK)
gen_grad_kernel(const float* __restrict__ gen, const float* __restrict__ consts,
                const float* __restrict__ px, const float* __restrict__ py,
                const float* __restrict__ cot, float* __restrict__ part,
                float* __restrict__ dpx_wf, float* __restrict__ dpy_wf,
                const SurfFlags flags, int S, int F, int W, long long n,
                int nblk, int final_prop) {
    __shared__ float sc[MAXS * CONST_W];
    __shared__ float sg[GEN_W];
    __shared__ float sw[NWARP][6 * MAXS + NGEN];
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
    gen_prologue(sg, Px, Py, s);
    for (int k = 0; k < S; ++k) {
        st[k][0] = s.x;
        st[k][1] = s.y;
        st[k][2] = s.z;
        st[k][3] = s.L;
        st[k][4] = s.M;
        st[k][5] = s.N;
        st[k][6] = s.inten;
        SurfTape tp;
        surface_step(sc + k * CONST_W, flags.f[k], s, tp);
    }

    // ---- cotangents; the NaN step's transpose zeroes lost rays' ------------
    const size_t plane = (size_t)W * F * n;
    const size_t o = ((size_t)w * F + f) * n + (active ? i : 0);
    Adj a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
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
        const int fl = flags.f[k];
        RayState in;
        in.x = st[k][0];
        in.y = st[k][1];
        in.z = st[k][2];
        in.L = st[k][3];
        in.M = st[k][4];
        in.N = st[k][5];
        in.inten = st[k][6];
        in.opd = 0.0f;
        in.valid = true;
        RayState out = in;
        SurfTape tp;
        surface_step(c, fl, out, tp);
        float dc[6];
        surface_adjoint(c, fl, in, out.x, out.y, tp, a, dc);
#pragma unroll
        for (int j = 0; j < 6; ++j) {
            const float v = warp_sum(active ? dc[j] : 0.0f);
            if (lane == 0) sw[warp][6 * k + j] = v;
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
    const float az = a.z - ddzr;
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
#pragma unroll
    for (int j = 0; j < NGEN; ++j) {
        const float v = warp_sum(active ? dgv[j] : 0.0f);
        if (lane == 0) sw[warp][6 * S + j] = v;
    }
    __syncthreads();

    // ---- one partial per block and quantity, warps summed in order ----------
    const size_t nb = (size_t)W * F * nblk;
    const size_t b = ((size_t)w * F + f) * nblk + blockIdx.x;
    for (int q = threadIdx.x; q < 6 * S + NGEN; q += GBLOCK) {
        float v = 0.0f;
        for (int j = 0; j < NWARP; ++j) v += sw[j][q];
        part[(size_t)q * nb + b] = v;
    }
}

// gen columns 0-15 -> partial index (-1: no cotangent)
__device__ __forceinline__ int gen_slot(int col) {
    return col <= 6 ? col : (col == 8 ? 7 : (col == 9 ? 8 : -1));
}

// One block per element of dconsts [W, S, 32], dgen [F, 16], dacoef [S, C],
// in that order. The element's partials are nseg segments of seglen
// contiguous floats, seg_stride apart.
__global__ void __launch_bounds__(RBLOCK)
gen_grad_reduce(const float* __restrict__ part, float* __restrict__ dgen,
                float* __restrict__ dconsts, float* __restrict__ dacoef, int S,
                int F, int W, int nblk, int C) {
    __shared__ double red[RBLOCK];
    const long long e = blockIdx.x;
    const long long n_dc = (long long)W * S * CONST_W;
    const long long n_dg = (long long)F * GEN_W;
    const size_t nb = (size_t)W * F * nblk;
    float* dst;
    long long q = -1;
    size_t base = 0, seg_stride = 0;
    long long nseg = 0, seglen = 0;
    if (e < n_dc) {
        dst = dconsts + e;
        const int w = (int)(e / ((long long)S * CONST_W));
        const int k = (int)((e / CONST_W) % S);
        const int j = (int)(e % CONST_W);
        if (j < 6) {                           // sum over f and blocks
            q = 6 * k + j;
            base = (size_t)q * nb + (size_t)w * F * nblk;
            nseg = 1;
            seglen = (long long)F * nblk;
        }
    } else if (e < n_dc + n_dg) {
        dst = dgen + (e - n_dc);
        const int f = (int)((e - n_dc) / GEN_W);
        const int slot = gen_slot((int)((e - n_dc) % GEN_W));
        if (slot >= 0) {                       // sum over w and blocks
            q = 6 * S + slot;
            base = (size_t)q * nb + (size_t)f * nblk;
            seg_stride = (size_t)F * nblk;
            nseg = W;
            seglen = nblk;
        }
    } else {
        dst = dacoef + (e - n_dc - n_dg);
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

// Floats of the partials buffer gen_grad_launch needs.
extern "C" long long gen_grad_partials_size(int S, int F, int W, long long n) {
    return (long long)(6 * S + NGEN) * W * F * n_blocks(n);
}

template <int MAXS>
static void launch_bucket(dim3 grid, cudaStream_t stream, const float* gen,
                          const float* consts, const float* px, const float* py,
                          const float* cot, float* part, float* dpx_wf,
                          float* dpy_wf, const SurfFlags& fl, int S, int F,
                          int W, long long n, int nblk, int final_prop) {
    gen_grad_kernel<MAXS><<<grid, GBLOCK, 0, stream>>>(
        gen, consts, px, py, cot, part, dpx_wf, dpy_wf, fl, S, F, W, n, nblk,
        final_prop);
}

// Launch the three kernels on ``stream``; returns cudaGetLastError() after
// each launch (0 on success). flags is a host array of S words; part holds
// gen_grad_partials_size floats; dpx_wf/dpy_wf hold W*F*n floats each, or
// are null (then dpx/dpy are not written). Allocates nothing and does not
// synchronise.
extern "C" int gen_grad_launch(const float* gen, const float* consts,
                               const float* px, const float* py,
                               const float* cot, float* part, float* dpx_wf,
                               float* dpy_wf, float* dgen, float* dconsts,
                               float* dacoef, float* dpx, float* dpy,
                               const int32_t* flags, int S, int F, int W,
                               long long n, int C, int final_prop,
                               void* stream) {
    if (S < 1 || S > MAX_SURF || F < 1 || W < 1 || F > 65535 || W > 65535 ||
        n < 1 || C < 0 || (dpx_wf == nullptr) != (dpy_wf == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    SurfFlags fl;
    for (int k = 0; k < MAX_SURF; ++k) fl.f[k] = k < S ? flags[k] : 0;
    const int nblk = n_blocks(n);
    const dim3 grid((unsigned)nblk, (unsigned)F, (unsigned)W);
    if (S <= 8)
        launch_bucket<8>(grid, st, gen, consts, px, py, cot, part, dpx_wf,
                         dpy_wf, fl, S, F, W, n, nblk, final_prop);
    else if (S <= 16)
        launch_bucket<16>(grid, st, gen, consts, px, py, cot, part, dpx_wf,
                          dpy_wf, fl, S, F, W, n, nblk, final_prop);
    else if (S <= 32)
        launch_bucket<32>(grid, st, gen, consts, px, py, cot, part, dpx_wf,
                          dpy_wf, fl, S, F, W, n, nblk, final_prop);
    else
        launch_bucket<64>(grid, st, gen, consts, px, py, cot, part, dpx_wf,
                          dpy_wf, fl, S, F, W, n, nblk, final_prop);
    int err = (int)cudaGetLastError();
    if (err) return err;
    const long long n_out = (long long)W * S * CONST_W + (long long)F * GEN_W
                            + (long long)S * C;
    gen_grad_reduce<<<(unsigned)n_out, RBLOCK, 0, st>>>(part, dgen, dconsts,
                                                        dacoef, S, F, W, nblk, C);
    err = (int)cudaGetLastError();
    if (err || dpx_wf == nullptr) return err;
    const unsigned g1 = (unsigned)((n + RBLOCK - 1) / RBLOCK);
    sum_wf<<<g1, RBLOCK, 0, st>>>(dpx_wf, dpx, W * F, n);
    err = (int)cudaGetLastError();
    if (err) return err;
    sum_wf<<<g1, RBLOCK, 0, st>>>(dpy_wf, dpy, W * F, n);
    return (int)cudaGetLastError();
}
