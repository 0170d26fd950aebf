// K2, sub-slice (h): the vector-Jacobian product of K1 (h) (gen_trace_xy.cu,
// the coord_split mode) by per-ray recompute and a per-surface reverse
// sweep, with the adjoint written by hand in float64, one ray per thread.
//
// Replaces the split == "xy" branch of the TPU kernel
// optiland_pr_tpu/kernels/pallas_grad.py::_pallas_gen_bwd_2d (body
// _gen_bwd_kernel -> _manual_vjp, jax.vjp of each xy surface step, the
// tile's chief chain included). The TPU kernel's cotangents were float32,
// and at telescope scale the float32 reverse sweep shrinks the
// focus-coupled cotangents (tests/test_pallas_grad.py:528-569); here they
// are float64, like the state. The adjoint follows the derivative
// conventions of PyTorch autograd on the plain version
// (kernels/gen_grad.py::gen_trace_bwd_plain, mode "xy"), which it is held
// against:
//   - where(c, a, b) sends the cotangent to the taken branch only: the
//     guarded roots sqrt(ok ? d : 1) and sqrt(arg > eps ? arg : 1) get none
//     on the guarded side, eps_guard none on its clamp, the root pairing
//     and the near/far choice none to the branch not taken;
//   - the float32 scalars u = n1 / n2, -(u u), -(1 + conic) and g5 - g4 are
//     differentiated as their real expressions (a rounding's derivative is
//     1), as are the float32 roundings of t (absorption) and of the landing
//     point (the aperture test, which passes no cotangent to the position);
//   - the curvature c[0] + c[28] sends its cotangent to both columns, so
//     column 28's is column 0's, as JAX AD gives it;
//   - the NaN step zeroes a lost ray's cotangents of x, y, z, L, M, N and
//     OPD; the intensity's is never masked;
//   - the chief (the pupil-centre ray of each (w, f)) takes the cotangent
//     of base less the sum of that (w, f)'s valid rays' OPD cotangents,
//     since each ray's OPD output is its own less the chief's.
//
// Inputs: the forward's tables and pupil samples and the cotangents of its
// 8 outputs, cot [8, W, F, n], and of base, cot_base [W, F].
// Outputs:
//   dgen    [F, 16]    columns 0-6, 8, 9 (the rest are 0), summed over W
//   dconsts [W, S, 32] columns 0, 1, 3, 4, 5, 6, 27 and 28 (= column 0's);
//                      the rest are 0
//   dPx, dPy [n]       summed over W and F (optional)
//
// Design.
//   1. gen_grad_xy_kernel, grid (ceil(n/256), F, W) as in K1 (h): each
//      thread runs the shared forward (gen_trace_xy.cuh), so its lost-ray
//      mask is K1's bit for bit, keeping each surface's boundary state (x,
//      y, z, L, M, N in float64, the intensity) in a local array sized by a
//      stack-depth bucket (8, 16, 32, 64 surfaces); the reverse sweep
//      recomputes each surface's intermediates from its boundary state and
//      runs its adjoint. Each surface's 7 parameter cotangents, dgen's 9 and
//      the sum of the valid rays' OPD cotangents are summed over the block
//      as they are made (a float64 warp shuffle tree, then the 8 warp sums
//      in order) into one float64 partial per block and slot; slot j of
//      surface k is 7 k + j (columns 0, 1, 3, 4, 5, 6, 27), dgen's follow
//      at 7 S, the OPD sum at 7 S + 9. Each (w, f) has nblk + 1 partials
//      per slot: one per block, and the chief's.
//   2. gen_grad_xy_chief, one block per (w, f): sums that (w, f)'s OPD
//      partials in a fixed order (a strided sum, then a tree), and one
//      thread runs the chief's forward and adjoint with the cotangent
//      cot_base - sum, writing the chief's partial of every slot.
//   3. gen_grad_xy_reduce: one block per output element sums its partials
//      in float64 in a fixed order, then rounds once.
//   4. sum_wf_d: dPx and dPy summed over the W*F float64 planes, in order.
//   No atomics: two runs on the same inputs give bit-identical gradients.
//
// Bounds on an H100: per ray it reads 8 B of pupil and 32 B of cotangents
// and writes 16 B of pupil cotangents per (w, f) plane; its arithmetic is
// K1 (h)'s forward and the adjoint, all float64 (34 TFLOP/s on the H100
// SXM data sheet), about 3x the forward's operations per surface.
// chip_smoke.py counts them (xy_ops) and PERF.md holds the times.
#include "gen_trace_xy.cuh"

#define GBLOCK 256
#define NWARP (GBLOCK / 32)
#define RBLOCK 256
#define NGEN 9        // gen columns with a cotangent: 0-6, 8, 9
#define NXY 7         // slots per surface: consts columns 0, 1, 3, 4, 5, 6, 27

// Cotangents of the ray state.
struct XyAdj {
    double x, y, z, L, M, N, opd, inten;
};

__device__ __forceinline__ double warp_sum_d(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// The slot of consts column j, or -1 if it has no cotangent (column 28
// shares column 0's).
__host__ __device__ __forceinline__ int xy_col_slot(int j) {
    switch (j) {
        case 0: case 28: return 0;
        case 1: return 1;
        case 3: return 2;
        case 4: return 3;
        case 5: return 4;
        case 6: return 5;
        case 27: return 6;
        default: return -1;
    }
}

// gen columns 0-15 -> dgen slot (-1: no cotangent)
__host__ __device__ __forceinline__ int xy_gen_slot(int col) {
    return col <= 6 ? col : (col == 8 ? 7 : (col == 9 ? 8 : -1));
}

// Reverse of xy_step for the surface constants c and flag word fl, from the
// boundary state ``in`` and the recomputed tape: turns the cotangents ``a``
// of the state after the surface into those of the state before it, and
// writes the surface's slot cotangents dc[NXY].
__device__ __forceinline__ void xy_step_adjoint(const float* c, int fl,
                                                const XyRay& in,
                                                const XyTape& tp, XyAdj& a,
                                                double dc[NXY]) {
    const double conic = c[1], n1 = c[3], n2 = c[4];
    const bool plane = fl & FLAG_PLANE, refl = fl & FLAG_REFL;
    const double L = in.L, M = in.M, N = in.N;
    const double t = tp.t, ci = tp.ci;
    double dci = 0.0, dconic = 0.0, dn1 = 0.0, dn2 = 0.0, dalpha = 0.0,
           dcoat = 0.0;

    // ---- the float32 factors: coating, aperture, absorption ---------------
    if (fl & FLAG_COAT) {
        dcoat = a.inten * tp.inten_pc;
        a.inten *= c[6];
    }
    if (fl & FLAG_AP) a.inten *= tp.mask;
    double dt = 0.0;
    if (fl & FLAG_ABSORB) {
        // inten_out = inten * e, e = exp(((-alpha) t32) 1000)
        const double dv = a.inten * in.inten * tp.e * 1000.0;
        a.inten *= tp.e;
        dalpha = -dv * tp.t32;
        dt = -dv * c[5];
    }

    // ---- reflect or refract -------------------------------------------------
    const double aLo = a.L, aMo = a.M, aNo = a.N;
    double aL, aM, aN, ax2 = a.x, ay2 = a.y, du = 0.0;
    if (plane && refl) {                       // N_out = -N
        aL = aLo;
        aM = aMo;
        aN = -aNo;
    } else if (plane) {                        // (u L, u M, sign(N) root)
        aL = aLo * tp.u;
        aM = aMo * tp.u;
        du = aLo * L + aMo * M;
        const double droot = aNo * (N >= 0.0 ? 1.0 : -1.0);
        const double ddisc = tp.ok_r ? droot / (2.0 * tp.root) : 0.0;
        // disc_r = 1 + (1 - N N) nuu
        aN = -2.0 * N * ddisc * tp.nuu;
        du += ddisc * (1.0 - N * N) * (-2.0 * tp.u);   // nuu = -(u u)
    } else {
        double dnx, dny, dnz, ddot;
        if (refl) {                            // d - 2 (d.n) n
            const double td = 2.0 * tp.dot;
            aL = aLo;
            aM = aMo;
            aN = aNo;
            ddot = -2.0 * (aLo * tp.nx + aMo * tp.ny + aNo * tp.nz);
            dnx = -aLo * td;
            dny = -aMo * td;
            dnz = -aNo * td;
        } else {                               // u d + w n
            aL = aLo * tp.u;
            aM = aMo * tp.u;
            aN = aNo * tp.u;
            du = aLo * L + aMo * M + aNo * N;
            dnx = aLo * tp.w;
            dny = aMo * tp.w;
            dnz = aNo * tp.w;
            const double dw = aLo * tp.nx + aMo * tp.ny + aNo * tp.nz;
            // w = root sign(dot) + dot (-u)
            const double droot = dw * (tp.dot >= 0.0 ? 1.0 : -1.0);
            ddot = -dw * tp.u;
            du -= dw * tp.dot;
            const double ddisc = tp.ok_r ? droot / (2.0 * tp.root) : 0.0;
            // disc_r = 1 + (1 - dot dot) nuu, nuu = -(u u)
            ddot -= 2.0 * tp.dot * ddisc * tp.nuu;
            du += ddisc * (1.0 - tp.dot * tp.dot) * (-2.0 * tp.u);
        }
        // dot = (L nx + M ny) + N nz
        aL += ddot * tp.nx;
        aM += ddot * tp.ny;
        aN += ddot * tp.nz;
        dnx += ddot * L;
        dny += ddot * M;
        dnz += ddot * N;
        // (nx, ny, nz) = (dfdx, dfdy, -1) im, im = 1 / sqrt(dfdx^2 + dfdy^2 + 1)
        double ddfdx = dnx * tp.im, ddfdy = dny * tp.im;
        const double dim = dnx * tp.dfdx + dny * tp.dfdy - dnz;
        const double dg2 = -dim * tp.im * tp.im / (2.0 * tp.sn);
        ddfdx += 2.0 * tp.dfdx * dg2;
        ddfdy += 2.0 * tp.dfdy * dg2;
        // dfdx = (x2 ir) ci
        const double dxir = ddfdx * ci, dyir = ddfdy * ci;
        dci += ddfdx * tp.xir + ddfdy * tp.yir;
        ax2 += dxir * tp.ir;
        ay2 += dyir * tp.ir;
        const double dir = dxir * tp.x2 + dyir * tp.y2;
        // ir = 1 / sqrt(arg > eps ? arg : 1)
        const double darg = tp.arg > EPS_GUARD_D
                                ? -dir * tp.ir * tp.ir / (2.0 * tp.sr) : 0.0;
        // arg = 1 + (r2 ci2) k1, k1 = -(1 + conic)
        const double dp = darg * tp.k1;
        dconic -= darg * tp.r2 * tp.ci2;
        const double dr2 = dp * tp.ci2;
        dci += 2.0 * ci * dp * tp.r2;
        ax2 += 2.0 * tp.x2 * dr2;
        ay2 += 2.0 * tp.y2 * dr2;
    }
    // u = n1 / n2 (a plane mirror has none)
    if (!(plane && refl)) {
        dn1 += du / n2;
        dn2 -= du * tp.u / n2;
    }

    // ---- the OPD and the propagation: opd += t n1, (x, y, z) += t (L, M, N)
    dt += a.opd * n1;
    dn1 += a.opd * t;
    dt += ax2 * L + ay2 * M + a.z * N;
    aL += ax2 * t;
    aM += ay2 * t;
    aN += a.z * t;
    double ax = ax2, ay = ay2, az = a.z;       // of the shifted z1

    // ---- the intersection ---------------------------------------------------
    if (plane) {                               // t = (-z1) / N
        az -= dt / N;
        aN -= dt * t / N;
    } else {
        // t = t0 + (ok ? (near ? t_near : t_far) : 0)
        double dt0 = dt;
        const double dtq = tp.ok ? dt : 0.0;
        const double dtn = tp.near ? dtq : 0.0;
        const double dtf = tp.near ? 0.0 : dtq;
        // t_near = cc / qg, t_far = qg / ag
        double dcc = dtn / tp.qg;
        double dqg = -dtn * tp.t_near / tp.qg + dtf / tp.ag;
        const double dag = -dtf * tp.t_far / tp.ag;
        const double dq = fabs(tp.q) > EPS_GUARD_D ? dqg : 0.0;
        double da = fabs(tp.a) > EPS_GUARD_D ? dag : 0.0;
        // q = -(bh + (bh >= 0 ? sq : -sq))
        double dbh = -dq;
        const double dsq = tp.bh >= 0.0 ? -dq : dq;
        // sq = sqrt(ok ? disc : 1), disc = bh^2 - a cc
        const double ddisc = tp.ok ? dsq / (2.0 * tp.sq) : 0.0;
        dbh += 2.0 * tp.bh * ddisc;
        da -= ddisc * tp.cc;
        dcc -= ddisc * tp.a;
        // cc = (x0^2 + y0^2) ci
        const double x0 = tp.x0, y0 = tp.y0;
        const double dss = dcc * ci;
        dci += dcc * (x0 * x0 + y0 * y0);
        double dx0 = 2.0 * x0 * dss, dy0 = 2.0 * y0 * dss;
        // bh = (L x0 + M y0) ci - N
        aN -= dbh;
        const double dlin = dbh * ci;
        dci += dbh * (L * x0 + M * y0);
        aL += dlin * x0;
        aM += dlin * y0;
        dx0 += dlin * L;
        dy0 += dlin * M;
        // a = ((N N) conic + 1) ci
        const double dinn = da * ci;
        dci += da * (N * N * conic + 1.0);
        dconic += dinn * N * N;
        aN += 2.0 * N * dinn * conic;
        // (x0, y0) = (x, y) + t0 (L, M)
        ax += dx0;
        ay += dy0;
        dt0 += dx0 * L + dy0 * M;
        aL += dx0 * tp.t0;
        aM += dy0 * tp.t0;
        // t0 = (-z1) / N
        az -= dt0 / N;
        aN -= dt0 * tp.t0 / N;
    }

    // ---- the shift: z1 = z - gap ---------------------------------------------
    a.x = ax;
    a.y = ay;
    a.z = az;
    a.L = aL;
    a.M = aM;
    a.N = aN;
    dc[0] = dci;                               // columns 0 and 28
    dc[1] = dconic;
    dc[2] = dn1;
    dc[3] = dn2;
    dc[4] = dalpha;
    dc[5] = dcoat;
    dc[6] = -az;                               // column 27, the gap
}

// Reverse of xy_launch: dgen's slots (dgv[6], the image thickness's, is the
// caller's) and the pupil cotangents of the launch geometry (the
// apodization's are the caller's).
__device__ __forceinline__ void xy_launch_adjoint(const float* g, float Px,
                                                  float Py, const XyLaunch& lt,
                                                  const XyAdj& a,
                                                  double dgv[NGEN],
                                                  double& dpx, double& dpy) {
    const bool tele = g[10] != 0.0f;
    // (L, M, N) = (dxr, dyr, dzr) im, im = 1 / sqrt(dxr^2 + dyr^2 + dzr^2)
    const double dim = a.L * lt.dxr + a.M * lt.dyr + a.N * lt.dzr;
    const double dmag = -dim * lt.im * lt.im / (2.0 * lt.sm);
    const double ddxr = a.L * lt.im + 2.0 * lt.dxr * dmag;
    const double ddyr = a.M * lt.im + 2.0 * lt.dyr * dmag;
    const double ddzr = a.N * lt.im + 2.0 * lt.dzr * dmag;
    // x = Px g0 + g2; dxr = Px g8 - x (telecentric: Px g8); z = 0
    const double ax = tele ? a.x : a.x - ddxr;
    const double ay = tele ? a.y : a.y - ddyr;
    dgv[0] = ax * Px;
    dgv[1] = ay * Py;
    dgv[2] = ax;
    dgv[3] = ay;
    dgv[4] = tele ? 0.0 : -ddzr;               // dzr = g5 - g4
    dgv[5] = ddzr;
    dgv[7] = ddxr * Px;
    dgv[8] = ddyr * Py;
    dpx = ddxr * g[8] + ax * g[0];
    dpy = ddyr * g[9] + ay * g[1];
}

template <int MAXS>
__global__ void __launch_bounds__(GBLOCK)
gen_grad_xy_kernel(const float* __restrict__ gen,
                   const float* __restrict__ consts,
                   const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ cot, double* __restrict__ part,
                   double* __restrict__ dpx_wf, double* __restrict__ dpy_wf,
                   const SurfFlags flags, int S, int F, int W, long long n,
                   int nblk, int final_prop) {
    __shared__ float sc[MAXS * CONST_W];
    __shared__ float sg[GEN_W];
    __shared__ double sw[NWARP * (NXY * MAXS + NGEN + 1)];
    const int nq = NXY * S + NGEN + 1;
    const int f = blockIdx.y;
    const int w = blockIdx.z;
    const float* cw = consts + (size_t)w * S * CONST_W;
    for (int j = threadIdx.x; j < S * CONST_W; j += blockDim.x) sc[j] = cw[j];
    if (threadIdx.x < GEN_W) sg[threadIdx.x] = gen[(size_t)f * GEN_W + threadIdx.x];
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long i = (long long)blockIdx.x * GBLOCK + threadIdx.x;
    // threads past the tail run a dummy ray with zero cotangents and add 0,
    // so that every lane takes part in the warp sums
    const bool active = i < n;
    const float Px = active ? px[i] : 0.0f;
    const float Py = active ? py[i] : 0.0f;

    // ---- forward, keeping each surface's input state -------------------------
    double st[MAXS][6];
    float si[MAXS];
    XyRay s;
    XyLaunch lt;
    xy_launch(sg, Px, Py, s, lt);
    for (int k = 0; k < S; ++k) {
        st[k][0] = s.x;
        st[k][1] = s.y;
        st[k][2] = s.z;
        st[k][3] = s.L;
        st[k][4] = s.M;
        st[k][5] = s.N;
        si[k] = s.inten;
        XyTape tp;
        xy_step(sc + k * CONST_W, flags.f[k], s, tp);
    }

    // ---- cotangents; the NaN step's transpose zeroes lost rays' ------------
    const size_t plane = (size_t)W * F * n;
    const size_t o = ((size_t)w * F + f) * n + (active ? i : 0);
    XyAdj a = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
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
    // the chief's share: the sum of the valid rays' OPD cotangents
    {
        const double v = warp_sum_d(a.opd);
        if (lane == 0) sw[warp * nq + NXY * S + NGEN] = v;
    }

    // ---- epilogue: (x, y, z) += t_img (L, M, N) ----------------------------
    double dgv[NGEN];
    dgv[6] = 0.0;
    if (final_prop) {
        const double t_img = sg[6];
        dgv[6] = a.x * s.L + a.y * s.M + a.z * s.N;
        a.L += a.x * t_img;
        a.M += a.y * t_img;
        a.N += a.z * t_img;
    }

    // ---- surfaces in reverse -----------------------------------------------
    for (int k = S - 1; k >= 0; --k) {
        const float* c = sc + k * CONST_W;
        XyRay in;
        in.x = st[k][0];
        in.y = st[k][1];
        in.z = st[k][2];
        in.L = st[k][3];
        in.M = st[k][4];
        in.N = st[k][5];
        in.inten = si[k];
        in.opd = 0.0;
        in.valid = true;
        XyRay out = in;
        XyTape tp;
        xy_step(c, flags.f[k], out, tp);
        double dc[NXY];
        xy_step_adjoint(c, flags.f[k], in, tp, a, dc);
#pragma unroll
        for (int j = 0; j < NXY; ++j) {
            const double v = warp_sum_d(active ? dc[j] : 0.0);
            if (lane == 0) sw[warp * nq + NXY * k + j] = v;
        }
    }

    // ---- prologue ------------------------------------------------------------
    double dpx, dpy;
    xy_launch_adjoint(sg, Px, Py, lt, a, dgv, dpx, dpy);
    if (active && dpx_wf != nullptr) {
        float dpx_a = 0.0f, dpy_a = 0.0f;
        apod_adjoint(sg, Px, Py, (float)a.inten, dpx_a, dpy_a);
        dpx_wf[o] = dpx + dpx_a;
        dpy_wf[o] = dpy + dpy_a;
    }
#pragma unroll
    for (int j = 0; j < NGEN; ++j) {
        const double v = warp_sum_d(active ? dgv[j] : 0.0);
        if (lane == 0) sw[warp * nq + NXY * S + j] = v;
    }
    __syncthreads();

    // ---- one partial per block and slot, warps summed in order --------------
    const size_t nb = (size_t)W * F * (nblk + 1);
    const size_t b = ((size_t)w * F + f) * (nblk + 1) + blockIdx.x;
    for (int qq = threadIdx.x; qq < nq; qq += GBLOCK) {
        double v = 0.0;
        for (int j = 0; j < NWARP; ++j) v += sw[j * nq + qq];
        part[(size_t)qq * nb + b] = v;
    }
}

// One block per (w, f): the chief's partial of every slot, for the chief's
// cotangent cot_base[w, f] less the sum of the rays' OPD cotangents.
__global__ void __launch_bounds__(RBLOCK)
gen_grad_xy_chief(const float* __restrict__ gen,
                  const float* __restrict__ consts,
                  const float* __restrict__ cot_base,
                  double* __restrict__ part, const SurfFlags flags, int S,
                  int F, int W, int nblk) {
    __shared__ double red[RBLOCK];
    const int j = blockIdx.x;
    const int nq = NXY * S + NGEN + 1;
    const size_t nb = (size_t)W * F * (nblk + 1);
    const size_t b0 = (size_t)j * (nblk + 1);
    const double* sum_p = part + (size_t)(nq - 1) * nb + b0;
    double acc = 0.0;
    for (int t = threadIdx.x; t < nblk; t += RBLOCK) acc += sum_p[t];
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int h = RBLOCK / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x != 0) return;

    const float* g = gen + (size_t)(j % F) * GEN_W;
    const float* cw = consts + (size_t)(j / F) * S * CONST_W;
    double st[MAX_SURF][6];
    XyRay s;
    XyLaunch lt;
    xy_launch(g, 0.0f, 0.0f, s, lt);
    for (int k = 0; k < S; ++k) {
        st[k][0] = s.x;
        st[k][1] = s.y;
        st[k][2] = s.z;
        st[k][3] = s.L;
        st[k][4] = s.M;
        st[k][5] = s.N;
        XyTape tp;
        xy_step(cw + k * CONST_W, flags.f[k], s, tp);
    }
    XyAdj a = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    a.opd = (double)cot_base[j] - red[0];
    double* out = part + b0 + nblk;
    for (int k = S - 1; k >= 0; --k) {
        const float* c = cw + k * CONST_W;
        XyRay in;
        in.x = st[k][0];
        in.y = st[k][1];
        in.z = st[k][2];
        in.L = st[k][3];
        in.M = st[k][4];
        in.N = st[k][5];
        in.inten = 1.0f;
        in.opd = 0.0;
        in.valid = true;
        XyRay o = in;
        XyTape tp;
        xy_step(c, flags.f[k], o, tp);
        double dc[NXY];
        xy_step_adjoint(c, flags.f[k], in, tp, a, dc);
        for (int q = 0; q < NXY; ++q) out[(size_t)(NXY * k + q) * nb] = dc[q];
    }
    double dgv[NGEN], dpx, dpy;
    dgv[6] = 0.0;
    xy_launch_adjoint(g, 0.0f, 0.0f, lt, a, dgv, dpx, dpy);
    for (int q = 0; q < NGEN; ++q) out[(size_t)(NXY * S + q) * nb] = dgv[q];
    out[(size_t)(nq - 1) * nb] = 0.0;
}

// One block per element of dconsts [W, S, 32] and dgen [F, 16], in that
// order: the sum of its partials (every block's and the chief's) in a fixed
// order, in float64, rounded once.
__global__ void __launch_bounds__(RBLOCK)
gen_grad_xy_reduce(const double* __restrict__ part, float* __restrict__ dgen,
                   float* __restrict__ dconsts, int S, int F, int W,
                   int nblk) {
    __shared__ double red[RBLOCK];
    const long long e = blockIdx.x;
    const long long n_dc = (long long)W * S * CONST_W;
    const size_t per_wf = (size_t)nblk + 1;
    const size_t nb = (size_t)W * F * per_wf;
    float* dst;
    size_t base = 0, seg_stride = 0;
    long long nseg = 0, seglen = 0;
    if (e < n_dc) {
        dst = dconsts + e;
        const int w = (int)(e / ((long long)S * CONST_W));
        const int k = (int)((e / CONST_W) % S);
        const int q = xy_col_slot((int)(e % CONST_W));
        if (q >= 0) {                          // sum over f and blocks
            base = (size_t)(NXY * k + q) * nb + (size_t)w * F * per_wf;
            nseg = 1;
            seglen = (long long)(F * per_wf);
        }
    } else {
        dst = dgen + (e - n_dc);
        const int f = (int)((e - n_dc) / GEN_W);
        const int q = xy_gen_slot((int)((e - n_dc) % GEN_W));
        if (q >= 0) {                          // sum over w and blocks
            base = (size_t)(NXY * S + q) * nb + (size_t)f * per_wf;
            seg_stride = (size_t)F * per_wf;
            nseg = W;
            seglen = (long long)per_wf;
        }
    }
    double acc = 0.0;
    for (long long sgi = 0; sgi < nseg; ++sgi) {
        const double* p = part + base + (size_t)sgi * seg_stride;
        for (long long t = threadIdx.x; t < seglen; t += RBLOCK) acc += p[t];
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
sum_wf_d(const double* __restrict__ src, float* __restrict__ dst, int WF,
         long long n) {
    const long long i = (long long)blockIdx.x * RBLOCK + threadIdx.x;
    if (i >= n) return;
    double acc = 0.0;
    for (int j = 0; j < WF; ++j) acc += src[(size_t)j * n + i];
    dst[i] = (float)acc;
}

static int n_blocks(long long n) { return (int)((n + GBLOCK - 1) / GBLOCK); }

// Doubles of the partials buffer gen_grad_xy_launch needs.
extern "C" long long gen_grad_xy_partials_size(int S, int F, int W,
                                               long long n) {
    if (S < 1 || S > MAX_SURF || F < 1 || W < 1 || n < 1) return -1;
    return (long long)(NXY * S + NGEN + 1) * W * F * (n_blocks(n) + 1);
}

template <int MAXS>
static void launch_bucket(dim3 grid, cudaStream_t st, const float* gen,
                          const float* consts, const float* px,
                          const float* py, const float* cot, double* part,
                          double* dpx_wf, double* dpy_wf, const SurfFlags& fl,
                          int S, int F, int W, long long n, int nblk,
                          int final_prop) {
    gen_grad_xy_kernel<MAXS><<<grid, GBLOCK, 0, st>>>(
        gen, consts, px, py, cot, part, dpx_wf, dpy_wf, fl, S, F, W, n, nblk,
        final_prop);
}

// Launch the four kernels on ``stream``; returns cudaGetLastError() after
// each launch (0 on success). flags is a host array of S words that xy_ok
// accepts; cot_base holds the W * F cotangents of base; part holds
// gen_grad_xy_partials_size doubles; dpx_wf/dpy_wf hold W*F*n doubles
// each, or are null (then dpx/dpy are not written). Allocates nothing and
// does not synchronise.
extern "C" int gen_grad_xy_launch(const float* gen, const float* consts,
                                  const float* px, const float* py,
                                  const float* cot, const float* cot_base,
                                  double* part, double* dpx_wf, double* dpy_wf,
                                  float* dgen, float* dconsts, float* dpx,
                                  float* dpy, const int32_t* flags, int S,
                                  int F, int W, long long n, int final_prop,
                                  void* stream) {
    if (S < 1 || S > MAX_SURF || F < 1 || W < 1 || F > 65535 || W > 65535 ||
        n < 1 || (dpx_wf == nullptr) != (dpy_wf == nullptr) ||
        (dpx_wf != nullptr && (dpx == nullptr || dpy == nullptr)) ||
        !xy_ok(flags, S))
        return (int)cudaErrorInvalidValue;
    SurfFlags fl;
    for (int k = 0; k < MAX_SURF; ++k) fl.f[k] = k < S ? flags[k] : 0;
    cudaStream_t st = (cudaStream_t)stream;
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
    gen_grad_xy_chief<<<(unsigned)(W * F), RBLOCK, 0, st>>>(
        gen, consts, cot_base, part, fl, S, F, W, nblk);
    err = (int)cudaGetLastError();
    if (err) return err;
    const long long n_out = (long long)W * S * CONST_W + (long long)F * GEN_W;
    gen_grad_xy_reduce<<<(unsigned)n_out, RBLOCK, 0, st>>>(part, dgen, dconsts,
                                                          S, F, W, nblk);
    err = (int)cudaGetLastError();
    if (err || dpx_wf == nullptr) return err;
    const unsigned g1 = (unsigned)((n + RBLOCK - 1) / RBLOCK);
    sum_wf_d<<<g1, RBLOCK, 0, st>>>(dpx_wf, dpx, W * F, n);
    err = (int)cudaGetLastError();
    if (err) return err;
    sum_wf_d<<<g1, RBLOCK, 0, st>>>(dpy_wf, dpy, W * F, n);
    return (int)cudaGetLastError();
}
