// K2's WIDE, plain-OPD, polarized instance (gen_grad.cu built as
// gen_grad_pol.cu: gen_grad_kernel<MAXS, VAR_WIDE, OPD_PLAIN, true>, MAXS 8,
// 16, 32, 64), redesigned for Hopper: the vector-Jacobian product of K1 (e)
// in its WIDE variant (the polarized double Gauss's gradient, the tilted
// coated singlet's). It computes what _manual_vjp computes
// (pallas_grad.py:70) with the Jones chain of sub-slice (e), on conic,
// plane and even/odd aspheric surfaces that refract or reflect, tilted or
// decentered, with apertures, simple and Fresnel coatings and absorption,
// from a telecentric or apodized launch: the same function as gen_grad.cu's
// template, not the same operation order. It is held against the plain
// version (kernels/gen_grad.py::gen_trace_bwd_plain) at GRAD_TOL per slot,
// its pupil cotangents against the float64 plain version with their float32
// floor (chip_smoke.py, phase 3 (e)).
//
// The forward is K1 (e)'s, bit for bit: gen_prologue, polar_init and
// surface_step<VAR_WIDE, OPD_PLAIN, true> (polar_surface, polar_apply), run
// as K1 (e) runs them, so the lost-ray mask and the states are K1 (e)'s; the
// reverse sweep recomputes each surface with surface_step and
// polar_surface for its tape, as the template does. Only the adjoint is
// rearranged.
//
// What held the template back (6.0 ms for the double Gauss's 4M rays on an
// H100, 15x its bound, issue-bound): 191 registers under
// __launch_bounds__(256), so one block of 8 warps per SM, which could not
// hide the latency of its dependent chains and local-memory reads; 13
// floats of local memory per surface for the states; a five-step shuffle
// tree per parameter cotangent (six or more per surface and ray); IEEE
// divisions by ray quantities and by each surface's n1 and n2 in the
// adjoint.
//
// The design:
// - at most 128 registers (__launch_bounds__(256, 2)): two blocks, 16 warps,
//   per SM. The Jones adjoint's live values spill ~300 bytes there; on an
//   H100 that ran 4.2 ms against 5.2 ms for one block per SM without a
//   spill, and recomputing the tape later to shorten live ranges, or three
//   blocks per SM, ran slower still (PERF.md);
// - the launch's number of E-vectors a template parameter of the body (the
//   kernel branches once, uniformly, on it), so that a linear launch keeps
//   no second vector;
// - a polarized launch's traced intensity gets no cotangent (its final
//   intensity is scale x sum |E|^2), so neither the absorption, the
//   aperture nor a simple coating's factor has one: the intensity is
//   neither stored nor recomputed, and those columns' cotangents are 0;
//   each surface keeps 6 + 3 n_ev floats of state (9 or 12, not 13);
// - each surface's cotangents summed over the warp by one butterfly
//   (warp_scatter_sum): ri, conic, pos_z, n1 through the optical path, and
//   the cotangents of u = n1 / n2 (refraction) and n = n2 / n1 (a Fresnel
//   coating's coefficients), which the block maps to n1's and n2's once
//   per surface; a tilted surface's 12 columns by one more, the asphere
//   terms by one per 8;
// - divisions by ray quantities in the adjoint as MUFU.RCP and one Newton
//   step (div_fast), the normal's 1/(2 sn) and 1/(2 sr) from the
//   forward's reciprocals; the s basis's adjoint (sp_adjoint's order, its
//   division by |k0 x n| included) is kept, since near normal incidence its
//   rounding grows as 1 / |k0 x n|;
// - every sum in a fixed order: the butterfly's, the 8 warps in order per
//   block, gen_grad_reduce in float64 across blocks. No float atomics, so
//   two runs are bit-identical.
// The derivative conventions are gen_grad.cu's.
#pragma once

#include "gen_trace_narrow.cuh"   // div_fast
#include "warp_scatter.cuh"

static_assert(GRAD_MODE == OPD_PLAIN && GRAD_POL && !WITH_DOE,
              "the WIDE polarized instances are the plain polarized library's");

// the cotangents summed per surface and ray
#define PW_NB 8
enum { PW_RI = 0, PW_CONIC, PW_PZ, PW_N1, PW_U, PW_N };
#define PW_NGEN 16    // dgen's 9, padded for the butterfly

// The per-warp sums of a block: PW_NB per surface, then the layout's slots
// (a surface's columns 0-6 stay unused there: the block maps them from the
// PW_NB), then dgen's PW_NGEN.
__host__ __device__ __forceinline__ int polw_nq(const GradLayout& g, int S) {
    return PW_NB * S + g.qoff[S] + PW_NGEN;
}

static inline size_t polw_shmem(const GradLayout& g, int S) {
    return (size_t)NWARP * polw_nq(g, S) * sizeof(float);
}

// the cotangents of a ray's state (opd's passes every surface unchanged)
struct PAdj {
    float x, y, z, L, M, N, opd;
};

// fresnel_diag_adjoint's, returning the cotangent of n = n2 / n1 in gn (the
// block splits it into n1's and n2's) and the root's by div_fast
__device__ __forceinline__ void pw_fresnel_adjoint(const PolSurf& b, float c,
                                                   bool refl, float gjs,
                                                   float gjp, float& dcos,
                                                   float& gnn) {
    float gc = 0.0f, groot = 0.0f, gn2c = 0.0f, gda = 0.0f, gdb = 0.0f,
          ginv = 0.0f, gn = 0.0f;
    if (refl) {
        const float gjr = -gjp;
        const float cm = c - b.root, nm = b.n2c - b.root;
        const float gcm = gjs * b.db * b.finv;
        gdb += gjs * cm * b.finv;
        ginv += gjs * cm * b.db;
        const float gnm = gjr * b.da * b.finv;
        gda += gjr * nm * b.finv;
        ginv += gjr * nm * b.da;
        gc += gcm;
        groot -= gcm + gnm;
        gn2c += gnm;
    } else {
        gc += 2.0f * gjs * b.db * b.finv;
        gdb += gjs * 2.0f * c * b.finv;
        ginv += gjs * 2.0f * c * b.db;
        const float t = 2.0f * b.n * c;
        gn += gjp * 2.0f * c * b.da * b.finv;
        gc += gjp * 2.0f * b.n * b.da * b.finv;
        gda += gjp * t * b.finv;
        ginv += gjp * t * b.da;
    }
    const float gprod = -ginv * b.finv * b.finv;
    gda += gprod * b.db;
    gdb += gprod * b.da;
    gc += gda;
    groot += gda + gdb;
    gn2c += gdb;
    gn += gn2c * c * 2.0f * b.n;
    gc += gn2c * b.n * b.n;
    const float grad = b.rad > EPS_GUARD ? div_fast(groot, 2.0f * b.root)
                                         : 0.0f;
    gn += 2.0f * b.n * grad;
    gc += 2.0f * c * grad;
    gnn += gn;
    dcos += gc;
}

// sp_adjoint (gen_grad.cu) in its operation order, with pw_fresnel_adjoint
// for the coefficients; NEV vectors
template <int NEV>
__device__ __forceinline__ void pw_sp_adjoint(
        const PolSurf& b, bool plane, bool refl, float cos_i, float L0,
        float M0, float N0, float L1, float M1, float N1, float nx, float ny,
        float nz, const float (*ein)[3], float (*g)[3], float* gk0,
        float* gk1, float* gn, float& gcos, float& gnn) {
    const float spx = b.fb ? 0.0f : b.sx0, spy = b.fb ? N0 : b.sy0,
                spz = b.fb ? -M0 : b.sz0;
    const float js = b.fres ? b.js : 1.0f, jp = b.fres ? b.jp : 1.0f,
                j3 = b.fres ? b.j3 : 1.0f;
    float gs[3] = {0.0f, 0.0f, 0.0f}, gp0[3] = {0.0f, 0.0f, 0.0f},
          gp1[3] = {0.0f, 0.0f, 0.0f}, hk0[3] = {0.0f, 0.0f, 0.0f},
          hk1[3] = {0.0f, 0.0f, 0.0f}, hn[3] = {0.0f, 0.0f, 0.0f},
          gjs = 0.0f, gjp = 0.0f;
#pragma unroll
    for (int v = 0; v < NEV; ++v) {
        const float ex = ein[v][0], ey = ein[v][1], ez = ein[v][2];
        const float Gx = g[v][0], Gy = g[v][1], Gz = g[v][2];
        const float dsr = b.sx * ex + b.sy * ey + b.sz * ez;
        const float dpr = b.p0x * ex + b.p0y * ey + b.p0z * ez;
        const float dkr = L0 * ex + M0 * ey + N0 * ez;
        const float ds = js * dsr, dp = jp * dpr, dk = j3 * dkr;
        const float gds = Gx * b.sx + Gy * b.sy + Gz * b.sz;
        const float gdp = Gx * b.p1x + Gy * b.p1y + Gz * b.p1z;
        const float gdk = Gx * L1 + Gy * M1 + Gz * N1;
        gs[0] += ds * Gx;
        gs[1] += ds * Gy;
        gs[2] += ds * Gz;
        gp1[0] += dp * Gx;
        gp1[1] += dp * Gy;
        gp1[2] += dp * Gz;
        hk1[0] += dk * Gx;
        hk1[1] += dk * Gy;
        hk1[2] += dk * Gz;
        gjs += gds * dsr;
        gjp += gdp * dpr;
        const float gdsr = gds * js, gdpr = gdp * jp, gdkr = gdk * j3;
        gs[0] += gdsr * ex;
        gs[1] += gdsr * ey;
        gs[2] += gdsr * ez;
        gp0[0] += gdpr * ex;
        gp0[1] += gdpr * ey;
        gp0[2] += gdpr * ez;
        hk0[0] += gdkr * ex;
        hk0[1] += gdkr * ey;
        hk0[2] += gdkr * ez;
        g[v][0] = gdsr * b.sx + gdpr * b.p0x + gdkr * L0;
        g[v][1] = gdsr * b.sy + gdpr * b.p0y + gdkr * M0;
        g[v][2] = gdsr * b.sz + gdpr * b.p0z + gdkr * N0;
    }
    cross_acc(b.sx, b.sy, b.sz, gp1[0], gp1[1], gp1[2], hk1);
    cross_acc(gp1[0], gp1[1], gp1[2], L1, M1, N1, gs);
    cross_acc(b.sx, b.sy, b.sz, gp0[0], gp0[1], gp0[2], hk0);
    cross_acc(gp0[0], gp0[1], gp0[2], L0, M0, N0, gs);
    float gsp[3] = {gs[0] * b.inv, gs[1] * b.inv, gs[2] * b.inv};
    const float ginv = gs[0] * spx + gs[1] * spy + gs[2] * spz;
    const float gm2 = b.mag2f > 0.0f ? -ginv * b.inv * b.inv / (2.0f * b.sq)
                                     : 0.0f;
    if (b.fb) {
        hk0[2] += gsp[1] + 2.0f * N0 * gm2;
        hk0[1] += -gsp[2] + 2.0f * M0 * gm2;
    } else if (plane) {
        hk0[0] += gsp[1] + 2.0f * L0 * gm2;
        hk0[1] += -gsp[0] + 2.0f * M0 * gm2;
    } else {
        gsp[0] += 2.0f * b.sx0 * gm2;
        gsp[1] += 2.0f * b.sy0 * gm2;
        gsp[2] += 2.0f * b.sz0 * gm2;
        cross_acc(nx, ny, nz, gsp[0], gsp[1], gsp[2], hk0);
        cross_acc(gsp[0], gsp[1], gsp[2], L0, M0, N0, hn);
    }
    for (int j = 0; j < 3; ++j) {
        gk0[j] += hk0[j];
        gk1[j] += hk1[j];
        gn[j] += hn[j];
    }
    if (b.fres)
        pw_fresnel_adjoint(b, cos_i, refl, gjs, gjp, gcos, gnn);
}

// polar_adjoint's Rodrigues form (a bare refracting surface); NEV vectors
template <int NEV>
__device__ __forceinline__ void pw_rod_adjoint(
        const PolSurf& b, float L0, float M0, float N0, float L1, float M1,
        float N1, const float (*ein)[3], float (*g)[3], float* gk0,
        float* gk1) {
    float gu[3] = {0.0f, 0.0f, 0.0f}, gct = 0.0f, ginv1c = 0.0f;
#pragma unroll
    for (int v = 0; v < NEV; ++v) {
        const float ex = ein[v][0], ey = ein[v][1], ez = ein[v][2];
        const float Gx = g[v][0], Gy = g[v][1], Gz = g[v][2];
        const float uE = b.ux * ex + b.uy * ey + b.uz * ez;
        const float ue = uE * b.inv1c;
        gct += Gx * ex + Gy * ey + Gz * ez;
        float h[3] = {b.ct * Gx, b.ct * Gy, b.ct * Gz};
        cross_acc(ex, ey, ez, Gx, Gy, Gz, gu);
        cross_acc(Gx, Gy, Gz, b.ux, b.uy, b.uz, h);
        gu[0] += ue * Gx;
        gu[1] += ue * Gy;
        gu[2] += ue * Gz;
        const float gue = Gx * b.ux + Gy * b.uy + Gz * b.uz;
        const float guE = gue * b.inv1c;
        ginv1c += gue * uE;
        gu[0] += guE * ex;
        gu[1] += guE * ey;
        gu[2] += guE * ez;
        g[v][0] = h[0] + guE * b.ux;
        g[v][1] = h[1] + guE * b.uy;
        g[v][2] = h[2] + guE * b.uz;
    }
    gct -= ginv1c * b.inv1c * b.inv1c;
    gk0[0] += gct * L1;
    gk0[1] += gct * M1;
    gk0[2] += gct * N1;
    gk1[0] += gct * L0;
    gk1[1] += gct * M0;
    gk1[2] += gct * N0;
    cross_acc(L1, M1, N1, gu[0], gu[1], gu[2], gk0);
    cross_acc(gu[0], gu[1], gu[2], L0, M0, N0, gk1);
}

// The adjoint of surface_step<VAR_WIDE, OPD_PLAIN, true> on one surface: from
// the cotangents ``a`` (gE: the E-vectors') of the state after it to those
// before it, ``in`` the state before it, ein the incoming E-vectors; adds
// the per-ray cotangents PW_* to g, a tilted surface's columns 8-19 to dcs,
// the asphere terms' to da.
template <int NEV>
__device__ __forceinline__ void pw_adjoint(const float* c, const float* ac,
                                           const float* ztab, int fl,
                                           const RayState& in,
                                           const float (*ein)[3],
                                           float (*gE)[3], PAdj& a,
                                           float (&g)[PW_NB],
                                           float (&dcs)[12], float* da) {
    // the surface's tape: surface_step recomputed from the state before it
    // (the E-vectors do not enter it)
    SurfTape tp;
    {
        RayState out = in;
        surface_step<VAR_WIDE, OPD_PLAIN>(c, ac, ztab, fl, 1.0f, out, tp);
    }
    const float ri = c[0], conic = c[1], n1 = c[3];
    const bool cs = (fl & FLAG_CS) != 0;
    const bool refl = (fl & FLAG_REFL) != 0;
    const int gk = gkind_of(fl);
    const bool newton = gk != GK_CONIC;
    const bool plane = !newton && (fl & FLAG_PLANE);
    const float L = tp.Ll, M = tp.Ml, N = tp.Nl;
    const float x2 = tp.x2, y2 = tp.y2, t = tp.t;

    // ---- globalize: (x, L)_out = R (x2, Lo)_local + t; else z_out = z2 +
    // pos_z ------------------------------------------------------------------
    float ax2, ay2, az2, aLo, aMo, aNo;
    if (cs) {
        const float axg = a.x, ayg = a.y, azg = a.z;
        const float aLg = a.L, aMg = a.M, aNg = a.N;
        ax2 = c[8] * axg + c[11] * ayg + c[14] * azg;
        ay2 = c[9] * axg + c[12] * ayg + c[15] * azg;
        az2 = c[10] * axg + c[13] * ayg + c[16] * azg;
        aLo = c[8] * aLg + c[11] * aMg + c[14] * aNg;
        aMo = c[9] * aLg + c[12] * aMg + c[15] * aNg;
        aNo = c[10] * aLg + c[13] * aMg + c[16] * aNg;
        // rotation entry (i, j), column 8 + 3 i + j, in dcs[3 i + j]
        dcs[0] = axg * x2 + aLg * tp.Lo;
        dcs[1] = axg * y2 + aLg * tp.Mo;
        dcs[2] = axg * tp.z2 + aLg * tp.No;
        dcs[3] = ayg * x2 + aMg * tp.Lo;
        dcs[4] = ayg * y2 + aMg * tp.Mo;
        dcs[5] = ayg * tp.z2 + aMg * tp.No;
        dcs[6] = azg * x2 + aNg * tp.Lo;
        dcs[7] = azg * y2 + aNg * tp.Mo;
        dcs[8] = azg * tp.z2 + aNg * tp.No;
        dcs[9] = axg;
        dcs[10] = ayg;
        dcs[11] = azg;
    } else {
        g[PW_PZ] += a.z;
        ax2 = a.x;
        ay2 = a.y;
        az2 = a.z;
        aLo = a.L;
        aMo = a.M;
        aNo = a.N;
    }

    // ---- the Jones update: E' from (L, M, N), (Lo, Mo, No), the normal and
    // cos_i (|N| on a plane, |dot| else) --------------------------------------
    const float cos_i = plane ? fabsf(N) : fabsf(tp.dot);
    float gk0[3] = {0.0f, 0.0f, 0.0f}, gnrm[3] = {0.0f, 0.0f, 0.0f},
          gcos = 0.0f;
    {
        PolSurf b;
        polar_surface(b, fl, n1, c[4], plane, cos_i, L, M, N, tp.Lo, tp.Mo,
                      tp.No, tp.nx, tp.ny, tp.nz);
        float gk1[3] = {0.0f, 0.0f, 0.0f};
        if (b.rod)
            pw_rod_adjoint<NEV>(b, L, M, N, tp.Lo, tp.Mo, tp.No, ein, gE, gk0,
                                gk1);
        else
            pw_sp_adjoint<NEV>(b, plane, refl, cos_i, L, M, N, tp.Lo, tp.Mo,
                               tp.No, tp.nx, tp.ny, tp.nz, ein, gE, gk0, gk1,
                               gnrm, gcos, g[PW_N]);
        aLo += gk1[0];
        aMo += gk1[1];
        aNo += gk1[2];
    }

    // ---- refract or reflect ----------------------------------------------------
    float aL, aM, aN;                          // cotangents of L, M, N in
    if (plane) {
        if (refl) {                            // N_out = -N
            aL = aLo;
            aM = aMo;
            aN = -aNo;
        } else {
            // (Lo, Mo) = u (L, M), No = sign(N) root_r, root_r =
            // sqrt(disc_r), disc_r = 1 - (u u) (1 - N N)
            const float u = tp.u;
            aL = aLo * u;
            aM = aMo * u;
            const float ddisc = tp.ok_r
                ? div_fast(aNo * sgn(N), 2.0f * tp.root_r) : 0.0f;
            g[PW_U] += aLo * L + aMo * M - 2.0f * u * ddisc * (1.0f - N * N);
            aN = 2.0f * N * ddisc * (u * u);
        }
        aN += gcos * sgn(N);                   // cos_i = |N|
    } else {
        float dnx, dny, dnz, ddot;
        if (refl) {                            // d - 2 (d.n) n
            const float two_dot = 2.0f * tp.dot;
            aL = aLo;
            aM = aMo;
            aN = aNo;
            dnx = -aLo * two_dot;
            dny = -aMo * two_dot;
            dnz = -aNo * two_dot;
            ddot = -2.0f * (aLo * tp.nx + aMo * tp.ny + aNo * tp.nz);
        } else {                               // u d + w n
            const float u = tp.u, w = tp.w, dot = tp.dot;
            aL = aLo * u;
            aM = aMo * u;
            aN = aNo * u;
            dnx = aLo * w;
            dny = aMo * w;
            dnz = aNo * w;
            // w = sign(dot) root_r - u dot, root_r = sqrt(disc_r), disc_r =
            // 1 - (u u) (1 - dot dot)
            const float dw = aLo * tp.nx + aMo * tp.ny + aNo * tp.nz;
            ddot = -dw * u;
            const float ddisc = tp.ok_r
                ? div_fast(dw * sgn(dot), 2.0f * tp.root_r) : 0.0f;
            g[PW_U] += aLo * L + aMo * M + aNo * N - dw * dot
                       - 2.0f * u * ddisc * (1.0f - dot * dot);
            ddot += 2.0f * dot * ddisc * (u * u);
        }
        dnx += gnrm[0];
        dny += gnrm[1];
        dnz += gnrm[2];
        ddot += gcos * sgn(tp.dot);            // cos_i = |dot|
        // dot = L nx + M ny + N nz
        aL += ddot * tp.nx;
        aM += ddot * tp.ny;
        aN += ddot * tp.nz;
        dnx += ddot * L;
        dny += ddot * M;
        dnz += ddot * N;
        // (nx, ny, nz) = (dfdx, dfdy, -1) inv_n, inv_n = 1 / sn, sn =
        // sqrt(dfdx^2 + dfdy^2 + 1)
        float ddfdx = dnx * tp.inv_n;
        float ddfdy = dny * tp.inv_n;
        const float dinv_n = dnx * tp.dfdx + dny * tp.dfdy - dnz;
        const float dsum = -0.5f * dinv_n * (tp.inv_n * tp.inv_n * tp.inv_n);
        ddfdx += 2.0f * tp.dfdx * dsum;
        ddfdy += 2.0f * tp.dfdy * dsum;
        if (newton) {
            // (dfdx, dfdy) = the Newton sag's slope at (x2, y2)
            asphere_sag_adjoint(ri, conic, ac, nu_of(fl), gk == GK_ODD, x2,
                                y2, 0.0f, ddfdx, ddfdy, ax2, ay2, g[PW_RI],
                                g[PW_CONIC], da);
        } else {
            // dfdx = (x2 ri) inv_root, inv_root = 1 / sr, sr = sqrt(arg >
            // eps ? arg : 1), arg = 1 - (((1 + conic) ri) ri) r2
            const float xr = x2 * ri, yr = y2 * ri;
            const float dxr = ddfdx * tp.inv_root, dyr = ddfdy * tp.inv_root;
            const float dinv_root = ddfdx * xr + ddfdy * yr;
            ax2 += dxr * ri;
            ay2 += dyr * ri;
            g[PW_RI] += dxr * x2 + dyr * y2;
            const float darg = tp.arg > EPS_GUARD
                ? -0.5f * dinv_root * (tp.inv_root * tp.inv_root * tp.inv_root)
                : 0.0f;
            const float B = (1.0f + conic) * ri;
            const float A = B * ri;
            const float dA = -darg * tp.r2;
            const float dr2 = -darg * A;
            const float dB = dA * ri;
            g[PW_RI] += dA * B + dB * (1.0f + conic);
            g[PW_CONIC] += dB * ri;
            ax2 += 2.0f * x2 * dr2;
            ay2 += 2.0f * y2 * dr2;
        }
    }
    aL += gk0[0];
    aM += gk0[1];
    aN += gk0[2];

    // ---- the optical path: opd_out = opd + |t n1| ------------------------------
    const float dtn1 = a.opd * sgn(t * n1);
    float dt = dtn1 * n1;
    g[PW_N1] += dtn1 * t;
    // ---- propagation: (x2, y2, z2) = (x, y, z1) + t (L, M, N) ----------------
    dt += ax2 * L + ay2 * M + az2 * N;
    aL += ax2 * t;
    aM += ay2 * t;
    aN += az2 * t;
    float ax = ax2, ay = ay2, az1 = az2;

    // ---- intersection ------------------------------------------------------------
    if (newton) {
        // the live Newton step t = t_it - f / eps_guard(dd); t_it and the
        // warm start get no cotangent
        const float df = div_fast(-dt, tp.dg);
        const float ddg = -div_fast(df * tp.f, tp.dg);
        const float ddd = fabsf(tp.dd) > EPS_GUARD ? ddg : 0.0f;
        aL += ddd * tp.ngx;
        aM += ddd * tp.ngy;
        aN -= ddd;
        float dxx = 0.0f, dyy = 0.0f;
        asphere_sag_adjoint(ri, conic, ac, nu_of(fl), gk == GK_ODD, tp.xx,
                            tp.yy, df, ddd * L, ddd * M, dxx, dyy, g[PW_RI],
                            g[PW_CONIC], da);
        ax += dxx;
        ay += dyy;
        az1 -= df;
        aL += dxx * tp.t_it;
        aM += dyy * tp.t_it;
        aN -= df * tp.t_it;
    } else if (fl & FLAG_PLANE) {              // t = (-z1) / N
        const float d = div_fast(dt, N);
        az1 -= d;
        aN -= d * t;
    } else {
        // t = t0 + tq, tq = ok ? (near ? cc / eps_guard(q) : q /
        // eps_guard(a)) : 0
        const float dtq = tp.ok ? dt : 0.0f;
        const float dtn = tp.near ? dtq : 0.0f;
        const float dtf = tp.near ? 0.0f : dtq;
        float dcc = div_fast(dtn, tp.qg);
        float dq = fabsf(tp.q) > EPS_GUARD ? -dcc * tp.t_near : 0.0f;
        const float dfq = div_fast(dtf, tp.ag);
        dq += dfq;
        float da_ = fabsf(tp.a) > EPS_GUARD ? -dfq * tp.t_far : 0.0f;
        // q = -(bh + (bh >= 0 ? sq : -sq)), sq = sqrt(ok ? disc : 1), disc =
        // bh^2 - a cc
        float dbh = -dq;
        const float dsq = tp.bh >= 0.0f ? -dq : dq;
        const float ddisc = tp.ok ? div_fast(dsq, 2.0f * tp.sq) : 0.0f;
        dbh += 2.0f * tp.bh * ddisc;
        da_ -= ddisc * tp.cc;
        dcc -= ddisc * tp.a;
        // cc = (x0^2 + y0^2) ri, bh = (L x0 + M y0) ri - N, a = ((conic N) N
        // + 1) ri
        const float x0 = tp.x0, y0 = tp.y0;
        const float dss = dcc * ri;
        const float dlin = dbh * ri;
        const float dinn = da_ * ri;
        g[PW_RI] += dcc * (x0 * x0 + y0 * y0) + dbh * (L * x0 + M * y0)
                    + da_ * (conic * N * N + 1.0f);
        g[PW_CONIC] += dinn * N * N;
        const float dx0 = 2.0f * x0 * dss + dlin * L;
        const float dy0 = 2.0f * y0 * dss + dlin * M;
        aN += 2.0f * dinn * conic * N - dbh;
        aL += dlin * x0;
        aM += dlin * y0;
        // (x0, y0) = (x, y) + t0 (L, M), t0 = (-z1) / N
        ax += dx0;
        ay += dy0;
        aL += dx0 * tp.t0;
        aM += dy0 * tp.t0;
        const float d = div_fast(dt + dx0 * L + dy0 * M, N);
        az1 -= d;
        aN -= d * tp.t0;
    }

    // ---- localize: (x, L)_local = R^T ((x, L) - t); else z1 = z - pos_z -------
    if (cs) {
        const float dx0 = sub(in.x, c[17]), dy0 = sub(in.y, c[18]);
        const float dz0 = sub(in.z, c[19]);
        a.x = c[8] * ax + c[9] * ay + c[10] * az1;
        a.y = c[11] * ax + c[12] * ay + c[13] * az1;
        a.z = c[14] * ax + c[15] * ay + c[16] * az1;
        a.L = c[8] * aL + c[9] * aM + c[10] * aN;
        a.M = c[11] * aL + c[12] * aM + c[13] * aN;
        a.N = c[14] * aL + c[15] * aM + c[16] * aN;
        dcs[0] += ax * dx0 + aL * in.L;
        dcs[1] += ay * dx0 + aM * in.L;
        dcs[2] += az1 * dx0 + aN * in.L;
        dcs[3] += ax * dy0 + aL * in.M;
        dcs[4] += ay * dy0 + aM * in.M;
        dcs[5] += az1 * dy0 + aN * in.M;
        dcs[6] += ax * dz0 + aL * in.N;
        dcs[7] += ay * dz0 + aM * in.N;
        dcs[8] += az1 * dz0 + aN * in.N;
        dcs[9] -= a.x;
        dcs[10] -= a.y;
        dcs[11] -= a.z;
    } else {
        g[PW_PZ] -= az1;
        a.x = ax;
        a.y = ay;
        a.z = az1;
        a.L = aL;
        a.M = aM;
        a.N = aN;
    }
}

// The instance's body for a stack-depth bucket MAXS and NEV launch vectors:
// grid (ceil(n/256), F, W), one ray per thread; sc and sg the block's copies
// of its wavelength's constant rows and its field's gen row; the other
// parameters are gen_grad_kernel's.
template <int MAXS, int NEV>
__device__ __forceinline__ void polw_grad(
        const float* sc, const float* sg, const float* __restrict__ consts,
        const float* __restrict__ acoef, const float* __restrict__ ztab,
        const float* __restrict__ px, const float* __restrict__ py,
        const float* __restrict__ cot, float* __restrict__ part,
        float* __restrict__ dpx_wf, float* __restrict__ dpy_wf,
        const GradLayout& layout, int S, int F, int W, int C, long long n,
        int nblk, int final_prop, const PolLaunch& pl_) {
    // the per-warp sums, [NWARP][nq]
    extern __shared__ float sw[];
    const int nq = polw_nq(layout, S);
    const int f = blockIdx.y;
    const int w = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float* sums = sw + warp * nq;
    float* direct = sums + PW_NB * S;          // the layout's slots
    PolLaunch pl = pl_;
    pl.nev = NEV;
    const long long i = (long long)blockIdx.x * GBLOCK + threadIdx.x;
    // threads past the tail run a dummy ray and add 0, so that every lane
    // takes part in the warp sums
    const bool active = i < n;
    const float Px = active ? px[i] : 0.0f;
    const float Py = active ? py[i] : 0.0f;

    // ---- forward (K1 (e)'s), keeping each surface's input state and
    // E-vectors -------------------------------------------------------------------
    constexpr int NST = 6 + 3 * NEV;
    float st[MAXS][NST];
    RayState s;
    PolState ps;
    gen_prologue<OPD_PLAIN>(sg, Px, Py, s);
    polar_init(sg, s.L, s.M, s.N, s.inten, pl, ps);
    for (int k = 0; k < S; ++k) {
        st[k][0] = s.x;
        st[k][1] = s.y;
        st[k][2] = s.z;
        st[k][3] = s.L;
        st[k][4] = s.M;
        st[k][5] = s.N;
#pragma unroll
        for (int v = 0; v < NEV; ++v) {
            st[k][6 + 3 * v] = ps.e[v][0];
            st[k][7 + 3 * v] = ps.e[v][1];
            st[k][8 + 3 * v] = ps.e[v][2];
        }
        SurfTape tp;
        surface_step<VAR_WIDE, OPD_PLAIN, true>(sc + k * CONST_W,
                                                acoef + (size_t)k * C, ztab,
                                                layout.f[k], 1.0f, s, tp, &ps);
    }

    // ---- cotangents; the NaN step's transpose zeroes lost rays' ------------
    const size_t plane = (size_t)W * F * n;
    const size_t o = ((size_t)w * F + f) * n + (active ? i : 0);
    PAdj a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float gi = 0.0f;
    if (active) {
        gi = cot[6 * plane + o];
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
    // the final intensity is scale sum |E|^2; the traced one (and so the
    // absorption, the apertures and the simple coatings) gets no cotangent
    gi = 2.0f * pl.scale * gi;
    float gE[NEV][3];
#pragma unroll
    for (int v = 0; v < NEV; ++v) {
        gE[v][0] = gi * ps.e[v][0];
        gE[v][1] = gi * ps.e[v][1];
        gE[v][2] = gi * ps.e[v][2];
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

    // ---- surfaces in reverse: surface_step and polar_surface for the tape,
    // the adjoint, one butterfly for the surface's sums -------------------------
    for (int k = S - 1; k >= 0; --k) {
        const float* c = sc + k * CONST_W;
        const float* ac = acoef + (size_t)k * C;
        const int fl = layout.f[k];
        RayState in;
        in.x = st[k][0];
        in.y = st[k][1];
        in.z = st[k][2];
        in.L = st[k][3];
        in.M = st[k][4];
        in.N = st[k][5];
        in.inten = 1.0f;
        in.opd = 0.0f;
        in.opd_c = 0.0f;
        in.valid = true;
        float ein[NEV][3];
#pragma unroll
        for (int v = 0; v < NEV; ++v) {
            ein[v][0] = st[k][6 + 3 * v];
            ein[v][1] = st[k][7 + 3 * v];
            ein[v][2] = st[k][8 + 3 * v];
        }
        float gv[PW_NB], dcs[12], da[MAX_TERMS];
#pragma unroll
        for (int j = 0; j < PW_NB; ++j) gv[j] = 0.0f;
        const int nu = ncoef_of(fl);
        for (int j = 0; j < nu; ++j) da[j] = 0.0f;
        pw_adjoint<NEV>(c, ac, ztab, fl, in, ein, gE, a, gv, dcs, da);
#pragma unroll
        for (int j = 0; j < PW_NB; ++j) gv[j] = active ? gv[j] : 0.0f;
        const float v = warp_scatter_sum<PW_NB>(gv, lane);
        if ((lane & (32 / PW_NB - 1)) == 0) sums[PW_NB * k + lane / (32 / PW_NB)] = v;
        int q = layout.qoff[k] + 6 + ((fl & FLAG_COAT) ? 1 : 0);
        if (fl & FLAG_CS) {
            float v16[16];
#pragma unroll
            for (int j = 0; j < 16; ++j)
                v16[j] = (j < 12 && active) ? dcs[j < 12 ? j : 0] : 0.0f;
            const float r = warp_scatter_sum<16>(v16, lane);
            if ((lane & 1) == 0 && lane / 2 < 12) direct[q + lane / 2] = r;
            q += 12;
        }
        for (int j0 = 0; j0 < nu; j0 += 8) {
            float v8[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
                v8[j] = (j0 + j < nu && active) ? da[j0 + j < nu ? j0 + j : 0]
                                                : 0.0f;
            const float r = warp_scatter_sum<8>(v8, lane);
            if ((lane & 3) == 0 && j0 + lane / 4 < nu)
                direct[q + j0 + lane / 4] = r;
        }
    }

    // ---- prologue: (L, M, N) = (dxr, dyr, dzr) / |.|, the launch vectors
    // from them and the weight ----------------------------------------------
    const float* g = sg;
    const float x = add(mul(Px, g[0]), g[2]);
    const float y = add(mul(Py, g[1]), g[3]);
    const float z = g[4];
    const bool tele = g[10] != 0.0f;           // dxr = Px g8, dzr = g5
    const float dxr = tele ? mul(Px, g[8]) : sub(mul(Px, g[8]), x);
    const float dyr = tele ? mul(Py, g[9]) : sub(mul(Py, g[9]), y);
    const float dzr = tele ? g[5] : sub(g[5], z);
    const float smag = sqt(add(add(mul(dxr, dxr), mul(dyr, dyr)), mul(dzr, dzr)));
    const float inv_mag = dvd(1.0f, smag);
    float dw_pol = 0.0f;
    polar_init_adjoint(g, mul(dxr, inv_mag), mul(dyr, inv_mag),
                       mul(dzr, inv_mag), apod_weight(g, Px, Py), pl, gE,
                       a.L, a.M, a.N, dw_pol);
    const float dinv = a.L * dxr + a.M * dyr + a.N * dzr;
    float ddxr = a.L * inv_mag, ddyr = a.M * inv_mag, ddzr = a.N * inv_mag;
    const float dsm = -dinv * (inv_mag * inv_mag) / (2.0f * smag);
    ddxr += 2.0f * dxr * dsm;
    ddyr += 2.0f * dyr * dsm;
    ddzr += 2.0f * dzr * dsm;
    const float ax = tele ? a.x : a.x - ddxr, ay = tele ? a.y : a.y - ddyr;
    const float az = a.z - (tele ? 0.0f : ddzr);
    float dgv[PW_NGEN];
#pragma unroll
    for (int j = 0; j < PW_NGEN; ++j) dgv[j] = 0.0f;
    if (active) {
        dgv[0] = ax * Px;            // x = Px g0 + g2
        dgv[1] = ay * Py;            // y = Py g1 + g3
        dgv[2] = ax;
        dgv[3] = ay;
        dgv[4] = az;                 // z = g4
        dgv[5] = ddzr;               // dzr = g5 - z
        dgv[6] = dg6;
        dgv[7] = ddxr * Px;          // dxr = Px g8 - x
        dgv[8] = ddyr * Py;
        if (dpx_wf != nullptr) {
            float dpx = ddxr * g[8] + ax * g[0], dpy = ddyr * g[9] + ay * g[1];
            apod_adjoint(g, Px, Py, dw_pol, dpx, dpy);
            dpx_wf[o] = dpx;
            dpy_wf[o] = dpy;
        }
    }
    const float v = warp_scatter_sum<PW_NGEN>(dgv, lane);
    if ((lane & (32 / PW_NGEN - 1)) == 0)
        direct[layout.qoff[S] + lane / (32 / PW_NGEN)] = v;
    __syncthreads();

    // ---- the block's sums, the warps in order --------------------------------
    auto sum_slot = [&](int q) {
        float t = 0.0f;
        for (int j = 0; j < NWARP; ++j) t += sw[j * nq + q];
        return t;
    };
    const size_t nb = (size_t)W * F * nblk;
    const size_t b = ((size_t)w * F + f) * nblk + blockIdx.x;
    const float* cw = consts + (size_t)w * S * CONST_W;
    for (int k = threadIdx.x; k < S; k += GBLOCK) {
        const int fl = layout.f[k];
        const float n1 = cw[k * CONST_W + 3], n2 = cw[k * CONST_W + 4];
        float gs[PW_NB];
#pragma unroll
        for (int j = 0; j < PW_NB; ++j) gs[j] = sum_slot(PW_NB * k + j);
        // u = n1 / n2 and n = n2 / n1 as the forward rounds them
        const float gu = gs[PW_U], gn = gs[PW_N];
        const float u = gu != 0.0f ? dvd(n1, n2) : 0.0f;
        const float nn = gn != 0.0f ? dvd(n2, n1) : 0.0f;
        float dc[7];
        dc[0] = gs[PW_RI];
        dc[1] = gs[PW_CONIC];
        dc[2] = gs[PW_PZ];
        dc[3] = gs[PW_N1] + (gu != 0.0f ? gu / n2 : 0.0f)
                - (gn != 0.0f ? gn * nn / n1 : 0.0f);
        dc[4] = (gn != 0.0f ? gn / n1 : 0.0f)
                - (gu != 0.0f ? gu * u / n2 : 0.0f);
        dc[5] = 0.0f;                          // absorption: the intensity's
        dc[6] = 0.0f;                          // a simple coating: the same
        const int q = layout.qoff[k];
        const int nd = (fl & FLAG_COAT) ? 7 : 6;
        for (int j = 0; j < nd; ++j) part[(size_t)(q + j) * nb + b] = dc[j];
        for (int qq = q + nd; qq < layout.qoff[k + 1]; ++qq)
            part[(size_t)qq * nb + b] = sum_slot(PW_NB * S + qq);
    }
    for (int j = threadIdx.x; j < NGEN; j += GBLOCK) {
        const int qq = layout.qoff[S] + j;
        part[(size_t)qq * nb + b] = sum_slot(PW_NB * S + qq);
    }
}

// the explicit specializations: every stack-depth bucket's WIDE, plain,
// polarized instance runs polw_grad with the launch's number of vectors,
// bounded to 2 blocks of 256 per SM (128 registers)
#define POL_WIDE_GRAD_INSTANCE(MAXS_)                                         \
    template <>                                                               \
    __global__ void __launch_bounds__(GBLOCK, 2)                              \
    gen_grad_kernel<MAXS_, VAR_WIDE, OPD_PLAIN, true>(                        \
            const float* __restrict__ gen, const float* __restrict__ consts,  \
            const float* __restrict__ acoef, const float* __restrict__ ztab,  \
            const float* __restrict__ px, const float* __restrict__ py,       \
            const float* __restrict__ cot, float* __restrict__ part,          \
            float* __restrict__ dpx_wf, float* __restrict__ dpy_wf,           \
            const GradLayout layout, int S, int F, int W, int C, long long n, \
            int nblk, int final_prop, const PolLaunch pl) {                   \
        __shared__ float sc[MAXS_ * CONST_W];                                 \
        __shared__ float sg[GEN_W];                                           \
        const float* cw = consts + (size_t)blockIdx.z * S * CONST_W;          \
        for (int j = threadIdx.x; j < S * CONST_W; j += blockDim.x)           \
            sc[j] = cw[j];                                                    \
        if (threadIdx.x < GEN_W)                                              \
            sg[threadIdx.x] = gen[(size_t)blockIdx.y * GEN_W + threadIdx.x];  \
        __syncthreads();                                                      \
        if (pl.nev == 1)                                                      \
            polw_grad<MAXS_, 1>(sc, sg, consts, acoef, ztab, px, py, cot,     \
                                part, dpx_wf, dpy_wf, layout, S, F, W, C, n,  \
                                nblk, final_prop, pl);                        \
        else                                                                  \
            polw_grad<MAXS_, 2>(sc, sg, consts, acoef, ztab, px, py, cot,     \
                                part, dpx_wf, dpy_wf, layout, S, F, W, C, n,  \
                                nblk, final_prop, pl);                        \
    }
POL_WIDE_GRAD_INSTANCE(8)
POL_WIDE_GRAD_INSTANCE(16)
POL_WIDE_GRAD_INSTANCE(32)
POL_WIDE_GRAD_INSTANCE(64)
#undef POL_WIDE_GRAD_INSTANCE
