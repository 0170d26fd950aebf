"""K2's WIDE, plain-OPD, polarized instance (gen_grad_pol.cu's
gen_grad_kernel<MAXS, VAR_WIDE, OPD_PLAIN, true>) built from one or more
copies of its source, each with its own nvcc flags, side by side on one
card: for each build, what ptxas says about the instance in each
stack-depth bucket (registers, spills), its SASS opcodes counted by pipe
(the 16-surface bucket's), its gradients against the plain version on
chip_smoke.py's WIDE (e) parity cases (GRAD_TOL per slot, the pupil
cotangents against the float64 plain version with their float32 floor,
two launches bit-identical; 250k samples, the pupil centre as sample 0)
and its times (CUDA events, median of 10; ``probes/timing_ab.py`` reads
the card's busy time) at the main path's shape, the polarized double
Gauss 1 x 1 (Hy 0.7) x 4M, and on the tilted coated singlet's circular
launch 1 x 2 x 4M.

    python3 probes/k2e_variants.py [SOURCE[:FLAG,FLAG...] ...]

from the repository's root on a machine with one GPU (default: the
checkout's csrc/gen_grad_pol.cu); e.g. ``python3 probes/k2e_variants.py
_parent_tree/optiland_pr_tpu_torch/kernels/csrc/gen_grad_pol.cu
optiland_pr_tpu_torch/kernels/csrc/gen_grad_pol.cu
_probe/edited/csrc/gen_grad_pol.cu:-Xptxas,-O2``, an edited copy of csrc/
with extra nvcc flags. Each source is built with the headers of its own
directory into _probe/k2e/; name builds in A B B A order to read the
spread between them. A build whose check fails prints FAILED and goes
on."""
import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from variant_build import build, load, opcode_mix, ptxas_lines  # noqa: E402
from optiland_pr_tpu_torch.core.distributions import \
    generate_distribution  # noqa: E402
from optiland_pr_tpu_torch.core.polarization import \
    PolarizationState  # noqa: E402
from optiland_pr_tpu_torch.kernels import gen_grad as k2  # noqa: E402
from optiland_pr_tpu_torch.kernels import gen_trace as k1  # noqa: E402

SRC = "optiland_pr_tpu_torch/kernels/csrc/gen_grad_pol.cu"
# the WIDE, plain-OPD, polarized instance of a bucket, mangled
WIDE_POL = "gen_grad_kernelILi{}ELi1ELi0ELb1E"


def main(variants):
    dev = torch.device("cuda")
    f32 = torch.float32
    print(f"[k2e] {cs.card_line()}", flush=True)
    specs = [(v.split(":")[0], tuple(f for f in v.split(":")[1].split(",")
                                     if f) if ":" in v else ())
             for v in variants]
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(
            lambda a: build(a[0], a[1][0], "gen_grad_pol", "k2e", a[1][1]),
            enumerate(specs)))

    def tables(lens, fields):
        m, p = lens.build(device=dev, dtype=f32)
        wl = p["wavelengths"][m.primary_wavelength_idx:][:1]
        hy = torch.tensor(fields, dtype=f32, device=dev)
        g, c, a = k1.gen_tables(m, p, wl, torch.zeros_like(hy), hy)
        return g, c, a, k1.model_flags(m, p), k1.polar_launch(m.polarization)

    circular = PolarizationState(is_polarized=True, Ex=1.0, Ey=1.0,
                                 phase_x=0.0, phase_y=math.pi / 2)
    tilted_c = cs.tilted_coated_singlet()
    tilted_c.set_polarization(circular)
    parity = {
        "double_gauss_linear_1x3": tables(cs.polarized_double_gauss(),
                                          [0.0, 10 / 14, 1.0]),
        "tilted_coated_singlet_linear_1x2": tables(
            cs.tilted_coated_singlet(), [0.0, 1.0]),
        "tilted_coated_singlet_circular_1x2": tables(tilted_c, [0.0, 1.0]),
        "finite_relay_linear_1x2": tables(cs.finite_relay_polarized(),
                                          [0.0, 1.0])}
    timed = {"k2e_double_gauss_1x1x4M": tables(cs.polarized_double_gauss(),
                                               [0.7]),
             "k2e_tilted_circular_1x2x4M": parity[
                 "tilted_coated_singlet_circular_1x2"]}
    px1, py1 = generate_distribution("random", cs.N_PARITY, dtype=f32,
                                     device=dev)
    n_e = 250_000
    px_e, py_e = px1[:n_e].clone(), py1[:n_e].clone()
    px_e[0] = py_e[0] = 0.0
    px4, py4 = generate_distribution("random", cs.N_MAIN, dtype=f32,
                                     device=dev)
    gen_rng = torch.Generator(device=dev).manual_seed(0)
    refs = {}
    for name, (g, c, a, fl, pol) in parity.items():
        cot = torch.randn((8, 1, g.shape[0], n_e), generator=gen_rng,
                          device=dev, dtype=f32)
        ref = k2.gen_trace_bwd_plain(g, c, a, px_e, py_e, cot, fl, True,
                                     "plain", pol)
        ref64 = k2.gen_trace_bwd_plain(*(t.double() for t in (
            g, c, a, px_e, py_e, cot)), fl, True, "plain", pol)
        floor = cs.float32_floor(g, c, a, px_e, py_e, cot, fl, True, ref,
                                 "plain", pol, ref64)
        refs[name] = (cot, ref, ref64, floor)
        torch.cuda.empty_cache()
    cots = {name: torch.randn((8, 1, g.shape[0], cs.N_MAIN), device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(0))
            for name, (g, *_) in timed.items()}

    results = {}
    for i, ((src, flags), (so, log)) in enumerate(zip(specs, built)):
        tag = f"{i}:{src}{':' + ','.join(flags) if flags else ''}"
        for d in (8, 16, 32, 64):
            for line in ptxas_lines(log, WIDE_POL.format(d)):
                print(f"[k2e] {tag} depth {d} ptxas: {line}")
        print(f"[k2e] {tag} SASS by pipe (depth 16): "
              f"{opcode_mix(so, WIDE_POL.format(16))}")
        lib = load(so, "gen_grad_pol")
        k2.build_kernel = lambda name, lib=lib: lib
        for name, (g, c, a, fl, pol) in parity.items():
            cot, ref, ref64, floor = refs[name]
            try:
                got = k2.gen_trace_bwd_cuda(g, c, a, px_e, py_e, cot, fl,
                                            True, polar=pol)
                again = k2.gen_trace_bwd_cuda(g, c, a, px_e, py_e, cot, fl,
                                              True, polar=pol)
                torch.cuda.synchronize()
                cs.check(all(torch.equal(x, y) for x, y in zip(got, again)),
                         f"{name}: two runs differ")
                err = cs.compare_grads(got, ref, name, floor, per_slot=True,
                                       ref64=ref64, zero_ulps=1)
                print(f"[k2e] {tag} {name}: max |kernel - plain| {err:.3g}, "
                      f"repeat bit-identical", flush=True)
            except RuntimeError as e:
                print(f"[k2e] {tag} {name}: FAILED {e}", flush=True)
            torch.cuda.empty_cache()
        for name, (g, c, a, fl, pol) in timed.items():
            cot = cots[name]

            def fn():
                return k2.gen_trace_bwd_cuda(g, c, a, px4, py4, cot, fl, True,
                                             polar=pol)
            ms = cs.cuda_ms(fn)
            results[f"{tag} {name}"] = ms
            print(f"[k2e] {tag} {name}: {ms:.4f} ms (CUDA events)",
                  flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main(sys.argv[1:] or [SRC])
