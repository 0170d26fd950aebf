"""K2 built from one or more copies of its source, side by side on one card:
first, per narrow set at 1M and 4M samples, the rays where K1 narrow's
lost-ray mask and the plain version's differ (the bit-exact forward that
K2 recomputes); then for each build, what ptxas says about the narrow,
plain-OPD, unpolarized instance in each stack-depth bucket (registers,
spills), its SASS opcodes counted by pipe (the 8-surface bucket's), and
its gradients against the plain version on the narrow sets (chip_smoke.py's
K2 narrow checks: GRAD_TOL on the rays whose masks agree, two launches
bit-identical, the mask identity on the TIR singlet at 1M and 4M, the
distance from the float64 plain version beside the float32 plain
version's and, for the builds after a _parent_tree one, beside the
parent's), and chip_smoke.py's margin sets (``narrow_margin_check``: the
rays at the lost-ray margins of the TIR singlet and the UV lens, the mask
identity both ways, the rays that only K1 narrow keeps against the float64
plain version at the points that match K1 narrow's outputs). The times of the same instance at the main paths' shapes are
``probes/timing_ab.py``'s k2_ rows.

    python3 probes/k2_variants.py [gen_grad.cu ...]

from the repository's root on a machine with one GPU (default: the
checkout's csrc/gen_grad.cu); e.g. ``python3 probes/k2_variants.py
_parent_tree/optiland_pr_tpu_torch/kernels/csrc/gen_grad.cu
optiland_pr_tpu_torch/kernels/csrc/gen_grad.cu``. Each source is built
with the headers of its own directory into _probe/k2/. A build whose check
fails prints FAILED and goes on."""
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from variant_build import build, load, opcode_mix, ptxas_lines  # noqa: E402
from optiland_pr_tpu_torch.core.distributions import \
    generate_distribution  # noqa: E402
from optiland_pr_tpu_torch.kernels import gen_grad as k2  # noqa: E402
from optiland_pr_tpu_torch.kernels import gen_trace as k1  # noqa: E402
from optiland_pr_tpu_torch.samples import (CookeTriplet,  # noqa: E402
                                           DoubleGauss, TIRSinglet,
                                           UVProjectionLens)

SRC = "optiland_pr_tpu_torch/kernels/csrc/gen_grad.cu"
# the narrow, plain-OPD, unpolarized instance of a bucket, mangled
NARROW = "gen_grad_kernelILi{}ELi0ELi0ELb0E"


def main(variants):
    dev = torch.device("cuda")
    f32 = torch.float32
    print(f"[k2] {cs.card_line()}", flush=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(partial(build, lib="gen_grad", tag="k2"),
                              range(len(variants)), variants))

    def tables(lens, fields, all_wl, apod=None):
        m, p = lens.build(device=dev, dtype=f32)
        wl = p["wavelengths"] if all_wl else \
            p["wavelengths"][m.primary_wavelength_idx:][:1]
        hy = torch.tensor(fields, dtype=f32, device=dev)
        g, c, a = k1.gen_tables(m, p, wl, torch.zeros_like(hy), hy, apod)
        return g, c, a, k1.model_flags(m, p)

    three = [0.0, 0.7, 1.0]
    px1, py1 = generate_distribution("random", cs.N_PARITY, dtype=f32,
                                     device=dev)
    px4, py4 = generate_distribution("random", cs.N_MAIN, dtype=f32,
                                     device=dev)
    sets = {"cooke_3x3": tables(CookeTriplet(), three, True),
            "double_gauss_3x3": tables(DoubleGauss(), three, True),
            "tir_singlet_2x1": tables(TIRSinglet(), [0.0, 1.0], False),
            "uv_lens_1x3": tables(UVProjectionLens(), [0.0, 0.5, 1.0],
                                  False)}
    for name, (g, c, a, fl) in sets.items():
        for tag, px, py in (("1M", px1, py1), ("4M", px4, py4)):
            cs.grad_masks(k1, g, c, a, px, py, fl, f"{name} {tag}")
            torch.cuda.empty_cache()

    # the parity sets: (tables, pupil, the float32 floor's use)
    gen_rng = torch.Generator(device=dev).manual_seed(0)
    parity = {
        "cooke_1x1_4M": (tables(CookeTriplet(), [0.7], False), px4, py4,
                         False),
        "cooke_3x3": (sets["cooke_3x3"], px1, py1, False),
        "double_gauss_3x3": (sets["double_gauss_3x3"], px1, py1, False),
        "tir_singlet_2x1": (sets["tir_singlet_2x1"], px1, py1, False),
        "tir_singlet_2x1_4M": (sets["tir_singlet_2x1"], px4, py4, False),
        "uv_lens_1x3_250k": (sets["uv_lens_1x3"], px1[:250_000].contiguous(),
                             py1[:250_000].contiguous(), True),
        "cooke_gaussian_1x3": (tables(CookeTriplet(), three, False,
                                      cs.apodization("gaussian")), px1, py1,
                               False)}
    # the margin sets of chip_smoke.py: (tables, pupil, field per ray)
    margins = {}
    for name, key, pxv, p_max, extra in (
            ("tir_singlet_margins_2x1", "tir_singlet_2x1",
             [0.1 * j for j in range(8)], 1.0, (px4, py4)),
            ("uv_lens_margins_1x3", "uv_lens_1x3", [0.0, 0.3, 0.6], 3.0,
             None)):
        px_, py_, fld, n_m, n_out = cs.margin_set(k1, *sets[key], pxv, p_max,
                                                  extra)
        margins[name] = (sets[key], px_, py_, fld, pxv, p_max)
        print(f"[k2] {name}: {n_m} margins, {px_.shape[0]} rays, {n_out} "
              f"left out", flush=True)
    refs = {}
    for name, ((g, c, a, fl), px, py, _) in parity.items():
        shape = (8, c.shape[0], g.shape[0], px.shape[0])
        lost, keep, _ = cs.grad_masks(k1, g, c, a, px, py, fl, name)
        cot = torch.randn(shape, generator=gen_rng, device=dev, dtype=f32)
        if name.startswith("tir"):
            # chip_smoke.py's TIR cotangents: NaN on K1 narrow's lost rays'
            # masked outputs, none on the valid field or the intensity
            cot[:, :, 0] = 0.0
            cot[6] = 0.0
            for j in (0, 1, 2, 3, 4, 5, 7):
                cot[j][lost] = torch.nan
        cot_p = cot.nan_to_num(0.0)
        ref = k2.gen_trace_bwd_plain(g, c, a, px, py, cot_p, fl, True)
        refs[name] = (cot, cot_p, ref, keep,
                      lost[0, 1] if name.startswith("tir") else None)
        torch.cuda.empty_cache()

    parent = None
    for i, (variant, (so, log)) in enumerate(zip(variants, built)):
        tag = f"{i}:{variant}"
        for d in (8, 16, 32, 64):
            for line in ptxas_lines(log, NARROW.format(d)):
                print(f"[k2] {tag} depth {d} ptxas: {line}")
        print(f"[k2] {tag} SASS by pipe (depth 8): "
              f"{opcode_mix(so, NARROW.format(8))}")
        lib = load(so, "gen_grad")
        k2.build_kernel = lambda name, lib=lib: lib
        dists = {}
        for name, ((g, c, a, fl), px, py, floor) in parity.items():
            cot, cot_p, ref, keep, gone = refs[name]
            try:
                got = k2.gen_trace_bwd_cuda(g, c, a, px, py, cot, fl, True)
                again = k2.gen_trace_bwd_cuda(g, c, a, px, py, cot, fl, True)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                read = int((~torch.isfinite(got[3])).sum())
                print(f"[k2] {tag} {name}: repeat bit-identical {same}, rays "
                      f"whose NaN cotangent (K1 narrow lost them) K2 read "
                      f"{read}", flush=True)
                if name.startswith("tir"):
                    cs.grad_mask_identity(got, gone, name)
                err, dists[name] = cs.narrow_grad_check(
                    k1, k2, g, c, a, px, py, cot_p, fl, got, ref, keep, name,
                    floor, None if parent is None else parent.get(name))
                print(f"[k2] {tag} {name}: max |kernel - plain| {err:.3g}; "
                      f"float64 distance kernel / plain / bound "
                      + ", ".join(f"{k} {x:.3g} / {y:.3g} / {z:.3g}"
                                  for k, (x, y, z) in dists[name].items()),
                      flush=True)
            except RuntimeError as e:
                print(f"[k2] {tag} {name}: FAILED {e}", flush=True)
            torch.cuda.empty_cache()
        for seed, (name, ((g, c, a, fl), px, py, fld, pxv, p_max)) in \
                enumerate(margins.items(), start=2):
            try:
                cs.narrow_margin_check(k1, k2, g, c, a, fl, px, py, fld, name,
                                       seed, pxv, p_max)
            except RuntimeError as e:
                print(f"[k2] {tag} {name}: FAILED {e}", flush=True)
            torch.cuda.empty_cache()
        if "_parent_tree" in variant and parent is None:
            parent = {name: {k: x for k, (x, _, _) in d.items()}
                      for name, d in dists.items()}


if __name__ == "__main__":
    main(sys.argv[1:] or [SRC])
