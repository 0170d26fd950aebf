"""K1 built from one or more copies of its source, side by side on one card:
for each build, what ptxas says about the narrow, plain-OPD, unpolarized
instance (registers, spills), its SASS opcodes counted by pipe, its outputs
against the plain version (chip_smoke.py's K1 narrow contract on the Cooke
triplet 3 x 3, the double Gauss 3 x 3, the TIR singlet 1 x 2 and the UV
lens 1 x 3 at 1M samples) and its times at the main paths' shapes (CUDA
events, median of 10, and the card's busy time of one call under
torch.profiler): the Cooke triplet and the double Gauss 3 x 3 x 4M, the UV
lens 1 x 3 x 4M, Adam (ii)'s Cooke shape (1 field x 3 wavelengths x 4M)
and the Gaussian-apodized Cooke triplet 3 x 3 x 4M.

    python3 probes/k1_variants.py [gen_trace.cu ...]

from the repository's root on a machine with one GPU (default: the
checkout's csrc/gen_trace.cu). Each source is built with the headers of its
own directory (a copy of csrc/, or _parent_tree's); name one source twice,
in A B B A order, to read the spread between builds. A parent's source
whose narrow instance is bit-equal passes the contract too. The libraries
are built into _probe/k1/."""
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from variant_build import build, load, opcode_mix, ptxas_lines  # noqa: E402
from optiland_pr_tpu_torch.core.distributions import \
    generate_distribution  # noqa: E402
from optiland_pr_tpu_torch.kernels import gen_trace as k1  # noqa: E402
from optiland_pr_tpu_torch.samples import (CookeTriplet,  # noqa: E402
                                           DoubleGauss, TIRSinglet,
                                           UVProjectionLens)

SRC = Path("optiland_pr_tpu_torch/kernels/csrc/gen_trace.cu")
# in the narrow, plain-OPD, unpolarized instance's mangled name
NARROW = "gen_trace_kernelILi0ELi0ELb0E"


def main(variants):
    dev = torch.device("cuda")
    f32 = torch.float32
    print(f"[k1] {cs.card_line()}", flush=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(partial(build, lib="gen_trace", tag="k1"),
                              range(len(variants)), variants))

    def tables(lens, fields, all_wl, apod=None):
        m, p = lens.build(device=dev, dtype=f32)
        wl = p["wavelengths"] if all_wl else \
            p["wavelengths"][m.primary_wavelength_idx:][:1]
        hy = torch.tensor(fields, dtype=f32, device=dev)
        g, c, a = k1.gen_tables(m, p, wl, torch.zeros_like(hy), hy, apod)
        return g, c, a, k1.model_flags(m, p)

    three = [0.0, 0.7, 1.0]
    parity = [("cooke_3x3", tables(CookeTriplet(), three, True), None),
              ("double_gauss_3x3", tables(DoubleGauss(), three, True), None),
              ("tir_singlet_2x1", tables(TIRSinglet(), [0.0, 1.0], False),
               None),
              ("uv_lens_1x3", tables(UVProjectionLens(), [0.0, 0.5, 1.0],
                                     False), cs.UV_K1_TOL)]
    timed = [("k1_cooke_3x3x4M", parity[0][1]),
             ("k1_double_gauss_3x3x4M", parity[1][1]),
             ("k1_uv_lens_1x3x4M", parity[3][1]),
             ("k1_cooke_1x3x4M", tables(CookeTriplet(), [0.7], True)),
             ("k1_cooke_gaussian_3x3x4M",
              tables(CookeTriplet(), three, True, cs.apodization("gaussian")))]
    px1, py1 = generate_distribution("random", cs.N_PARITY, dtype=f32,
                                     device=dev)
    px4, py4 = generate_distribution("random", cs.N_MAIN, dtype=f32,
                                     device=dev)
    results = {}
    for i, (variant, (so, log)) in enumerate(zip(variants, built)):
        tag = f"{i}:{variant}"
        for line in ptxas_lines(log, NARROW):
            print(f"[k1] {tag} ptxas: {line}")
        print(f"[k1] {tag} SASS by pipe: {opcode_mix(so, NARROW)}")
        lib = load(so, "gen_trace")
        k1.build_kernel = lambda name, lib=lib: lib
        for name, (g, c, a, fl), tol in parity:
            try:
                _, err, lost, line = cs.narrow_contract(
                    k1, g, c, a, px1, py1, fl, name, tol=tol)
                print(f"[k1] {tag} {name}: lost {lost:.6f}, {line}")
            except RuntimeError as e:
                print(f"[k1] {tag} {name}: FAILED {e}")
        for name, (g, c, a, fl) in timed:
            def fn():
                return k1.gen_trace_cuda(g, c, a, px4, py4, fl, True)
            ms = cs.cuda_ms(fn)
            _, busy, _ = cs.device_profile(fn)
            results[f"{tag} {name}"] = ms
            print(f"[k1] {tag} {name}: {ms:.4f} ms (CUDA events), card busy "
                  f"{busy} ms", flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main(sys.argv[1:] or [str(SRC)])
