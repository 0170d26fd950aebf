"""K2 with and without the diffractive adjoint (sub-slice (f)) compiled in,
on the K2 cells of the earlier sub-slices: the same gen_grad.cu built as
``gen_grad`` (WITH_DOE 0, what those systems launch) and as
``gen_grad_doe`` (WITH_DOE 1, what one shared K2 for every system would
be), timed on the same inputs in one process, alternated A B B A, with
CUDA events; the gradients of both compared bit for bit; each library's
registers and spills per instance from ptxas.

    python3 probes/k2_doe_shared.py [rounds]

from the repository's root on a machine with one CUDA card and nvcc."""
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from optiland_pr_tpu_torch.core.distributions import \
    generate_distribution  # noqa: E402
from optiland_pr_tpu_torch.kernels import gen_grad as k2  # noqa: E402
from optiland_pr_tpu_torch.kernels import gen_trace as k1  # noqa: E402
from optiland_pr_tpu_torch.samples import (AsphericSinglet,  # noqa: E402
                                           CookeTriplet, HubbleTelescope)

N = 4 * 1024 * 1024
LIBS = {"plain": ("gen_grad", "gen_grad_doe"),
        "kahan": ("gen_grad_kahan", "gen_grad_doe_kahan")}


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    dev = torch.device("cuda")
    f32 = torch.float32
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}")
    k1.build_kernels()
    libs = {n for pair in LIBS.values() for n in pair}
    for line in cs.ptxas_variants({n: k1.BUILD_LOG.get(n, "") for n in libs},
                                  {}):
        print(f"[regs] {line}")
    px, py = generate_distribution("random", N, dtype=f32, device=dev)
    rng = torch.Generator(device=dev).manual_seed(5)
    cells = [("cooke_1x1_4M", CookeTriplet(), [0.7], "plain"),
             ("hubble_2x1_4M", HubbleTelescope(), [0.0, 1.0], "plain"),
             ("aspheric_singlet_1x1_4M", AsphericSinglet(), [0.0], "plain"),
             ("aspheric_singlet_1x1_4M_kahan", AsphericSinglet(), [0.0],
              "kahan"),
             ("chebyshev_singlet_1x1_4M", cs.freeform_singlet(
                 "cheb", fields=(0,)), [0.0], "plain"),
             ("qbfs_singlet_1x1_4M", cs.freeform_singlet(
                 "qbfs", fields=(0,)), [0.0], "plain")]
    forced = {}
    k2.grad_lib = lambda mode, polar, doe: forced["lib"]
    for name, lens, fields, mode in cells:
        model, params = lens.build(device=dev, dtype=f32)
        wl = params["wavelengths"][model.primary_wavelength_idx]
        hy = torch.tensor(fields, dtype=f32, device=dev)
        gen, consts, acoef = k1.gen_tables(model, params, wl,
                                           torch.zeros_like(hy), hy)
        flags = k1.model_flags(model, params)
        cot = torch.randn((8, consts.shape[0], gen.shape[0], N),
                          generator=rng, device=dev, dtype=f32)
        outs, times = {}, {lib: [] for lib in LIBS[mode]}
        before = dict(k2.gen_trace_bwd_cuda.launches_by_variant)

        def run(lib):
            forced["lib"] = lib
            return k2.gen_trace_bwd_cuda(gen, consts, acoef, px, py, cot,
                                         flags, True, opd_mode=mode)
        for lib in LIBS[mode]:
            outs[lib] = run(lib)
        variant = [v for v, n in k2.gen_trace_bwd_cuda.launches_by_variant
                   .items() if n > before[v]]
        a, b = LIBS[mode]
        for _ in range(rounds):
            for lib in (a, b, b, a):
                times[lib].append(cs.cuda_ms(lambda: run(lib), reps=10))
        same = all(torch.equal(x, y) for x, y in zip(outs[a], outs[b]))
        ma, mb = (statistics.median(times[lib]) for lib in (a, b))
        print(f"[k2] {name} ({'/'.join(variant)}, {mode}): {a} "
              f"{ma:.4f} ms {[round(t, 4) for t in times[a]]}, {b} "
              f"{mb:.4f} ms {[round(t, 4) for t in times[b]]}, "
              f"{b}/{a} {mb / ma:.4f}, gradients bit-identical {same} "
              f"| {card}")
        del cot, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
