"""CUDA-event times of a few earlier kernels in two checkouts, each run in
a process of its own, alternated A B B A twice: the K4 sum (the JAX
suite's Huygens geometry, 51,040 x 65,536), K3 on the DOE spectrometer's
rays (1 x 4M), K1 on the Hubble telescope 1 x 2 x 4M in the plain and
Kahan modes (WIDE) and on the zoned concentrator 1 x 3 x 4M (FREEFORM).
Each checkout builds its own libraries. The runs read a kernel alone, not
after chip_smoke.py's other phases: two checkouts whose instances are
SASS-identical should read alike here.

    python3 probes/timing_ab.py _parent_tree .

from the repository's root on a machine with one GPU; prints each run's
medians, then per kernel the mean of each checkout's runs and the second's
difference."""
import json
import subprocess
import sys

# one run: times every kernel below in the checkout given as argv[1]
RUN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from optiland_pr_tpu_torch.core.distributions import generate_distribution
from optiland_pr_tpu_torch.kernels import gen_trace as k1
from optiland_pr_tpu_torch.kernels import huygens as k4
from optiland_pr_tpu_torch.kernels import trace_conic as k3
from optiland_pr_tpu_torch.samples import HubbleTelescope
from optiland_pr_tpu_torch.system.model import field_coords
from optiland_pr_tpu_torch.trace.raygen import generate_rays

dev = torch.device("cuda")
px, py = generate_distribution("random", cs.N_MAIN, dtype=torch.float32,
                               device=dev)
out = {}


def tables(lens):
    m, p = lens.build(device=dev, dtype=torch.float32)
    fc = field_coords(p)
    hy = torch.tensor([f[1] for f in fc], dtype=torch.float32, device=dev)
    g, c, a = k1.gen_tables(m, p, p["wavelengths"][m.primary_wavelength_idx],
                            torch.zeros_like(hy), hy)
    return g, c, a, k1.model_flags(m, p)


for name, lens, mode in (("k1_hubble_1x2x4M", HubbleTelescope(), "plain"),
                         ("k1_kahan_hubble_1x2x4M", HubbleTelescope(),
                          "kahan"),
                         ("k1_concentrator_1x3x4M", cs.zoned_concentrator(),
                          "plain")):
    g, c, a, fl = tables(lens)
    out[name] = cs.cuda_ms(lambda: k1.gen_trace_cuda(g, c, a, px, py, fl,
                                                     True, mode))
m, p = cs.doe_spectrometer().build(device=dev, dtype=torch.float32)
wl = p["wavelengths"][m.primary_wavelength_idx]
rays = generate_rays(m, p, torch.zeros_like(px), torch.zeros_like(px), px,
                     py, wl)
table = torch.stack([getattr(rays, f) for f in k3.RAY_FIELDS])
c3 = k1.pack_surface_constants(m, p, wl).contiguous()
a3 = k1.pack_asphere_coeffs(m, p)
fl3 = k1.model_flags(m, p)
out["k3_doe_grating_1x4M"] = cs.cuda_ms(lambda: k3.trace_cuda(c3, a3, table,
                                                              fl3))
geo = cs.huygens_geometry(cs.HUYGENS_P256, cs.HUYGENS_I256)
f32 = torch.float32
pupil = torch.stack([torch.as_tensor(v, device=dev).to(f32)
                     for v in (geo[0], geo[1], geo[2], -geo[4], geo[3])])
image = torch.stack([torch.as_tensor(v, device=dev).to(f32)
                     for v in geo[5:8]])
out["k4_sum_51040x65536"] = cs.cuda_ms(
    lambda: k4.huygens_sum_cuda(pupil, image, float(geo[8])), reps=3)
out["card"] = cs.card_line()
print(json.dumps(out))
"""


def run(tree):
    res = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                         capture_output=True, text=True, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(a, b):
    runs = {a: [], b: []}
    for tree in (a, b, b, a, a, b, b, a):
        r = run(tree)
        print(f"{tree}: {json.dumps(r)}", flush=True)
        runs[tree].append(r)
    for key in runs[a][0]:
        if key == "card":
            continue
        ma = sum(r[key] for r in runs[a]) / len(runs[a])
        mb = sum(r[key] for r in runs[b]) / len(runs[b])
        print(f"{key}: {a} {ma:.4f} ms, {b} {mb:.4f} ms ({mb / ma - 1:+.1%}); "
              f"{a} {[round(r[key], 4) for r in runs[a]]}, "
              f"{b} {[round(r[key], 4) for r in runs[b]]}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
