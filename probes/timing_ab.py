"""CUDA-event times of a few kernels in two checkouts, each run in a process
of its own, alternated A B B A (twice by default): the K4 sum (the JAX
suite's Huygens geometry, 51,040 x 65,536), the Fresnel K4 on the Cooke
triplet's HuygensPSF tables at (0, 1) (the 256/256 and 128/128 grids and
each size's one-point normalization) and on its HuygensMTF tables at the
first field (the 128 x 128 grid of a few thousand pupil samples and its
one-point normalization), for K4 also the card's busy time of one call
under torch.profiler ("_device", which leaves out the host's share that a
short launch's CUDA-event time carries) and the second pass's part of it
("_second_pass", 0 in a checkout without one), HuygensPSF of the Cooke
triplet at (0, 1), 256/256, end to end on the host clock (synced), K3 on
the DOE spectrometer's rays (1 x 4M), K1 on the Hubble telescope 1 x 2 x
4M in the plain and Kahan modes (WIDE) and on the zoned concentrator 1 x
3 x 4M (FREEFORM). Each checkout builds its own libraries. The runs read
a kernel alone, not after chip_smoke.py's other phases: two checkouts
whose instances are SASS-identical should read alike here.

    python3 probes/timing_ab.py _parent_tree . [PREFIX ...] [--rounds N]

from the repository's root on a machine with one GPU; with PREFIXes only
the kernels whose names start with one of them (e.g. k4_); N rounds of A B
B A (default 2). Prints each run's medians, then per kernel the mean of
each checkout's runs and the second's difference."""
import json
import subprocess
import sys

# one run, in the checkout that is its working directory: times the kernels
# below whose names start with one of its arguments (all without any)
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
want = sys.argv[1:]
out = {}


# the card's busy time per call of fn over n calls under torch.profiler,
# and the second pass's (huygens_finish) part of it (None, None if three
# tries record no device activity)
def device_ms(fn, n=5):
    for _ in range(3):
        _, busy, top = cs.device_profile(lambda: [fn() for _ in range(n)])
        if busy is not None:
            return busy / n, sum(t for name, t, _ in top
                                 if "huygens_finish" in name) / n
    return None, None


def time_k4(key, fn, reps):
    out[key] = cs.cuda_ms(fn, reps=reps)
    out[key + "_device"], out[key + "_second_pass"] = device_ms(fn)


def wanted(prefix):
    return not want or any(w.startswith(prefix) or prefix.startswith(w)
                           for w in want)


px, py = generate_distribution("random", cs.N_MAIN, dtype=torch.float32,
                               device=dev)


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
    if not wanted(name):
        continue
    g, c, a, fl = tables(lens)
    out[name] = cs.cuda_ms(lambda: k1.gen_trace_cuda(g, c, a, px, py, fl,
                                                     True, mode))
if wanted("k3_doe_grating_1x4M"):
    m, p = cs.doe_spectrometer().build(device=dev, dtype=torch.float32)
    wl = p["wavelengths"][m.primary_wavelength_idx]
    rays = generate_rays(m, p, torch.zeros_like(px), torch.zeros_like(px),
                         px, py, wl)
    table = torch.stack([getattr(rays, f) for f in k3.RAY_FIELDS])
    c3 = k1.pack_surface_constants(m, p, wl).contiguous()
    a3 = k1.pack_asphere_coeffs(m, p)
    fl3 = k1.model_flags(m, p)
    out["k3_doe_grating_1x4M"] = cs.cuda_ms(
        lambda: k3.trace_cuda(c3, a3, table, fl3))
f32 = torch.float32
if wanted("k4_sum_51040x65536"):
    geo = cs.huygens_geometry(cs.HUYGENS_P256, cs.HUYGENS_I256)
    pupil = torch.stack([torch.as_tensor(v, device=dev).to(f32)
                         for v in (geo[0], geo[1], geo[2], -geo[4], geo[3])])
    image = torch.stack([torch.as_tensor(v, device=dev).to(f32)
                         for v in geo[5:8]])
    time_k4("k4_sum_51040x65536",
            lambda: k4.huygens_sum_cuda(pupil, image, float(geo[8])), 3)
for size in (256, 128):
    if not wanted(f"k4_fresnel_{size}"):
        continue
    from optiland_pr_tpu_torch.analysis import HuygensPSF
    from optiland_pr_tpu_torch.samples import CookeTriplet
    with cs.capture_fresnel(k4) as seen:
        HuygensPSF(CookeTriplet(), (0.0, 1.0), 0.55, num_rays=size,
                   image_size=size)
    for key, args in ((f"k4_fresnel_{size}", seen[0]),
                      (f"k4_fresnel_{size}_one_point", seen[1])):
        fr, im = k4.rereference(*args[:8], args[8], args[9], f32)
        kk = float(args[8])
        time_k4(key, lambda: k4.fresnel_sum_cuda(fr, im, kk),
                3 if size == 256 else cs.REPS)
if wanted("k4_fresnel_mtf"):
    from optiland_pr_tpu_torch.analysis import HuygensMTF
    from optiland_pr_tpu_torch.samples import CookeTriplet
    with cs.capture_fresnel(k4) as seen:
        HuygensMTF(CookeTriplet())
    for key, args in (("k4_fresnel_mtf", seen[0]),
                      ("k4_fresnel_mtf_one_point", seen[1])):
        fr, im = k4.rereference(*args[:8], args[8], args[9], f32)
        kk = float(args[8])
        out[key + "_shape"] = [fr.shape[1], im.shape[1]]
        time_k4(key, lambda: k4.fresnel_sum_cuda(fr, im, kk), cs.REPS)
if wanted("k4_huygens_psf_256"):
    from optiland_pr_tpu_torch.analysis import HuygensPSF
    from optiland_pr_tpu_torch.samples import CookeTriplet
    # the host clock around the whole call, synced: both K4 launches, the
    # split K1 wavefront and the host's work around them
    out["k4_huygens_psf_256"] = cs.host_ms(
        lambda: HuygensPSF(CookeTriplet(), (0.0, 1.0), 0.55, num_rays=256,
                           image_size=256).psf, reps=5)
out["card"] = cs.card_line()
print(json.dumps(out))
"""


def run(tree, prefixes):
    res = subprocess.run([sys.executable, "-c", RUN, *prefixes], cwd=tree,
                         capture_output=True, text=True, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(a, b, prefixes=(), rounds=2):
    runs = {a: [], b: []}
    for tree in (a, b, b, a) * rounds:
        r = run(tree, prefixes)
        print(f"{tree}: {json.dumps(r)}", flush=True)
        runs[tree].append(r)
    for key in runs[a][0]:
        if key == "card" or key.endswith("_shape") \
                or any(r[key] is None for r in runs[a] + runs[b]):
            continue
        ma = sum(r[key] for r in runs[a]) / len(runs[a])
        mb = sum(r[key] for r in runs[b]) / len(runs[b])
        rel = f"{mb / ma - 1:+.1%}" if ma else "new"
        print(f"{key}: {a} {ma:.4f} ms, {b} {mb:.4f} ms ({rel}); "
              f"{a} {[round(r[key], 4) for r in runs[a]]}, "
              f"{b} {[round(r[key], 4) for r in runs[b]]}")


if __name__ == "__main__":
    args = sys.argv[1:]
    n = 2
    if "--rounds" in args:
        i = args.index("--rounds")
        n = int(args[i + 1])
        del args[i:i + 2]
    main(args[0], args[1], args[2:], n)
