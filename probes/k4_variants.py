"""K4 built from one or more copies of its source, side by side on one
card: for each build, what ptxas says (registers, spills), the SASS
opcodes of each kernel instance counted by pipe, both forms against their
plain versions (1e-4 x the peak, two runs bit-identical) and times at the
launched shapes (CUDA events around one call, as chip_smoke.py times; the
card's busy time of one call under torch.profiler, with each kernel's
part of it, the second pass's included; the wrapper's host time per
call): the sum form on the JAX suite's geometry at 51,040 x 65,536, the
Fresnel form on the Cooke triplet's HuygensPSF tables at (0, 1), 256/256
and 128/128, and each size's one-point normalization.

    python3 probes/k4_variants.py [SOURCE.cu ...]

from the repository's root on a machine with one GPU (default: the
checkout's csrc/huygens.cu). Each source must export the checkout's
huygens_* functions; name one source twice, in A B B A order, to read the
spread between builds. The libraries are built into _probe/k4/."""
import collections
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from optiland_pr_tpu_torch.kernels import gen_trace as k1  # noqa: E402
from optiland_pr_tpu_torch.kernels import huygens as k4  # noqa: E402

NVCC = k1._find_nvcc()
CUOBJDUMP = str(Path(NVCC).with_name("cuobjdump"))
SRC = Path("optiland_pr_tpu_torch/kernels/csrc/huygens.cu")
PIPES = {"MUFU": "mufu", "F2F": "conv", "F2I": "conv", "I2F": "conv",
         "FRND": "conv", "DFMA": "fp64", "DADD": "fp64", "DMUL": "fp64",
         "DSETP": "fp64", "LDS": "lds", "LDG": "ldg", "BRA": "branch",
         "BSSY": "branch", "BSYNC": "branch"}


def build(i, src):
    """The library of source ``src``, the ``i``-th of the command line."""
    out = Path("_probe/k4")
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"huygens_{i}_{Path(src).stem}.so"
    r = subprocess.run([NVCC, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                        "-Xcompiler", "-fPIC", "-o", str(so), str(src)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return so, r.stderr


def opcode_mix(so):
    txt = subprocess.run([CUOBJDUMP, "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    mix, cur = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            mix[cur] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if cur and m:
            op = m.group(1)
            mix[cur][PIPES.get(op, "fp32" if op.startswith("F")
                               else "other")] += 1
    return mix


def load(so):
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes, restype in k1._SIGNATURES["huygens"]:
        f = getattr(lib, fn_name)
        f.argtypes, f.restype = argtypes, restype
    return lib


def main(variants):
    dev = torch.device("cuda")
    f32 = torch.float32
    print(f"[k4] {cs.card_line()}", flush=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build, range(len(variants)), variants))
    # the inputs: (name, form, pupil, image, k)
    geo = cs.huygens_geometry(cs.HUYGENS_P256, cs.HUYGENS_I256)
    sets = [("sum_jax_51040x65536", "sum", torch.stack(
        [torch.as_tensor(v, device=dev).to(f32)
         for v in (geo[0], geo[1], geo[2], -geo[4], geo[3])]),
        torch.stack([torch.as_tensor(v, device=dev).to(f32)
                     for v in geo[5:8]]), float(geo[8]))]
    from optiland_pr_tpu_torch.analysis import HuygensPSF
    from optiland_pr_tpu_torch.samples import CookeTriplet
    for size in (256, 128):
        with cs.capture_fresnel(k4) as seen:
            HuygensPSF(CookeTriplet(), (0.0, 1.0), 0.55, num_rays=size,
                       image_size=size)
        for tag, args in (("", seen[0]), ("_one_point", seen[1])):
            fr, im = k4.rereference(*args[:8], args[8], args[9], f32)
            sets.append((f"fresnel_cooke_{size}{tag}", "fresnel", fr, im,
                         float(args[8])))
    refs = {}
    for name, form, pupil, image, kk in sets:
        refs[name] = (k4.huygens_sum_plain(*pupil, *image, kk)
                      if form == "sum" else
                      k4.fresnel_sum_plain(pupil, image, kk))
    torch.cuda.synchronize()
    results = {}
    for i, (variant, (so, log)) in enumerate(zip(variants, built)):
        tag = f"{i}:{variant}"
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"[k4] {tag} ptxas: {line.strip()}")
        for fn_name, mix in opcode_mix(so).items():
            print(f"[k4] {tag} {fn_name}: {dict(sorted(mix.items()))}")
        k4.build_kernel = lambda name, lib=load(so): lib
        k4._OCCUPANCY.clear()
        for name, form, pupil, image, kk in sets:
            fn = k4.huygens_sum_cuda if form == "sum" else k4.fresnel_sum_cuda
            got, again = fn(pupil, image, kk), fn(pupil, image, kk)
            torch.cuda.synchronize()
            ref = refs[name]
            err = float((got - ref).abs().max() / ref.max())
            ms = cs.cuda_ms(lambda: fn(pupil, image, kk),
                            reps=3 if image.shape[1] > 20_000 else cs.REPS)
            _, busy, top = cs.device_profile(lambda: fn(pupil, image, kk))
            t0 = time.perf_counter()
            for _ in range(20):
                fn(pupil, image, kk)
            host_us = (time.perf_counter() - t0) / 20 * 1e6
            torch.cuda.synchronize()
            ok = torch.equal(got, again) and err <= 1e-4
            results[f"{tag} {name}"] = ms
            print(f"[k4] {tag} {name}: {ms:.4f} ms (CUDA events), device "
                  f"busy {busy} ms "
                  f"{[(n.split('(')[0], t) for n, t, _ in top]}, "
                  f"wrapper {host_us:.1f} us per call "
                  f"(host), lanes {fn.last_lanes}, segments "
                  f"{fn.last_splits}, slots "
                  f"{k4._OCCUPANCY[(pupil.device.index, form == 'fresnel')]}"
                  f", |kernel - plain| {err:.3g} x the peak, "
                  f"{'ok' if ok else 'FAILED'}", flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main(sys.argv[1:] or [str(SRC)])
