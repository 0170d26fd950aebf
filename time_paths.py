#!/usr/bin/env python3
"""Host-clock times of two end-to-end paths of the PyTorch port on one
NVIDIA GPU, for comparing checkouts of the repo on the same card:

    python3 time_paths.py [--rounds 5] ROOT [ROOT ...]

The paths are the two that chip_smoke.py's phase 6 times end to end, with
its own helpers and repeats (the median of 3 runs after a warm-up, each
ending in a sync): the Cooke triplet's ``Wavefront`` over 3 fields x 3
wavelengths at 4,005,541 hexapolar samples (K1's split mode), and one
value-and-grad step of the bench merit at 4M samples (K1 and K2). Each
ROOT is a checkout whose ``optiland_pr_tpu_torch`` is timed, in a process
of its own that imports the package from there and builds its kernels at
first use. A round runs every ROOT once, in the given order on even
rounds and in reverse on odd ones, so two ROOTs alternate A B B A ...; one
JSON line per process, then one per ROOT with the median, min and max of
each path over the rounds, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def time_one(root: str) -> dict:
    """Both paths' times in ms with the package under ``root``."""
    import chip_smoke as cs               # this checkout's helpers
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import optiland_pr_tpu_torch
    from optiland_pr_tpu_torch.analysis import Wavefront
    from optiland_pr_tpu_torch.core.distributions import generate_distribution
    from optiland_pr_tpu_torch.samples import CookeTriplet
    from optiland_pr_tpu_torch.trace.engine import final_rays

    pkg = os.path.dirname(os.path.abspath(optiland_pr_tpu_torch.__file__))
    assert os.path.dirname(pkg) == os.path.abspath(root), pkg
    dev, f32 = torch.device("cuda"), torch.float32

    def opd_rms(d):
        valid = d.intensity > 0
        return torch.sqrt(torch.sum(torch.where(valid, d.opd**2, 0.0))
                          / torch.clamp(torch.sum(valid), min=1))

    def wavefront_call():
        wf = Wavefront(CookeTriplet(), fields="all", wavelengths="all",
                       num_rays=cs.WF_RINGS, distribution="hexapolar",
                       dtype=f32)
        return [opd_rms(d) for d in wf.data.values()]

    model, params = CookeTriplet().build(device=dev, dtype=f32)
    leaves = []

    def grad_tree(p):
        if isinstance(p, dict):
            return {k: grad_tree(v) for k, v in p.items()}
        if isinstance(p, list):
            return [grad_tree(v) for v in p]
        t = p.detach().clone().requires_grad_(p.is_floating_point())
        if t.requires_grad:
            leaves.append(t)
        return t
    pg = grad_tree(params)

    def vg_step():
        px, py = generate_distribution("random", cs.N_MAIN, dtype=f32,
                                       device=dev)
        rays = final_rays(model, pg, 0.0, 0.7, 0.55, px, py,
                          final_prop=True)
        torch.autograd.grad(cs.masked_rms(rays.x, rays.y), leaves,
                            allow_unused=True)

    ms_wf = cs.host_ms(wavefront_call, reps=3)
    torch.cuda.empty_cache()
    ms_step = cs.host_ms(vg_step, reps=3)
    return {"root": root, "wavefront_ms": ms_wf, "merit_step_ms": ms_step}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--one", action="store_true",
                    help="time the single ROOT in this process")
    args = ap.parse_args()
    if args.one:
        import torch
        if not torch.cuda.is_available():
            print("time_paths: needs an NVIDIA GPU", file=sys.stderr)
            return 1
        print(json.dumps(time_one(args.roots[0])), flush=True)
        return 0

    import chip_smoke as cs
    runs = {r: [] for r in args.roots}
    for i in range(args.rounds):
        for root in args.roots if i % 2 == 0 else args.roots[::-1]:
            out = subprocess.run([sys.executable, os.path.join(
                HERE, "time_paths.py"), "--one", root], cwd=HERE,
                capture_output=True, text=True)
            if out.returncode != 0:
                sys.stderr.write(out.stdout + out.stderr)
                return out.returncode
            res = json.loads(out.stdout.strip().splitlines()[-1])
            res["round"] = i
            print(json.dumps(res), flush=True)
            runs[root].append(res)
    card = cs.card_line()
    for root, rs in runs.items():
        summary = {"root": root, "card": card, "rounds": len(rs)}
        for key in ("wavefront_ms", "merit_step_ms"):
            v = [r[key] for r in rs]
            summary[key] = {"median": statistics.median(v), "min": min(v),
                            "max": max(v), "runs": v}
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
