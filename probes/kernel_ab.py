"""The SASS of two checkouts' kernels, instance by instance: every library
of kernels/csrc that both build (K1, K2 in each OPD mode and launch, K3,
K4), each kernel instance's instructions with the addresses stripped, and
whether they are identical.

    python3 probes/kernel_ab.py

from the repository's root on a machine with nvcc (no GPU is needed), with
the other checkout unpacked in _parent_tree/ (git archive <commit>); the
libraries are built into _probe/, all at once. An instance is matched by
its mangled name; one that only this checkout has is listed as new."""
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, ".")
from optiland_pr_tpu_torch.kernels import gen_trace as k1  # noqa: E402

NVCC = k1._find_nvcc()
CUOBJDUMP = str(Path(NVCC).with_name("cuobjdump"))
TREES = {"parent": Path("_parent_tree/optiland_pr_tpu_torch/kernels/csrc"),
         "change": Path("optiland_pr_tpu_torch/kernels/csrc")}


def build(tag, name):
    out = Path(f"_probe/build_{tag}")
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{name}.so"
    r = subprocess.run([NVCC, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                        "-o", str(so), str(TREES[tag] / f"{name}.cu")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return so


def sass(so):
    txt = subprocess.run([CUOBJDUMP, "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if cur and m:
            funcs[cur].append(re.sub(r"0x[0-9a-f]+", "X", m.group(1)))
    return funcs


def main():
    names = sorted(p.stem for p in TREES["change"].glob("*.cu")
                   if (TREES["parent"] / p.name).exists())
    jobs = [(tag, n) for n in names for tag in TREES]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: build(*j), jobs)))
    for name in names:
        a, b = sass(built["parent", name]), sass(built["change", name])
        same = [fn for fn in a if a[fn] == b.get(fn)]
        print(f"[sass] {name}: {len(same)} of {len(a)} instances identical, "
              f"{len(set(b) - set(a))} new")
        for fn in a:
            if fn not in b:
                print(f"[sass]   {fn[:90]}: missing in the change")
            elif a[fn] != b[fn]:
                print(f"[sass]   {fn[:90]}: {len(a[fn])} / {len(b[fn])} "
                      f"instructions, differ")


if __name__ == "__main__":
    main()
