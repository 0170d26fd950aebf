"""What the variant probes (k1_variants.py, k2_variants.py,
k2e_variants.py, k4_variants.py) share: building one library of
kernels/csrc from a copy of its source with nvcc (ptxas's report kept),
reading ptxas's lines and the SASS opcodes of a kernel by pipe
(cuobjdump), and loading the library with the wrapper's signatures.

Run on a machine with nvcc, from the repository's root."""
import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, ".")
from optiland_pr_tpu_torch.kernels import gen_trace as k1  # noqa: E402

NVCC = k1._find_nvcc()
CUOBJDUMP = str(Path(NVCC).with_name("cuobjdump"))
# the pipe of each SASS opcode counted apart; other opcodes starting with F
# are fp32, the rest other
PIPES = {"MUFU": "mufu", "F2F": "conv", "F2I": "conv", "I2F": "conv",
         "FRND": "conv", "DFMA": "fp64", "DADD": "fp64", "DMUL": "fp64",
         "DSETP": "fp64", "LDS": "lds", "STS": "sts", "LDG": "ldg",
         "STG": "stg", "LDL": "local", "STL": "local", "SHFL": "shfl",
         "BRA": "branch", "BSSY": "branch", "BSYNC": "branch",
         "CALL": "branch", "RET": "branch"}


def build(i, src, lib, tag, flags=()):
    """The library ``lib`` of source ``src``, the ``i``-th of a probe's
    command line, built into _probe/<tag>/ with the extra nvcc ``flags``
    (e.g. -D macros); returns (the .so's path, ptxas's report)."""
    out = Path("_probe") / tag
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{lib}_{i}.so"
    r = subprocess.run([NVCC, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xptxas", "-v", *flags,
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
                        str(src)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return so, r.stderr


def opcode_mixes(so):
    """{kernel's mangled name: its SASS opcodes counted by pipe, with
    "all"} for every kernel in ``so``."""
    txt = subprocess.run([CUOBJDUMP, "-sass", str(so)], capture_output=True,
                         text=True, check=True).stdout
    mixes, cur = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            mixes[cur] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if cur and m:
            op = m.group(1)
            mixes[cur][PIPES.get(op, "fp32" if op.startswith("F")
                                 else "other")] += 1
            mixes[cur]["all"] += 1
    return {k: dict(sorted(v.items())) for k, v in mixes.items()}


def opcode_mix(so, name):
    """The SASS opcodes of the kernels of ``so`` whose mangled names hold
    ``name``, counted by pipe."""
    total = collections.Counter()
    for fn, mix in opcode_mixes(so).items():
        if name in fn:
            total.update(mix)
    return dict(sorted(total.items()))


def ptxas_lines(log, name):
    """ptxas's lines (registers, spills) about the kernels whose mangled
    names hold ``name``."""
    lines, on = [], False
    for line in log.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            on = name in line
        if on and ("Used" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def load(so, lib):
    """The library at ``so`` with the signatures of the wrapper's library
    ``lib`` (gen_trace.py's _SIGNATURES)."""
    handle = ctypes.CDLL(str(so))
    for fn_name, argtypes, restype in k1._SIGNATURES[lib]:
        f = getattr(handle, fn_name)
        f.argtypes, f.restype = argtypes, restype
    return handle
