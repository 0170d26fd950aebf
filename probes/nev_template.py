"""K1 (e) with n_ev a compile-time 1 against gen_trace_pol.cu's runtime
n_ev, on the linear launches of the polarized double Gauss (1 x 3 x 4M)
and the coated doublet (1 x 2 x 4M): the outputs compared, CUDA-event
times alternated over 4 rounds.

    python3 probes/nev_template.py

from the repository's root on a machine with one GPU and nvcc; the
compile-time variant is a copy of csrc/ under _probe/ with the launch's
n_ev replaced by 1."""
import ctypes, shutil, subprocess, sys
from pathlib import Path
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from optiland_pr_tpu_torch.kernels import gen_trace as k1
from optiland_pr_tpu_torch.core.distributions import generate_distribution
src = Path("optiland_pr_tpu_torch/kernels/csrc"); dst = Path("_probe/csrc_nev1")
shutil.rmtree(dst, ignore_errors=True); shutil.copytree(src, dst)
for name in ("gen_trace_common.cuh", "gen_trace.cu"):
    p = dst / name
    t = p.read_text().replace("ps->nev", "1").replace("pl.nev", "1")
    p.write_text(t)
lib_path = dst / "gen_trace_pol_nev1.so"
res = subprocess.run([k1._find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                      "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(dst / "gen_trace_pol.cu")],
                     capture_output=True, text=True)
print(res.returncode, "\n".join(l for l in res.stderr.splitlines() if "Used" in l or "spill" in l))
lib1 = ctypes.CDLL(str(lib_path))
f = lib1.gen_trace_launch; f.argtypes, f.restype = k1._SIGNATURES["gen_trace_pol"][0][1:]
dev = torch.device("cuda"); f32 = torch.float32
px, py = generate_distribution("random", 4_000_000, dtype=f32, device=dev)
def run(lib, gen, consts, acoef, flags, polar, out):
    W, S = consts.shape[:2]; F = gen.shape[0]; n = px.shape[0]
    words = (ctypes.c_int32 * S)(*k1._flag_words(flags))
    err = lib.gen_trace_launch(gen.data_ptr(), consts.data_ptr(), acoef.data_ptr(), k1.zernike_table(dev).data_ptr(),
                               px.data_ptr(), py.data_ptr(), out.data_ptr(), ctypes.addressof(words), S, F, W, acoef.shape[1], n,
                               1, 0, k1.polar_words(polar), torch.cuda.current_stream().cuda_stream, None)
    assert err == 0
for name, build, fields in (("double_gauss 1x3x4M", cs.polarized_double_gauss, [0.0, 10 / 14, 1.0]),
                            ("doublet 1x2x4M", cs.polarized_doublet, [0.0, 1.0])):
    m, p = build().build(device=dev, dtype=f32)
    hy = torch.tensor(fields, dtype=f32, device=dev)
    gen, consts, acoef = k1.gen_tables(m, p, p["wavelengths"][:1], torch.zeros_like(hy), hy)
    flags = k1.model_flags(m, p); polar = k1.polar_launch(m.polarization)
    out_a = torch.empty((8, 1, len(fields), px.shape[0]), device=dev); out_b = torch.empty_like(out_a)
    lib0 = k1.build_kernel("gen_trace_pol")
    run(lib0, gen, consts, acoef, flags, polar, out_a); run(lib1, gen, consts, acoef, flags, polar, out_b)
    torch.cuda.synchronize()
    same = torch.equal(out_a.nan_to_num(), out_b.nan_to_num())
    t = {"runtime n_ev": [], "n_ev = 1 at compile time": []}
    for rnd in range(4):
        for key, lib in ((("runtime n_ev", lib0), ("n_ev = 1 at compile time", lib1)) if rnd % 2 == 0 else
                         (("n_ev = 1 at compile time", lib1), ("runtime n_ev", lib0))):
            t[key].append(cs.cuda_ms(lambda: run(lib, gen, consts, acoef, flags, polar, out_a)))
    print(f"[nev] {name}: outputs equal {same}; " + "; ".join(f"{k} {sorted(v)} ms" for k, v in t.items()) + f" | {cs.card_line()}")
