"""K3 and the FORBES K2 of two checkouts on one card: the SASS of each
kernel instance (addresses stripped) of csrc/trace.cu and csrc/gen_grad.cu,
and their CUDA-event times alternated over 10 rounds (K3 on the Cooke
triplet's rays 1 x 4M, the FORBES K2 on the Qbfs singlet 1 x 1 x 4M).

    python3 probes/kernel_ab.py

from the repository's root on a machine with one GPU and nvcc, with the
other checkout unpacked in _parent_tree/ (git archive <commit>); the
libraries are built into _probe/. The other checkout's gen_grad_launch
takes no polarization argument and its K2 instances no POL template
argument (a checkout before sub-slice (e)): the SASS comparison matches
each of its instances with this checkout's POL = false one."""
import ctypes, re, subprocess, sys
from pathlib import Path
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from optiland_pr_tpu_torch.kernels import gen_trace as k1, trace_conic as k3
from optiland_pr_tpu_torch.core.distributions import generate_distribution
from optiland_pr_tpu_torch.samples import CookeTriplet
from optiland_pr_tpu_torch.trace.raygen import generate_rays
NVCC = k1._find_nvcc()
CUOBJDUMP = str(Path(NVCC).with_name("cuobjdump"))
trees = {"parent": Path("_parent_tree/optiland_pr_tpu_torch/kernels/csrc"),
         "change": Path("optiland_pr_tpu_torch/kernels/csrc")}
libs = {}
for tag, src in trees.items():
    out = Path(f"_probe/build_{tag}"); out.mkdir(exist_ok=True)
    for name in ("trace", "gen_grad"):
        so = out / f"{name}.so"
        r = subprocess.run([NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                            "-Xcompiler", "-fPIC", "-o", str(so), str(src / f"{name}.cu")], capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        libs[tag, name] = so
def sass(so):
    txt = subprocess.run([CUOBJDUMP, "-sass", str(so)], capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in txt.splitlines():
        m = re.search(r"Function : (\S+)", line)
        # an instance by its template arguments: gen_grad_kernel<MAXS, VAR,
        # MODE, false> as the other checkout's <MAXS, VAR, MODE>, whose
        # parameters lack the polarization's
        if m: cur = re.sub(r"ELb0EEv.*|EEv.*", "", m.group(1)); funcs[cur] = []; continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if cur and m: funcs[cur].append(re.sub(r"0x[0-9a-f]+", "X", m.group(1)))
    return funcs
for name in ("trace", "gen_grad"):
    a, b = sass(libs["parent", name]), sass(libs["change", name])
    for fn in a:
        if fn not in b: print(f"[sass] {name} {fn[:60]}: missing in change"); continue
        same = a[fn] == b[fn]
        print(f"[sass] {name} {fn[:70]}: {len(a[fn])} / {len(b[fn])} instructions, identical {same}")
dev = torch.device("cuda"); f32 = torch.float32
px, py = generate_distribution("random", 4_000_000, dtype=f32, device=dev)
m, p = CookeTriplet().build(device=dev, dtype=f32)
rays_in = generate_rays(m, p, torch.zeros_like(px), torch.ones_like(px), px, py, 0.55)
table = torch.stack([getattr(rays_in, k) for k in k3.RAY_FIELDS]).contiguous()
consts = k1.pack_surface_constants(m, p, 0.55); acoef = k1.pack_asphere_coeffs(m, p)
fl = k1.model_flags(m, p); words = (ctypes.c_int32 * len(fl))(*k1._flag_words(fl))
outs = torch.empty_like(table)
def k3_call(lib):
    f = lib.trace_launch
    err = f(consts.data_ptr(), acoef.data_ptr(), k1.zernike_table(dev).data_ptr(), table.data_ptr(), outs.data_ptr(),
            ctypes.addressof(words), len(fl), acoef.shape[1], table.shape[1], torch.cuda.current_stream().cuda_stream, None)
    assert err == 0
tl = {}
for tag in trees:
    l = ctypes.CDLL(str(libs[tag, "trace"])); l.trace_launch.argtypes, l.trace_launch.restype = k1._SIGNATURES["trace"][0][1:]
    tl[tag] = l
res = {t: [] for t in trees}
for rnd in range(10):
    for tag in (("parent", "change") if rnd % 2 == 0 else ("change", "parent")):
        res[tag].append(cs.cuda_ms(lambda: k3_call(tl[tag])))
print("[k3] cooke 1x4M " + "; ".join(f"{t} median {sorted(v)[5]:.4f} min {min(v):.4f} max {max(v):.4f}" for t, v in res.items()) + f" | {cs.card_line()}")
# the FORBES K2 on the Qbfs singlet 1 x 1 x 4M
lens = cs.freeform_singlet("qbfs", material="N-BK7", fields=(0,))
m, p = lens.build(device=dev, dtype=f32)
gen, consts2, acoef2 = k1.gen_tables(m, p, p["wavelengths"][:1], 0.0, 0.0)
fl2 = k1.model_flags(m, p); words2 = (ctypes.c_int32 * len(fl2))(*k1._flag_words(fl2))
cot = torch.randn((8, 1, 1, px.shape[0]), device=dev)
sig_old = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
gl = {}
for tag in trees:
    l = ctypes.CDLL(str(libs[tag, "gen_grad"]))
    l.gen_grad_partials_size.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int]
    l.gen_grad_partials_size.restype = ctypes.c_longlong
    l.gen_grad_launch.argtypes = sig_old if tag == "parent" else k1._SIGNATURES["gen_grad"][1][1]
    l.gen_grad_launch.restype = ctypes.c_int
    gl[tag] = l
n = px.shape[0]
part = torch.empty(gl["change"].gen_grad_partials_size(ctypes.addressof(words2), len(fl2), 1, 1, n, 0), device=dev)
bufs = [torch.empty(s_, device=dev) for s_ in ((1, 1, n), (1, 1, n), (1, 16), (1, len(fl2), 32), tuple(acoef2.shape), (n,), (n,))]
def k2_call(tag):
    extra = [None] if tag == "change" else []
    err = gl[tag].gen_grad_launch(gen.data_ptr(), consts2.data_ptr(), acoef2.data_ptr(), k1.zernike_table(dev).data_ptr(),
                                  px.data_ptr(), py.data_ptr(), cot.data_ptr(), part.data_ptr(), *[b.data_ptr() for b in bufs],
                                  ctypes.addressof(words2), len(fl2), 1, 1, acoef2.shape[1], n, 1, 0, *extra,
                                  torch.cuda.current_stream().cuda_stream, None)
    assert err == 0
res = {t: [] for t in trees}
for rnd in range(10):
    for tag in (("parent", "change") if rnd % 2 == 0 else ("change", "parent")):
        res[tag].append(cs.cuda_ms(lambda: k2_call(tag)))
print("[k2 forbes] qbfs 1x1x4M " + "; ".join(f"{t} median {sorted(v)[5]:.4f} min {min(v):.4f} max {max(v):.4f}" for t, v in res.items()) + f" | {cs.card_line()}")
