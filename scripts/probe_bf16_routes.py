"""The bf16 routes of K5, K3 and K8 against their plain versions and their float32 routes, on the card.

Usage: python3 scripts/probe_bf16_routes.py   (from the repository root; needs one CUDA device)

Builds the kernels (printing ptxas's line for each bf16 instantiation), then at a few serving and odd
shapes prints each route's largest error relative to the sum of its terms' magnitudes (K8: also the rows
beyond chip_smoke.py's tie rule and the share of softmax weights near a bf16 tie) and the CUDA-event
milliseconds of the bf16 and float32 routes (20 launches after a warm-up). chip_smoke.py's phase 43
holds the routes to their bounds at the main path's shapes; this is the quick look.
"""
import re
import sys

import torch

sys.path.insert(0, ".")
from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.ops import attention as k8
from fqss_tpu_torch.ops import qat_dense as qd
from fqss_tpu_torch.ops import qmatmul as qm

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
b = _build.build()
print("build", b.compiled, round(b.seconds, 1), flush=True)
lines = b.log.splitlines()
for i, line in enumerate(lines):
    if "Compiling entry function" in line and ("ELb1EE" in line or "Lb1EEv" in line):
        name = re.search(r"'(.*?)'", line).group(1)
        print(name[:90], "|", lines[i + 2].strip()[-40:], "|", lines[i + 3].strip()[:60])
_build.library()
dev = torch.device("cuda")
g = torch.Generator(device="cpu").manual_seed(0)


def ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


for (M, K, N) in ((8500, 256, 1024), (8500, 1024, 256), (1000, 1030, 200), (5, 3, 2), (77, 64, 128)):
    x = torch.randn(M, K, generator=g).to(dev)
    w = (torch.randn(N, K, generator=g) * 0.1).to(dev)
    bb = torch.randn(N, generator=g).to(dev) * 0.1
    wmx = torch.full((N,), 0.3, device=dev)
    for grids in ({}, dict(w_mn=-wmx, w_mx=wmx)):
        y = qd.qat_dense(x, w, bb, bf16=True, **grids)
        r = qd.qat_dense_ref(x, w, bb, bf16=True, **grids)
        xr, wr = qd.operands(x, qd._weight_q(w, grids.get("w_mn"), grids.get("w_mx"), 8, None), True)
        terms = xr.abs() @ wr.abs().t() + bb.abs()
        rel = ((y - r).abs() / terms).max().item()
        print(f"K5 bf16 {M}x{K}x{N} grids={bool(grids)} rel {rel:.3g}", flush=True)
    t_b = ms(lambda: qd.qat_dense(x, w, bb, bf16=True))
    t_f = ms(lambda: qd.qat_dense(x, w, bb))
    print(f"  ms bf16 {t_b:.4f} f32 {t_f:.4f}", flush=True)

for (B, K, T, N) in ((8, 256, 31999, 64), (8, 256, 3999, 256), (3, 37, 301, 65), (2, 1030, 203, 96)):
    x = torch.randn(B, K, T, generator=g).to(dev)
    w = (torch.randn(N, K, generator=g) * 0.1).to(dev)
    y = qm.qmatmul(x, w, bf16=True)
    r = qm.qmatmul_ref(x, w, bf16=True)
    xr, wr = qd.operands(x, w, True)
    terms = wr.abs() @ xr.abs()
    print(f"K3 bf16 {B}x{K}x{T}x{N} rel {((y - r).abs() / terms).max().item():.3g}; ms bf16 "
          f"{ms(lambda: qm.qmatmul(x, w, bf16=True)):.4f} f32 {ms(lambda: qm.qmatmul(x, w)):.4f}", flush=True)

for (BH, L, Lk, d) in ((2176, 250, 250, 32), (16000, 34, 34, 32), (2064, 250, 250, 16), (3, 37, 53, 24),
                       (5, 9, 9, 64), (4, 40, 70, 128)):
    q = torch.randn(BH, L, d, generator=g).to(dev) * 0.3
    k = torch.randn(BH, Lk, d, generator=g).to(dev)
    v = torch.randn(BH, Lk, d, generator=g).to(dev)
    y = k8.fused_attention(q, k, v, quantize=False, bf16=True)
    r = k8.fused_attention_ref(q, k, v, quantize=False, bf16=True)
    torch.cuda.synchronize()
    s = torch.matmul(qd.bf16_round(q), qd.bf16_round(k).transpose(-1, -2))
    p = k8.softmax_ref(s)
    vr = qd.bf16_round(v)
    pv = torch.matmul(qd.bf16_round(p), vr.abs())
    err = (y - r).abs()
    near = k8.bf16_tie_mask(p)
    allow = 2.0**-7 * torch.matmul(qd.bf16_round(p) * near, vr.abs())
    rel = (err / pv).max().item()
    bad = (err > 1e-5 * pv + allow).sum().item()
    t16 = ms(lambda: k8.fused_attention(q, k, v, quantize=False, bf16=True))
    t32 = ms(lambda: k8.fused_attention(q, k, v, quantize=False))
    print(f"K8 bf16 {BH}x{L}x{Lk}x{d}: max err/sum|pv| {rel:.3g}; beyond rule {bad}; near-tie weights "
          f"{near.float().mean().item():.3g}; ms bf16 {t16:.4f} f32 {t32:.4f}", flush=True)
    del s, p, pv
print("done")
