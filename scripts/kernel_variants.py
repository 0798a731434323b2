"""Time source variants of the port's redesigned kernels on one CUDA GPU.

Run from the repo root on a machine with the CUDA toolkit:

    python3 scripts/kernel_variants.py

It builds variants of ``flash_attention_bf16.cu`` by editing one line of
the source each (warpgroups a CTA W = 1, 2, 3; W = 1 without the in-loop
K/V copies, which then computes on stale tiles and is timed only), times
each at the serve prefill's shape (B 16, S 512, H 32, KH 8, D 128,
causal, bf16) beside ``scaled_dot_product_attention``, and times the
``pairwise_min_argmin`` kernel under every CTA tile of
``ops.ARGMIN_TILES`` (each twice: the tiles in order, then backwards) at
the image and text paths' shapes beside ``torch.cdist(x, c).min(1)``.
One JSON object a line; the card's name and power limit first. Builds go
to ``build/variants/``.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "variants")
KWG = "constexpr int kWG = D <= 128 ? 3 : 2;"
FLASH_VARIANTS = {
    "W3": [],
    "W2": [(KWG, "constexpr int kWG = 2;")],
    "W1": [(KWG, "constexpr int kWG = 1;")],
    "W1_no_kv_copies": [(KWG, "constexpr int kWG = 1;"),
                        ("    if (t + 1 < t1) {", "    if (false) {")],
}


def median_ms(fn, reps=20, inner=10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def build_variants(build):
    src = open(build.SOURCES["flash_attention_bf16"]).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in FLASH_VARIANTS.items():
        text = src
        for old, new in edits:
            assert old in text, (name, old)
            text = text.replace(old, new)
        path = os.path.join(OUT, f"flash_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = path[:-3] + ".so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(so).flash_attention_fwd_bf16
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
        libs[name] = fn
    return libs


def flash(build):
    import torch.nn.functional as F
    from repro_torch.models.layers.attention import naive_attention
    libs = build_variants(build)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    b, s, h, kh, d = 16, 512, 32, 8, 128
    q = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, s, kh, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, s, kh, d), generator=g, device=dev).bfloat16()
    want = naive_attention(q, k, v, causal=True)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    for name, fn in libs.items():
        def call(fn=fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, s, s, h, kh, d, 1, 0, d ** -0.5, stream)
            assert err == 0, err
        call()
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        print(json.dumps({"kernel": "flash_attention_bf16", "variant": name,
                          "ms": median_ms(call), "max_abs_err": err}),
              flush=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    print(json.dumps({"kernel": "flash_attention_bf16",
                      "variant": "sdpa (library)",
                      "ms": median_ms(lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=True, enable_gqa=True))}),
          flush=True)


def argmin():
    from repro_torch.kernels.pairwise import ops
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n, m, d in ((10_000, 1_000, 512), (2_048, 256, 4_096)):
        x = torch.from_numpy((rng.standard_normal((n, d)) * 0.05).astype(
            np.float32)).to(dev)
        c = torch.from_numpy((rng.standard_normal((m, d)) * 0.05).astype(
            np.float32)).to(dev)
        first = ops.pairwise_min_and_argmin(x, c, plan=ops.ARGMIN_TILES[0])
        times = {plan: [] for plan in ops.ARGMIN_TILES}
        # forwards then backwards, so no plan always runs first
        for plan in ops.ARGMIN_TILES + ops.ARGMIN_TILES[::-1]:
            times[plan].append(median_ms(
                lambda: ops.pairwise_min_and_argmin(x, c, plan=plan)))
        for plan, ms in times.items():
            got = ops.pairwise_min_and_argmin(x, c, plan=plan)
            same = all(torch.equal(a, b_) for a, b_ in zip(got, first))
            print(json.dumps({
                "kernel": "pairwise_min_argmin", "shape": [n, m, d],
                "plan": list(plan), "picked": ops.argmin_plan(n, m) == plan,
                "ms": ms, "bytes_equal_to_first": same}), flush=True)
        print(json.dumps({"kernel": "pairwise_min_argmin", "shape": [n, m, d],
                          "plan": "cdist (library)",
                          "ms": median_ms(lambda: torch.cdist(x, c).min(1))}),
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    flash(build)
    argmin()
    return 0


if __name__ == "__main__":
    sys.exit(main())
