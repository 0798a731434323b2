"""Time source variants of the port's redesigned kernels on one CUDA GPU.

Run from the repo root on a machine with the CUDA toolkit:

    python3 scripts/kernel_variants.py [flash_bf16] [argmin] [flash32] [decode]

(no argument: every section). Each variant is the kernel's source with
one or two lines edited, built with ``nvcc`` into ``build/variants/``
(its ptxas registers and spills printed first).

- flash_bf16: ``flash_attention_bf16.cu`` at warpgroups a CTA W = 1, 2,
  3, and W = 1 without the in-loop K/V copies (stale tiles, timed only),
  at the serve prefill's shape (B 16, S 512, H 32, KH 8, D 128, causal,
  bf16), beside ``scaled_dot_product_attention``.
- argmin: ``pairwise_min_argmin`` under every CTA tile of
  ``ops.ARGMIN_TILES`` (the tiles in order, then backwards) at the image
  and text paths' shapes, beside ``torch.cdist(x, c).min(1)``.
- flash32: the fp32 ``flash_attention.cu`` with 64- and 32-dim K stages
  (``DK``) and ring depths 2 and 3 (``STAGES``), at 4 keys a thread in a
  score sub-tile (``KPT``), with the score loop over d unrolled 1, 4 or
  all the way (2 in the source), the P·V loop over keys 2 or 4 (8),
  at 64 query rows and two CTAs an SM, and with one product or the
  softmax dropped (timed only), at the text path's shape (B 32, S 512,
  H 32, KH 8, D 128, causal, kv_chunk 128), beside SDPA fp32.
- decode: ``decode_attention.cu`` at split units of 32, 64, 128 and 256
  keys (``kSplit``), and at 64 and 128 with 3 and 4 split CTAs an SM
  (``kMinCtas``), at the qwen3-8b decode shape (B 16, cache 1,024,
  cur_len 577, H 32, KH 8, D 128, bf16): CUDA events with the cache warm
  in L2 and rotating over caches that exceed it, and the split and merge
  kernels' own device time from torch.profiler.

One JSON object a line; the card's name and power limit first. Compare
numbers only within one call.
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
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
from chip_smoke import profiled_ms, ptxas_report  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")
KWG = "constexpr int kWG = D <= 128 ? 3 : 2;"
FLASH_VARIANTS = {
    "W3": [],
    "W2": [(KWG, "constexpr int kWG = 2;")],
    "W1": [(KWG, "constexpr int kWG = 1;")],
    "W1_no_kv_copies": [(KWG, "constexpr int kWG = 1;"),
                        ("    if (t + 1 < t1) {", "    if (false) {")],
}
KPT = "constexpr int KPT = 4; "
STAGES = "constexpr int STAGES = 2; "
DK = "constexpr int DK = 128; "
D4_UNROLL = "#pragma unroll 2\n  for (int d4 = 0;"
PV_UNROLL = "#pragma unroll 8\n  for (int cc = 0;"
NO_WARP_SKIP = [("if (kv0 + t * KT <= warp_last)", "if (true)"),
                ("warp_last - kv0 - u * KV + 1", "KV")]
# P.V skips whole stages past a warp's rows, not the keys past them
STAGE_PV_SKIP = ("warp_last - kv0 - u * KV + 1",
                 "(kv0 + u * KV <= warp_last ? KV : 0)")
# 64 query rows a CTA at every D, two CTAs an SM
RPT4_2CTAS = [("if constexpr (DP <= 128) {", "if constexpr (false) {"),
              ("__launch_bounds__(kThreads, 1)",
               "__launch_bounds__(kThreads, 2)")]
FLASH32_VARIANTS = {
    "kpt4_dk128": [],
    "kpt8_dk64": [(KPT, "constexpr int KPT = 8; "),
                  (DK, "constexpr int DK = 64; ")],
    "kpt4_dk64": [(DK, "constexpr int DK = 64; ")],
    "no_warp_skip": NO_WARP_SKIP,
    "stage_pv_skip": [STAGE_PV_SKIP],
    "kpt8_dk64_no_warp_skip": [(KPT, "constexpr int KPT = 8; "),
                               (DK, "constexpr int DK = 64; ")] + NO_WARP_SKIP,
    "d4_unroll_full": [(D4_UNROLL, "#pragma unroll\n  for (int d4 = 0;")],
    "pv_unroll4": [(PV_UNROLL, "#pragma unroll 4\n  for (int cc = 0;")],
    "rpt4_2ctas": RPT4_2CTAS,
    # phases dropped (wrong outputs, timed only)
    "no_score_products": [("d4 < DKS; d4 += 4", "d4 < 0; d4 += 4")],
    "no_pv_products": [("cc < nt; ++cc", "cc < 0; ++cc")],
    "no_softmax": [(
        "    block_softmax<RPT, DPT, LDP>(acc, ps, ms, ls, tx, ty, nsub, kb);",
        "")],
}
KSPLIT = "constexpr int kSplit = 128;"
KMIN = "constexpr int kMinCtas = 2;"
DECODE_VARIANTS = {f"split{n}": [(KSPLIT, f"constexpr int kSplit = {n};")]
                   for n in (32, 64, 128, 256)}
DECODE_VARIANTS.update({
    f"split{n}_ctas{c}": [(KSPLIT, f"constexpr int kSplit = {n};"),
                          (KMIN, f"constexpr int kMinCtas = {c};")]
    for n in (64, 128) for c in (3, 4)})


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


def build_variants(build, kernel, variants):
    """{variant: loaded library} for ``kernel``'s source under each
    variant's (old line, new line) edits."""
    src = open(build.SOURCES[kernel]).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            assert old in text, (name, old)
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{kernel}_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = path[:-3] + ".so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n"
                               f"{logs[name]}")
        libs[name] = ctypes.CDLL(so)
    print(json.dumps({"kernel": kernel, "ptxas_registers_spills":
                      ptxas_report(logs)}), flush=True)
    return libs


def flash(build):
    import torch.nn.functional as F
    from repro_torch.models.layers.attention import naive_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, lib in build_variants(build, "flash_attention_bf16",
                                    FLASH_VARIANTS).items():
        fn = libs[name] = lib.flash_attention_fwd_bf16
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
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


def argmin(build):
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


def flash32(build):
    """The fp32 kernel (text path) at B 32, S 512, H 32, KH 8, D 128,
    causal, kv_chunk 128: keys a thread in a score sub-tile (KPT) and
    the cp.async ring's depth, each variant twice (in order, then
    backwards), beside the unchanged build's wrapper and SDPA fp32."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    dev = torch.device("cuda")
    b, s, h, kh, d = 32, 512, 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, s, h, d), generator=g, device=dev)
    k = torch.randn((b, s, kh, d), generator=g, device=dev)
    v = torch.randn((b, s, kh, d), generator=g, device=dev)
    want = fa.flash_attention_auto(q, k, v, kv_chunk=128)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, lib in build_variants(build, "flash_attention",
                                    FLASH32_VARIANTS).items():
        fn = fns[name] = lib.flash_attention_fwd_f32
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        def call(fn=fns[name]):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, s, s, h, kh, d, 128, 1, 0, d ** -0.5, stream)
            assert err == 0, err
        times[name].append(median_ms(call, reps=5))
    for name, fn in fns.items():
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, s,
           h, kh, d, 128, 1, 0, d ** -0.5, stream)
        torch.cuda.synchronize()
        print(json.dumps({"kernel": "flash_attention", "variant": name,
                          "ms": times[name],
                          "bytes_equal_to_build": torch.equal(out, want)}),
              flush=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    print(json.dumps({"kernel": "flash_attention", "variant": "sdpa (library)",
                      "ms": median_ms(lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, is_causal=True, enable_gqa=True),
                          reps=5)}), flush=True)


def decode(build):
    """B6 at each split unit: warm and L2-cold events, profiler device
    time, and the largest difference from the plain version."""
    from repro_torch.kernels.decode_attention import ops as da
    dev = torch.device("cuda")
    b, s, n, h, kh, d = 16, 1_024, 577, 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((b, 1, h, d), generator=g, device=dev).bfloat16()
    sets = [tuple(torch.randn((b, s, kh, d), generator=g, device=dev)
                  .bfloat16() for _ in range(2)) for _ in range(4)]
    cur = torch.tensor(n, dtype=torch.int32, device=dev)
    want = da.decode_attention_auto(q, *sets[0], cur, impl="ref")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in build_variants(build, "decode_attention",
                                    DECODE_VARIANTS).items():
        fn = lib.decode_attention
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
        split = lib.decode_attention_split_keys()
        n_splits = -(-s // split)
        ws = torch.empty((b, kh, n_splits, h // kh, d + 2), device=dev)
        turn = [0]

        def call(rotate, fn=fn, ws=ws, n_splits=n_splits):
            kk, vv = sets[turn[0] % len(sets)] if rotate else sets[0]
            turn[0] += 1
            err = fn(q.data_ptr(), kk.data_ptr(), vv.data_ptr(),
                     out.data_ptr(), ws.data_ptr(), cur.data_ptr(), 1, b, s,
                     h, kh, d, n_splits, 0, d ** -0.5, stream)
            assert err == 0, err
        call(False)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        print(json.dumps({
            "kernel": "decode_attention", "variant": name,
            "split_keys": split, "max_abs_err": err,
            "ms": median_ms(lambda: call(False)),
            "device_ms": profiled_ms(lambda: call(False), "decode_attention"),
            "split_merge_device_ms": [
                profiled_ms(lambda: call(False), f"decode_attention_{key}")
                for key in ("split", "merge")],
            "cold_ms": median_ms(lambda: call(True)),
            "cold_device_ms": profiled_ms(lambda: call(True),
                                          "decode_attention")}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sections = {"flash_bf16": flash, "argmin": argmin, "flash32": flash32,
                "decode": decode}
    for name in sys.argv[1:] or sections:
        sections[name](build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
