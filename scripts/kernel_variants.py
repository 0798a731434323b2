"""Time source variants of the port's redesigned kernels on one CUDA GPU.

Run from the repo root on a machine with the CUDA toolkit:

    python3 scripts/kernel_variants.py [flash_bf16] [argmin] [flash32] \
        [decode] [round] [unc] [gated] [engine] [--parent DIR]

(no section named: every section). Each variant is the kernel's source
(its local headers inlined) with one or two lines edited, built with
``nvcc`` into ``build/variants/`` (its ptxas registers and spills printed
first). ``--parent DIR`` names an unpacked earlier tree (``git archive
<commit> src/repro_torch/kernels | tar -x -C DIR``) whose kernels the
round, unc and gated sections time beside the variants.

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
- round: ``greedy_round.cu`` (with ``round_block.cuh``) at 4, 8 and 16
  chunks in flight a lane (``kInFlight``), with 4-byte loads in place of
  16-byte ones, with a one-CTA final pass in place of the last-CTA
  ticket (``kTicket``) and with the matmul form's registers uncut
  (``kMatmulCtas``), at the default rows per CTA, and the source as
  built at other rows per CTA; at the image and text pools' k-center
  rounds (50,000 x 512 and 2,048 x 4,096, R = 1), the Core-Set warm
  start's chunk (50,000 x 512, R = r_block) and the prefilter's fold
  slice (256 x 512): torch.profiler device time warm and over rotating
  pools, and whether the outputs' bytes equal the build's.
- unc: ``uncertainty_stats.cu`` at split sizes of 2, 4 and 8 16-byte
  units a thread (``kUnits``: 76, 38 and 19 splits a row at fp32) and
  1 to 8 units loaded before the thread computes (``kBatch``), at 16 and
  4,096 rows of 152,064 fp32 logits, each twice (in order, then
  backwards): split + merge device time, and the largest difference
  from the plain version.
- gated: ``gated_greedy_round.cu`` at 50,000 x 512 by gate block (32, 64,
  256 rows), live share (all, ~10 %), R and forms (R = 1 matmul or
  difference form; R = 8 with per-block cursors, all matmul or mixed),
  at every tile size up to the gate block (bytes against the plan's
  tile), L2-cold at the plan's; the earlier tree's one-CTA-a-block grid
  beside it with ``--parent``.
- engine: the prefilter's gated k-center engine (``gated_greedy_select``,
  no server) at chip_smoke's sharded shapes, budget 200, three thread
  lanes: per query its wall, launches, waves (or per-segment folds) and
  host syncs per (slot, shard), host seconds by part and a profiled
  10-slot query; with ``--parent DIR`` (``git archive <commit> src``) the
  earlier tree's engine first.

One JSON object a line; the card's name and power limit first. Compare
numbers only within one call.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package the engine section drives (another tree's, for --parent)
SRC = os.environ.get("KERNEL_VARIANTS_SRC", os.path.join(ROOT, "src"))
sys.path[:0] = [SRC, ROOT]
from chip_smoke import (CLUMP_D, CLUMP_K, CLUMP_N, D, POOL,  # noqa: E402
                        dupe_pool, profiled_ms, ptxas_report)

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


IN_FLIGHT = "constexpr int kInFlight = 4;"
TICKET = "constexpr bool kTicket = true;"
VEC = "const bool vec = d % 4 == 0"
MATMUL_CTAS = "constexpr int kMatmulCtas = 2;"
ROUND_VARIANTS = {
    "build": [],
    "in_flight8": [(IN_FLIGHT, "constexpr int kInFlight = 8;")],
    "in_flight16": [(IN_FLIGHT, "constexpr int kInFlight = 16;")],
    "scalar_loads": [(VEC, "const bool vec = false && d % 4 == 0")],
    "final_pass": [(TICKET, "constexpr bool kTicket = false;")],
    "matmul_1cta": [(MATMUL_CTAS, "constexpr int kMatmulCtas = 1;")],
}
UNITS = "constexpr int kUnits = 8; "
BATCH = "constexpr int kBatch = 4; "
UNC_VARIANTS = {f"units{u}_batch{b}": [
    (UNITS, f"constexpr int kUnits = {u}; "),
    (BATCH, f"constexpr int kBatch = {b}; ")]
    for u, b in ((2, 2), (4, 1), (4, 2), (4, 4), (8, 4), (8, 8))}


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


def inlined_source(path):
    """The source at ``path`` with its local ``#include "..."`` headers
    inlined (followed recursively), so an edit may touch a header and the
    variant still builds from ``build/variants/``."""
    text = open(path).read()
    for inc in re.findall(r'^#include "([^"]+)"$', text, re.M):
        text = text.replace(f'#include "{inc}"', inlined_source(
            os.path.join(os.path.dirname(path), inc)))
    return text


def build_variants(build, kernel, variants, source=None):
    """{variant: loaded library} for ``kernel``'s source (or the one at
    ``source``) under each variant's (old line, new line) edits."""
    src = inlined_source(source or build.SOURCES[kernel])
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


def parent_source(kernel):
    """The source of ``kernel`` in the tree named by ``--parent DIR`` (an
    unpacked earlier commit), or None."""
    if "--parent" not in sys.argv:
        return None
    root = sys.argv[sys.argv.index("--parent") + 1]
    from repro_torch.kernels import build
    rel = os.path.relpath(build.SOURCES[kernel], ROOT)
    return os.path.join(root, rel)


def _rotating(make, count):
    """``count`` inputs from ``make(i)`` and a function that hands them out
    in turn (each call finds its own out of the 50 MB L2)."""
    sets = [make(i) for i in range(count)]
    turn = [0]

    def take():
        turn[0] += 1
        return sets[turn[0] % count]
    return sets, take


def greedy_round_variants(build):
    """B1 at the image and text paths' k-center rounds (R = 1), the Core-Set
    warm start's chunk (R = r_block) and the prefilter's fold slice: each
    source variant (16-byte chunks in flight a lane, 4-byte loads, the
    one-CTA final pass in place of the ticket) at the default rows per CTA,
    the as-built source at other rows per CTA, and with ``--parent DIR``
    the earlier tree's kernel (its own argmax over the partials on the
    host, as its wrapper ran it). Device ms from torch.profiler, warm and
    over rotating pools; bytes against the build."""
    from repro_torch.kernels.pairwise import autotune, ops
    dev = torch.device("cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, lib in build_variants(build, "greedy_round",
                                    ROUND_VARIANTS).items():
        fn = fns[name] = lib.greedy_round_f32
        fn.argtypes = [p] * 10 + [i] * 4 + [p]
        fn.restype = i
    old = None
    src = parent_source("greedy_round")
    if src is not None:
        old = build_variants(build, "greedy_round", {"parent": []},
                             src)["parent"].greedy_round_f32
        old.argtypes = [p] * 8 + [i] * 4 + [p]
        old.restype = i
    stream = torch.cuda.current_stream().cuda_stream
    ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    r_block = autotune.model_blocks(50_000, 512).r_block
    for n, d, r in ((50_000, 512, 1), (2_048, 4_096, 1),
                    (50_000, 512, r_block), (256, 512, 1)):
        count = max(2, int(100e6 // (4 * n * d)) + 2)
        sets, take = _rotating(lambda _: torch.randn(
            (n, d), generator=g, device=dev) * 0.05, count)
        mind = torch.full((n,), 3.4e38, device=dev)
        c = sets[0][7:7 + r].clone()
        sel = (torch.tensor([7], dtype=torch.int32, device=dev) if r == 1
               else torch.full((r,), -1, dtype=torch.int32, device=dev))
        plan = ops.round_plan(n, d, r)
        rows_list = sorted({plan.rows_per_cta, *(
            (8, 16, 32, 64, 128, 256) if d <= 512 else (4, 8, 16, 32, 64))})
        ref_bytes = None
        for name, fn in fns.items():
            for rows in (rows_list if name == "build" and r == 1
                         else [plan.rows_per_cta]):
                nb = -(-n // rows)
                buf = torch.empty((n + 2 + 2 * nb,), device=dev)
                base = buf.data_ptr()

                def call(x=None, fn=fn, rows=rows, base=base):
                    x = sets[0] if x is None else x
                    err = fn(x.data_ptr(), mind.data_ptr(), c.data_ptr(),
                             None, sel.data_ptr(), None, base,
                             base + 4 * (n + 2), base + 4 * n,
                             ticket.data_ptr(), n, d, r, rows, stream)
                    assert err == 0, err
                call()
                torch.cuda.synchronize()
                out = buf[:n + 2].clone()
                ref_bytes = out if ref_bytes is None else ref_bytes
                print(json.dumps({
                    "kernel": "greedy_round", "variant": name,
                    "shape": [n, d, r], "rows_per_cta": rows,
                    "ms": median_ms(call),
                    "device_ms": profiled_ms(call, ""),
                    "cold_device_ms": profiled_ms(lambda: call(take()), ""),
                    "bytes_equal_to_build": torch.equal(out, ref_bytes)}),
                    flush=True)
        if old is not None:
            nb = -(-n // 64)
            nmind = torch.empty((n,), device=dev)
            bmax = torch.empty((nb,), device=dev)
            barg = torch.empty((nb,), dtype=torch.int32, device=dev)

            def call_old(x=None):
                x = sets[0] if x is None else x
                err = old(x.data_ptr(), mind.data_ptr(), c.data_ptr(),
                          sel.data_ptr(), None, nmind.data_ptr(),
                          bmax.data_ptr(), barg.data_ptr(), n, d, r, 64,
                          stream)
                assert err == 0, err
                win = torch.argmax(bmax)
                return barg[win], bmax[win]
            print(json.dumps({
                "kernel": "greedy_round", "variant": "parent",
                "shape": [n, d, r], "rows_per_cta": 64,
                "ms": median_ms(call_old),
                "device_ms": profiled_ms(call_old, "greedy_round"),
                "cold_device_ms": profiled_ms(lambda: call_old(take()),
                                              "greedy_round"),
                "call_device_ms": profiled_ms(call_old, "")}), flush=True)
        del sets


GATED_N, GATED_D = 50_000, 512


def device_ms(fn, key, tries=3):
    """``profiled_ms``, asked again when a profiler session saw no kernel
    of ``key`` (after many sessions in one process it now and then
    returns none)."""
    for t in range(tries):
        try:
            return profiled_ms(fn, key)
        except AssertionError:
            if t == tries - 1:
                raise
# source edits of the gated round (its matmul body): a deeper cp.async
# ring, and registers cut for three CTAs an SM
GATED_VARIANTS = {
    "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")],
    "matmul_ctas3": [("constexpr int kMatmulCtas = 2;",
                      "constexpr int kMatmulCtas = 3;")],
}


def gated_variants(build):
    """B5 at 50,000 x 512 over gate blocks of 32, 64 and 256 rows, live
    share all / ~10 %: R = 1 with nothing pending in the matmul form (the
    reference's) and the difference form (forms [0], the prefilter's
    single centers), and R = 8 with pending cursors seeded per block (all
    matmul, and five matmul-form centers then three single ones); the
    build at every tile size up to the gate block (torch.profiler device
    ms, warm; L2-cold over three rotating pools at the plan's tile), the
    bytes of every tile against the plan's; with ``--parent DIR`` the
    earlier tree's kernel (one CTA a gate block, matmul form only) beside
    it, warm and cold; then the source variants (``GATED_VARIANTS``) at
    n_block 256, R = 1, both forms and live shares, at the plan's tile."""
    from repro_torch.kernels.pairwise import ops
    dev = torch.device("cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    variants = {}
    for name, lib in build_variants(build, "gated_greedy_round",
                                    GATED_VARIANTS).items():
        fn = variants[name] = lib.gated_greedy_round_f32
        fn.argtypes = [p] * 11 + [i] * 6 + [p]
        fn.restype = i
    old = None
    src = parent_source("gated_greedy_round")
    if src is not None:
        old = build_variants(build, "gated_greedy_round", {"parent": []},
                             src)["parent"].gated_greedy_round_f32
        old.argtypes = [p] * 10 + [i] * 4 + [p]
        old.restype = i
    build.load("gated_greedy_round")
    stream = torch.cuda.current_stream().cuda_stream
    ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    n, d = GATED_N, GATED_D
    sets, take = _rotating(lambda _: torch.randn(
        (n, d), generator=g, device=dev) * 0.05, 3)
    x = sets[0]
    mind = torch.full((n,), 3.4e38, device=dev)
    rng = np.random.default_rng(3)
    for nb in (256, 64, 32):
        nn = -(-n // nb)
        for share in (1.0, 0.1):
            live = (np.ones(nn, np.int32) if share == 1.0 else
                    (rng.uniform(size=nn) < share).astype(np.int32))
            live_rows = int(sum(min(nb, n - b * nb)
                                for b in np.nonzero(live)[0]))
            live_d = torch.from_numpy(live).to(dev)
            for r, forms in ((1, None), (1, [0]), (8, None),
                             (8, [1, 1, 1, 1, 1, 0, 0, 0])):
                c = x[7:7 + r].clone()
                pend = (np.zeros(nn, np.int32) if r == 1 else
                        rng.integers(0, r, nn).astype(np.int32))
                pend_d = torch.from_numpy(pend).to(dev)
                f = None if forms is None else torch.tensor(
                    forms, dtype=torch.int8, device=dev)
                plan = ops.gated_plan(n, d, nb)
                base = None
                for tile in [t for t in ops.GATED_TILE_ROWS if t <= nb]:
                    def call(xs=None, tile=tile):
                        return ops._gated_greedy_round_cuda(
                            x if xs is None else xs, mind, c, live_d,
                            pend_d, None, nb, f, tile)
                    outs = call()
                    torch.cuda.synchronize()
                    got = torch.cat([outs[0], outs[3].flatten()])
                    base = got if base is None else base
                    rec = {"kernel": "gated_greedy_round", "variant": "build",
                           "shape": [n, d, r], "n_block": nb,
                           "live_share": share, "live_rows": live_rows,
                           "forms": forms, "tile_rows": tile,
                           "plan_tile": tile == plan,
                           "device_ms": device_ms(call,
                                                    "gated_greedy_round"),
                           "bytes_equal": torch.equal(got, base)}
                    if tile == plan:
                        rec["cold_device_ms"] = device_ms(
                            lambda: call(take()), "gated_greedy_round")
                    print(json.dumps(rec), flush=True)
                if old is not None and forms is None:
                    nmind = torch.empty((n,), device=dev)
                    part = torch.empty((2 * nn + 2,), device=dev)

                    def call_old(xs=None):
                        xs = x if xs is None else xs
                        base_p = part.data_ptr()
                        err = old(xs.data_ptr(), mind.data_ptr(),
                                  c.data_ptr(), live_d.data_ptr(),
                                  pend_d.data_ptr(), None, nmind.data_ptr(),
                                  base_p + 8, base_p, ticket.data_ptr(), n,
                                  d, r, nb, stream)
                        assert err == 0, err
                    print(json.dumps({
                        "kernel": "gated_greedy_round", "variant": "parent",
                        "shape": [n, d, r], "n_block": nb,
                        "live_share": share, "live_rows": live_rows,
                        "device_ms": device_ms(call_old,
                                                 "gated_greedy_round"),
                        "cold_device_ms": device_ms(
                            lambda: call_old(take()), "gated_greedy_round")}),
                        flush=True)
    nb, nn = 256, -(-n // 256)
    tile = ops.gated_plan(n, d, nb)
    tpb = -(-nb // tile)
    buf = torch.empty((n + 2 + 2 * nn + 2 * nn * tpb,), device=dev)
    c = x[7:8].clone()
    pend_d = torch.zeros(nn, dtype=torch.int32, device=dev)
    diff = torch.zeros(1, dtype=torch.int8, device=dev)
    for share in (1.0, 0.1):
        live = (np.ones(nn, np.int32) if share == 1.0 else
                (np.random.default_rng(5).uniform(size=nn) < share).astype(
                    np.int32))
        live_d = torch.from_numpy(live).to(dev)
        for forms in (None, diff):
            for name, fn in variants.items():
                def call(fn=fn, forms=forms):
                    base_p = buf.data_ptr()
                    err = fn(x.data_ptr(), mind.data_ptr(), c.data_ptr(),
                             live_d.data_ptr(), pend_d.data_ptr(),
                             None if forms is None else forms.data_ptr(),
                             None, base_p, base_p + 4 * (n + 2),
                             base_p + 4 * n, ticket.data_ptr(), n, d, 1, nb,
                             tile, 1 if forms is None else 0, stream)
                    assert err == 0, err
                print(json.dumps({
                    "kernel": "gated_greedy_round", "variant": name,
                    "shape": [n, d, 1], "n_block": nb, "live_share": share,
                    "forms": None if forms is None else [0],
                    "tile_rows": tile,
                    "device_ms": device_ms(call, "gated_greedy_round")}),
                    flush=True)
    del sets


def uncertainty_variants(build):
    """B4 at the decode shape (16 x 152,064 fp32) and a pool-scoring shape
    (4,096 rows): split sizes (16-byte units a thread: S = 76, 38, 19 at
    fp32) and units a thread loads before it computes, each twice (in
    order, then backwards); with ``--parent DIR`` the earlier tree's one
    CTA a row. Device ms from torch.profiler (split + merge)."""
    from repro_torch.kernels.uncertainty import ops as unc
    from repro_torch.kernels.uncertainty import ref as uref
    dev = torch.device("cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, lib in build_variants(build, "uncertainty_stats",
                                    UNC_VARIANTS).items():
        fn = lib.uncertainty_stats
        fn.argtypes = [p, i, p, p, i, i, p]
        fn.restype = i
        fns[name] = (fn, lib.uncertainty_stats_split_elems(0))
    src = parent_source("uncertainty_stats")
    if src is not None:
        old = build_variants(build, "uncertainty_stats", {"parent": []},
                             src)["parent"].uncertainty_stats
        old.argtypes = [p, i, p, i, i, p]
        old.restype = i
        fns["parent"] = (old, None)
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(4)
    for n in (16, 4_096):
        x = torch.randn((n, 152_064), generator=g, device=dev) * 3.0
        want = uref.uncertainty_stats_ref(x)
        times = {name: [] for name in fns}
        calls = {}
        for name, (fn, split) in fns.items():
            splits = 0 if split is None else -(-x.shape[1] // split)
            buf = torch.empty((4 * n * (1 + splits),), device=dev)

            def call(fn=fn, buf=buf, split=split):
                base = buf.data_ptr()
                args = ((base, base + 16 * n) if split is not None
                        else (base,))
                err = fn(x.data_ptr(), 0, *args, n, x.shape[1], stream)
                assert err == 0, err
            calls[name] = (call, buf, split)
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(profiled_ms(calls[name][0],
                                           "uncertainty_stats"))
        for name, (call, buf, split) in calls.items():
            call()
            torch.cuda.synchronize()
            got = buf[:4 * n].view(4, n)
            err = max(float((got[k] - want[kind]).abs().max())
                      for k, kind in enumerate(unc.KINDS))
            print(json.dumps({"kernel": "uncertainty_stats", "variant": name,
                              "shape": [n, x.shape[1]], "split_elems": split,
                              "device_ms": times[name],
                              "max_abs_err_vs_plain": err}), flush=True)
        del x


# The prefilter's gated k-center engine driven directly (no server) at
# chip_smoke's sharded shapes: the image pool's 50,000 x 512 rows (random
# features, which the gate prunes as little as the image pool's) and the
# clumped pool's 12,288 rows projected to the MLP's 32 features, each on
# three shards with their summaries built on the card.
PROBE_CASES = (("image", POOL, D, 64, (1e6, 0.05)),
               ("clumped", CLUMP_N, 32, 128, (0.05,)))


def _probe_shards(name, n, d, k, dev):
    from repro_torch.core import prefilter as pf
    from repro_torch.core.selection import ShardView
    rng = np.random.default_rng(17)
    if name == "clumped":
        x = dupe_pool(n, CLUMP_K, CLUMP_D)[0] @ (
            rng.standard_normal((CLUMP_D, d)) / np.sqrt(CLUMP_D))
        x = x.astype(np.float32)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
    shards = []
    for si in range(3):
        g = np.arange(si, n, 3, dtype=np.int64)
        summ = pf.build_summary(x[g], k, f"probe/{si}", device=dev)
        shards.append(ShardView(feats=x[g], probs=None, gidx=g,
                                summary=summ, pool_rows=np.arange(g.size),
                                pool_feats=x[g], device=dev))
    return shards


class _Timers:
    """Host seconds spent in named functions (wrapped in place, restored
    on exit), summed over threads."""

    def __init__(self, targets):
        self.targets, self.s, self.calls = targets, {}, {}

    def __enter__(self):
        import threading
        lock = threading.Lock()
        self.saved = []
        for key, (obj, attr) in self.targets.items():
            if not hasattr(obj, attr):
                continue
            orig = getattr(obj, attr)
            self.saved.append((obj, attr, orig))
            self.s[key], self.calls[key] = 0.0, 0

            def wrap(*a, _orig=orig, _key=key, **kw):
                t = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    with lock:
                        self.s[_key] += time.perf_counter() - t
                        self.calls[_key] += 1
            setattr(obj, attr, wrap)
        return self

    def __exit__(self, *exc):
        for obj, attr, orig in self.saved:
            setattr(obj, attr, orig)


def engine_probe(build, budget=200):
    """Per (case, slack): ``gated_greedy_select`` at ``budget`` over three
    thread lanes: wall s, kernel launches, folds (one per folded slice:
    the per-segment engine's fused-round calls, or the wave engine's
    committed segments), waves and host syncs per (slot, shard); host
    seconds in the folds, the kernel wrappers, the bounds (``_tighten``)
    and the lanes' merge; then one 10-slot query under torch.profiler:
    host time by operation class (copies, launches, syncs). With
    ``--parent DIR`` (a whole unpacked ``src/``) the earlier tree's
    engine first, in a process of its own; a per-segment engine (no
    ``ENGINE_STATS``) is read by its ``_fold_slice`` calls, two syncs
    each."""
    if "--parent" in sys.argv and SRC == os.path.join(ROOT, "src"):
        tree = os.path.join(sys.argv[sys.argv.index("--parent") + 1], "src")
        subprocess.run([sys.executable, os.path.abspath(__file__), "engine"],
                       env={**os.environ, "KERNEL_VARIANTS_SRC": tree},
                       check=True)
    dev = torch.device("cuda")
    from concurrent.futures import ThreadPoolExecutor
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.common import rng as rnglib
    from repro_torch.core import prefilter as pf
    from repro_torch.core import selection
    from repro_torch.kernels.pairwise import ops
    eng = pf._ShardEngine
    targets = {"propose": (eng, "propose"), "tighten": (eng, "_tighten"),
               "fold_slices": (eng, "_fold_slice"), "waves": (eng, "_wave"),
               "greedy_round": (ops, "greedy_round"),
               "gated_greedy_round": (ops, "gated_greedy_round"),
               "merge": (selection, "_merge_proposals")}
    out = {}
    with ThreadPoolExecutor(3) as ex:
        for name, n, d, k, slacks in PROBE_CASES:
            shards = _probe_shards(name, n, d, k, dev)
            for slack in slacks:
                stats = getattr(pf, "ENGINE_STATS", None)
                if stats is not None:
                    pf.reset_engine_stats()
                ops.reset_launches()
                torch.cuda.synchronize()
                with _Timers(targets) as tm:
                    t = time.perf_counter()
                    sel = pf.gated_greedy_select(rnglib.key(5), budget,
                                                 shards, slack=slack,
                                                 executor=ex)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t
                assert len(set(sel.tolist())) == budget
                per = 3 * (budget - 1)
                launches = dict(ops.LAUNCHES)
                rec = {"wall_s": wall, "launches": launches,
                       "host_s": tm.s, "calls": tm.calls,
                       "per_slot_shard": {
                           "b1_launches": launches["greedy_round"] / per,
                           "b5_launches":
                               launches["gated_greedy_round"] / per}}
                if stats is not None:
                    st = dict(stats)
                    rec["engine"] = st
                    rec["per_slot_shard"].update(
                        waves=st["waves"] / per, syncs=st["syncs"] / per,
                        segments_folded=st["segments_folded"] / per)
                else:
                    folds = tm.calls.get("fold_slices", 0)
                    rec["per_slot_shard"].update(
                        folds=folds / per, syncs=2 * folds / per)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    pf.gated_greedy_select(rnglib.key(6), 10, shards,
                                           slack=slack, executor=ex)
                    torch.cuda.synchronize()
                by_class = {"copies": 0.0, "launches": 0.0, "syncs": 0.0,
                            "other_ops": 0.0}
                for ev in prof.key_averages():
                    if ev.device_type == torch.autograd.DeviceType.CUDA:
                        continue
                    key = ev.key
                    us = ev.self_cpu_time_total
                    if "LaunchKernel" in key:
                        by_class["launches"] += us
                    elif ("local_scalar_dense" in key or "Synchronize" in key
                          or key.startswith("cudaMemcpy")):
                        by_class["syncs"] += us
                    elif any(w in key for w in ("copy_", "zeros", "full",
                                                "fill_", "empty", "_to_copy",
                                                "where")):
                        by_class["copies"] += us
                    elif key.startswith("aten::") or key.startswith("cuda"):
                        by_class["other_ops"] += us
                rec["profile_10_slots_host_ms"] = {
                    c: v / 1e3 for c, v in by_class.items()}
                out[f"{name}_{slack:g}"] = rec
                print(json.dumps({
                    "engine": SRC, "case": name, "shape": [n, d],
                    "clusters": k, "shards": 3, "budget": budget,
                    "slack": slack, "wave_engine": stats is not None, **rec}),
                    flush=True)
            del shards
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sections = {"flash_bf16": flash, "argmin": argmin, "flash32": flash32,
                "decode": decode, "round": greedy_round_variants,
                "unc": uncertainty_variants, "gated": gated_variants,
                "engine": engine_probe}
    args = sys.argv[1:]
    if "--parent" in args:
        k = args.index("--parent")
        args = args[:k] + args[k + 2:]
    for name in args or sections:
        sections[name](build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
