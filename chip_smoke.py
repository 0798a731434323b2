"""Chip smoke test for repro_torch: the port's main paths on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. env      card name and power limit, torch/CUDA versions, and the time
            to build the CUDA kernels from ``src/repro_torch`` (one nvcc
            per source, started together).
2. kernels  each kernel against its plain PyTorch version on the card at
            the main paths' shapes (values within the stated tolerance,
            indices exactly equal on planted ties and on separated rows),
            with its median time from CUDA events, its bound, the plain
            version's time and a PyTorch library call's time. The two
            selection kernels are held at d = 512 (resnet18 features) and
            d = 4,096 (qwen3-8b-wide text features), the argmin at both
            widths under the tile plan it picks; flash attention (fp32
            kernel) over 32 masks/shapes and timed at the text path's
            shape; the bf16 tensor-core kernel over 108 masks/shapes (D 16,
            64, 96 padded, 128 at G 1 and 4; D 256 at G 10; causal or
            not; row bytes independent of the rows launched), over the
            enc-dec and patch-prefix layouts (non-causal 512 x 1,500 and
            1,500 x 1,500 at D 64, G 1; G 7 at D 128, causal and
            512 x 1,500) and at the serve path's prefill shape (bf16
            out), timed there; B3 (bf16), B6 and B4 also held and timed
            at the other served archs' shapes where their paths run them
            (``at_serve_shapes``: prefill H/KH 48/8, 40/10, 20/20, 16/16,
            recurrentgemma-2b's 10/1 at D 256, window 2,048, whisper-
            medium's encoder (1,500 x 1,500), cross-attention (512 x
            1,500, both non-causal) and decoder (16/16 at D 64), and
            llava-next-34b's 56/8; the global-attention archs' decode
            steps, whisper's cross-attention step over all 1,500 frames
            (cur_len = cache = 1,500) among them; scores at 16 x 92,672,
            100,352, 152,064, 102,400, 65,536, 256,000, 51,968, 64,000
            and 129,280); the
            recurrent arithmetic's card oracles in fp32, TF32 off
            (``recurrent_oracles``: rwkv6-3b's chunked WKV against the
            sequential recurrence at B 16, S 512, H 40, D 64, chunk 64,
            within WKV_TOL; recurrentgemma-2b's RG-LRU log-depth scan
            against a stepwise float64 loop at B 16, S 512, W 2,560,
            within SCAN_TOL; each timed); the MLA card oracle
            (``mla_oracle``: deepseek-v3's absorbed decode at full width,
            H 128, kv rank 512, rope 64, one layer, B 16, 577 cached
            tokens of a 1,024-entry cache whose other rows hold noise,
            against the last row of the chunked prefill's expansion, fp32
            with TF32 off within the reference's 2e-4 and bf16 within
            MLA_BF16_TOL; the bf16 decode timed);
            gated_greedy_round at 50,000 x 512, n_block 256 (ragged last
            block): live share all / ~10 % / none, pending zeros and
            seeded, R 1 and 8, weights or not, planted ties across two
            live blocks, dead rows bit for bit, all-live R 8 equal to
            greedy_round bit for bit; with per-center forms (single
            centers in the difference form, chunks in the matmul form)
            at d = 32, 192 and 512, gate blocks of 256 and 32 rows and
            per-block cursors, bit for bit equal to one greedy_round
            launch per entry, per-block pairs included; timed at 100 %
            and ~10 % live in both forms, and as the prefilter engine
            calls it (a shard's gate-block layout, 200 queued centers);
            uncertainty_stats over 152,064-wide logits (N 1, 16, 4,096),
            ragged V, bf16, scale-80 logits and planted top-2 ties (mc
            exactly 0), timed at the decode shape (16 rows) and a
            pool-scoring shape (4,096 rows); decode_attention over the
            reference's four cases and the qwen3-8b decode shape (B 16,
            cache 1,024, cur_len 577, bf16, window none and 128; bytes
            equal across cache capacities 640 and 1,024 and across
            runs, as at each other served arch's decode shape), timed
            there warm in L2, L2-cold over rotating caches
            and by torch.profiler (the kernels' own device time), with
            the host's time to enqueue a call; greedy_round also timed
            at the prefilter's fold shape (256 x 512, R = 1).
            greedy_round's in-launch argmax and row bytes: ties planted
            in different CTAs go to the lower row as in the plain
            version; new min-dists, index and score are the same bytes
            under every rows-per-CTA candidate, over the 49,999-row
            prefix and with the centers read by index; the kernel's
            layout equals ``ops.round_plan``'s; two threads on two CUDA
            streams running k-center rounds at once equal serial runs.
            uncertainty_stats against its split-and-merge plain version,
            a row's bytes alone equal to its bytes among 4,096 rows, and
            top-2 ties straddling split boundaries (mc exactly 0). Timed
            by torch.profiler (warm and L2-cold), CUDA events and host
            µs a call: greedy_round at 50,000 x 512 and 2,048 x 4,096
            (R = 1), at R = r_block and at the fold shape;
            gated_greedy_round at 100 % and ~10 % live; uncertainty_stats
            at 16 and 4,096 rows; and a k-center round (``k_center_greedy``
            at the image and text pools' shapes): the device operations it
            launches (torch.profiler) and its wall time.
            ``python3 chip_smoke.py --kernels-only`` stops after this
            phase (no result lines).
3. picker   the block picker on the card: ``autotune_blocks(50,000, 512,
            measure=True)`` for the plain round and the gated round, into a
            temporary cache directory; each candidate ``n_block``'s time
            and the winner; then a lookup after clearing the in-memory
            cache must read the disk entry and launch nothing. Launch
            counts zeroed before and read after: the gated measurement
            must have launched gated_greedy_round.
4. server   the ALaaS Fig. 2 loop over TCP: an ALServer with resnet18 on
            the GPU, a 50,000-image 32x32x3 pool pushed by ALClient, a
            10,000-image eval set, lc/mc/rc/es/kcg/dbal queries of 1,000,
            label + train_eval, a warm-started coreset query, and one
            PSHEA ("auto") run of budget 2,000. Every kernel's launch
            count is zeroed just before this phase and read just after
            it; each selection kernel must have launched, flash attention
            not at all (ResNet has no attention). A badge query too (the
            sharded phase compares it).
   standing  then, on the same server over TCP, a coreset standing
            query (budget 1,000, rng 2) registered after the lc picks are
            labeled: six deltas of 256 near-duplicates of labeled images
            (N(0, 1e-4) noise), each a sync push and a poll, then 1,024
            fresh images, then a near-duplicate delta pushed
            asynchronously (its emit is the ingest worker's). Every emit's
            keys equal a one-shot query's at that moment; the modes are
            replay x 6, then full; a replay emit runs 999 B1 rounds over
            the delta rows and reads back once. Logs each emit's mode,
            wall ms, B1 launches, ``pool_rows`` and readbacks, and the
            full over replay ``pool_rows`` ratio. Launch counts zeroed
            just before, read just after (the ``standing`` path).
5. agree    k-center greedy (budget 1,000) over the server's own features
            through the kernel and through the plain version; prints the
            rounds before the first divergence.
6. sharded  the image pool (resnet18, 50,000 images, budget 1,000) on
            servers with ``replicas: 3`` (thread lanes), pushed in-process
            with ALClient(local=...): lc/kcg/dbal/badge and a warm coreset
            (the labeled set of phase 4) select keys equal to phase 4's
            ``replicas: 1`` server; with ``prefilter: true`` at slack 1e6
            (every cluster live) lc/kcg/coreset equal ``prefilter:
            false``'s, and so do they at the default slack 0.05, with
            their ``pool_rows`` against the full scan printed (kcg and
            coreset at budget 1,000 and 200); with
            ``strategy_state_cache: false`` the warm
            coreset (min-dists from scratch) equals the persisted state's
            keys. Then the reference benchmark's clumped pool (12,288 x
            192 vectors, 97 % near-duplicates in 48 clumps, MLP backend)
            at ``replicas: 3``: prefilter off, on at slack 0.05 and at
            1e9; gated lc/es/coreset/kcg keys equal the full scan's, and
            at 0.05 lc and coreset touch >= 10x fewer pool rows (the
            gate prunes clusters here). Launch counts zeroed before each
            server, read after. Every gated k-center query logs the
            prefilter engine's waves, gated_greedy_round launches and
            host syncs per (slot, shard); its kcg launches no
            greedy_round. The ``replicas: 3`` server then runs the
            standing phase on the same stream (same checks), and the
            ``strategy_state_cache: false`` server takes the stream with
            full emits only; both final selections equal replicas 1's.
   process  ``worker_backend: process`` at ``replicas: 3`` (ResNet-18 on
            the card in each spawned child, ``cache_bytes: 1`` so every
            artifact build re-embeds through ``embed_batch`` jobs) beside
            a ``thread`` server fed the same pushes; the pool cut to
            8,192 images. The children's first jobs (start s, device
            memory each) return the inline chunk's bytes exactly; coreset
            and kcg at budget 256 select the thread server's keys; lane
            0's child is SIGKILLed at its first job of a query after a
            768-row push, and the query still returns the thread server's
            keys with the lane restarted. Logs jobs and re-embed rows/s
            through jobs against inline. Launch counts zeroed before,
            read after (the ``process`` path).
7. bitwise  the text encoder (qwen3-8b widths, 4 layers, flash kernel):
            features of 64 sequences bit-identical at block sizes 96, 128
            and 512 (on the card ``block`` reaches no kernel, so this holds
            by construction; the kernels phase's check that a row's bytes
            do not depend on the query rows launched is what can fail),
            bit-identical when the sequences are batched with other
            batchmates (a permutation), and within the stated tolerance
            of the chunked path; then one 32-sequence batch under
            torch.profiler (device time by kernel class).
8. text     text AL over TCP: an ALServer with that TransformerBackend, a
            2,048-sequence token pool (lengths 256-512, vocab 151,936)
            pushed 256 at a time, a 512-sequence eval set, lc/kcg/dbal/
            coreset queries of 256, label 256 + train_eval. Launch counts
            are zeroed just before and read just after; all three kernels
            must have launched, flash attention once per layer per encoder
            call (64 pool batches and the eval set's one call).
9. serve    LLM serving with per-step uncertainty scores, one path per
            served arch (qwen3-8b, internlm2-20b, phi3-medium-14b,
            qwen1.5-4b, deepseek-moe-16b, rwkv6-3b, recurrentgemma-2b,
            whisper-medium, llava-next-34b, deepseek-v3-671b):
            ``run_serving`` of the arch's full config at full width and all
            layers in bf16 (random weights from seed 0; deepseek-v3 at 5 of
            its 61 layers, ``SERVE_DEPTH``: its 3 dense MLA layers and 2 of
            its 58 MoE MLA layers, 54.6 GB, served as a config), batch 16,
            512-token prompts, 64 greedy decode steps, cache 1,024
            (whisper's frontend 1,500 zero frames, llava's 512 zero patch
            embeddings, as the reference's). Launch counts are zeroed just
            before and read just after: flash attention once per attention
            layer, global or local, encoder layer and cross-attention layer
            (prefill; none at rwkv6-3b, 8 at recurrentgemma-2b, 72 at
            whisper, none at deepseek-v3, whose MLA runs no attention
            kernel), decode attention once per global attention layer and
            cross-attention layer per step (none at either recurrent arch or
            deepseek-v3, 48 at whisper), uncertainty_stats once per step,
            the selection kernels never. Then prefill + 8 teacher-forced
            steps through the kernel path and through the plain path
            (``attention_impl="chunked"``, plain scores), same weights,
            tokens and seeded N(0, 1) frames or patch embeddings, held
            within AGREE_TOL (the MoE's plain path first with its own
            routes, the route-flip shares printed, then with the kernel
            path's routes forced, held); whisper's and llava's kernel path
            also runs on zero frames or patches, and the logits' largest
            difference from the seeded run must exceed AGREE_TOL's (the
            frontend reaches the logits); and a torch.profiler window over a
            prefill and 4 decode steps (device time by kernel class: the
            device's busy share). Each model is freed before the next
            (llava-next-34b, 68.8 GB of weights, then deepseek-v3, 54.6 GB);
            peak device memory is printed per arch.

10. train  ``run_training`` of qwen1.5-4b's full config (full width,
            all 40 layers, 3.95 B params in bf16, AdamW with fp32 state,
            remat), B 4 x S 512, 20 steps at lr 3e-4 with warmup 5, TF32
            off, no checkpoint: every loss finite and the mean of the last
            5 below the first 5's; the median step after 3 warm-up steps,
            tokens/s, ``train_mfu`` (6 * n_params * tokens / step time /
            989 TFLOP/s, the bf16 dense peak) and peak memory. Launch
            counts zeroed before, read after: the path runs no
            hand-written kernel (chunked attention and a plain
            cross-entropy, as the reference trains). Then
            ``train_profile``, from two steps of that same run: step 19
            split by CUDA events into the forward + backward and the
            optimizer's update, step 20 under torch.profiler (busy share,
            top kernels).
    train_resume  the smoke config on the card with ``ckpt_every=5,
            fail_at=[8]``, 16 steps: one restart, the last checkpoint at
            16; the step-16 checkpoint restored onto the card, saved from
            there again (sync and async) and restored, equal bit for bit.
    al_train  ``repro_torch.examples.al_train_loop`` at qwen1.5-4b's full
            width, 4 layers: pool 256 x 48, 3 rounds of budget 32, 30
            fine-tune steps a round, es and random: every loss finite, the
            loss on the labeled rows down by more than AL_MIN_FALL from
            the weights before round 0 to those after round 3; held-out
            losses and seconds a round logged.
11. mesh   the mesh half of selection (``core/selection.py``) on debug
            meshes of spawned ranks (``launch/mesh.py``): world 1 over
            NCCL, 2 and 4 over gloo, every rank on cuda:0, at the
            distributed-selection example's pool (65,536 x 64, 512
            classes, budget 128) and the image path's 50,000 x 512
            (budget 1,000); k-center unweighted and weighted. Every B1
            round of a second k-center run held against the plain round
            on its inputs (``CheckedRounds``) and every rank's B4 scores
            against the plain scores; indices equal across world sizes
            and to the checked run's, top-k equal to the unsharded B4
            scores' ``stable_top_k``, the sharded scores and the seed's
            min-dists equal to the unsharded rows bit for bit, B1
            launches world x (budget - 1) a k-center and B4 world a
            scoring; ms a k-center round and a round's all_gather alone
            at each world size.

The last three lines are the card's name and power limit as nvidia-smi
gives them, ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, when there is no CUDA device or the
package is not beside this file.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
POOL, EVAL, HW, BUDGET, AUTO_BUDGET = 50_000, 10_000, 32, 1_000, 2_000
BATCH_IMG = 256                          # the image path's batch
D = 512                                  # resnet18 feat_dim
HBM_BYTES_S = 3.35e12                    # H100 SXM HBM3
FP32_FLOPS_S = 67e12                     # H100 SXM fp32, outside tensor cores
ATOL = 1e-5                              # fp32 values, at O(1) sq-distances
REPS, INNER = 15, 10                     # timing samples, calls per sample
PROFILED_CALLS = 30                      # calls under torch.profiler
PROFILE_ATTEMPTS = 3                     # profiler sessions before events
FOLD_ROWS = 256            # the prefilter's largest fold slice (unclumped)
L2_BYTES = 50e6                          # H100 SXM L2
WIDE = 4_096                             # qwen3-8b d_model: text features
FLASH_ATOL = 2e-5          # fp32 attention outputs, O(1) (means of N(0,1))
FEAT_ATOL = 1e-4           # pooled O(1) text features, kernel vs chunked
TEXT_POOL, TEXT_EVAL, TEXT_SEQ, TEXT_BUDGET = 2_048, 512, 512, 256
TEXT_LAYERS, TEXT_BATCH, TEXT_PUSH = 4, 32, 256
BF16_FLOPS_S = 989e12                    # H100 SXM bf16 tensor cores, dense
VOCAB = 152_064            # qwen3-8b padded vocab: the serving logits' width
# uncertainty scores, kernel vs plain: |d| <= tol + tol * |plain| (the
# reference's fp32 and scale-80 tolerances, tests/test_kernels.py). Both
# sides upcast bf16 logits to fp32 before any arithmetic, so bf16 inputs
# are held at the fp32 tolerance.
UNC_TOL = {"fp32": 3e-5, "scale80": 1e-4}
# decode / bf16 flash attention, kernel vs plain, as allclose(rtol=atol=tol):
# the reference's tolerances at fp32 and, for flash, bf16. Decode at bf16
# is held at 1e-2: its outputs at the qwen3 shape are ~0.07 (means of
# N(0,1) values over 577 keys), so the reference's 3e-2 would be half
# a typical value.
ATT_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
DECODE_BF16_TOL = 1e-2
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX = 16, 512, 64, 1_024
# the served configs, each at full width and depth in bf16 (but for
# SERVE_DEPTH); qwen3-8b first, then the rest, llava-next-34b (68.8 GB of
# weights) and deepseek-v3-671b (54.6 GB) last
SERVE_ARCHS = ("qwen3_8b", "internlm2_20b", "phi3_medium_14b", "qwen15_4b",
               "deepseek_moe_16b", "rwkv6_3b", "recurrentgemma_2b",
               "whisper_medium", "llava_next_34b", "deepseek_v3_671b")
# depth cuts: deepseek-v3-671b's 61 layers need 1,342 GB in bf16; one H100
# holds its 3 dense MLA layers, 2 of its 58 MoE MLA layers (22.5 GB of
# routed experts each), the embeddings, the LM head and the MTP head:
# 54.6 GB. Every width is kept.
SERVE_DEPTH = {"deepseek_v3_671b": 5}
SERVE_CUR = 577                          # a decode step's cur_len, timed
# card oracles of the recurrent arithmetic in fp32, TF32 off. The chunked
# WKV against the sequential recurrence: max |d| <= WKV_TOL * max |out|.
# The reference holds 2e-4 absolute at D 8, where outputs reach ~20
# (tests/test_models.py); at rwkv6-3b's D 64 they reach ~90 and the
# reference's own chunked path is 3.3e-4 from a float64 recurrence on the
# CPU (3.7e-6 of the largest output), so the bound scales with the
# outputs, with a 5x margin. The RG-LRU scan against a stepwise float64
# loop: the reference's 1e-4 (rtol = atol), its outputs being O(1).
WKV_TOL = 2e-5
SCAN_TOL = 1e-4
# the MLA oracle in bf16: absorbed decode against the expansion's last row
# as allclose(rtol=atol=MLA_BF16_TOL). Both round to bf16 in other places
# (the expansion its per-head K/V, the attention output and q; the
# absorbed form q_lat and p); the outputs reach ~0.8 (a bf16 step 2**-8 at
# 0.5-1, the largest difference seen on the CPU at these widths, B 2,
# S 65), so the bar is ~5 steps. fp32 is held at the reference's 2e-4.
MLA_BF16_TOL = 2e-2
MLA_CACHED = 577                         # cached tokens of SERVE_MAX
AGREE_STEPS = 8
KINDS = ("lc", "mc", "rc", "es")


START = time.perf_counter()


def log(phase, **kw):
    """One JSON line: the phase, its fields, and ``at_s``, the seconds
    since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - START}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=REPS, inner=INNER) -> float:
    """Median over ``reps`` samples of the device time per call, each
    sample ``inner`` calls back to back between two CUDA events, so the
    host's launch time overlaps the device's work instead of adding to it
    (one call between two events on an idle device also counts the
    wrapper's Python before the launch)."""
    fn()                                         # warm-up
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


def profiled_ms(fn, key, calls=PROFILED_CALLS,
                attempts=PROFILE_ATTEMPTS) -> float:
    """Device time per call of the kernels whose names hold ``key``, from
    torch.profiler over ``calls`` calls of ``fn`` (after a warm-up): the
    kernels' own durations, with no host time and no gaps. The profiler's
    CUPTI trace now and then comes back without the device's kernels; such
    a session is taken again, up to ``attempts`` in all, and if none saw
    the kernels the time is that of CUDA events around the calls
    (``median_ms``), logged as a ``profiler_miss``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for ev in prof.key_averages():
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and key in ev.key):
                t = getattr(ev, "self_device_time_total", None)
                us += ev.self_cuda_time_total if t is None else t
        if us > 0.0:
            return us / 1e3 / calls
    ms = median_ms(fn)
    log("profiler_miss", key=key, attempts=attempts, event_ms=ms)
    return ms


def host_us(fn, calls=PROFILED_CALLS) -> float:
    """Host time per call to enqueue ``fn`` back to back (the device
    drained before and after): what one Python call costs the host."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def ptxas_report(logs):
    """{kernel source: {"<function>[<template arg>]": [registers, spill
    store bytes]}} from the build's ``-Xptxas -v`` logs."""
    out = {}
    for name, text in logs.items():
        funcs, cur = {}, None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                f = re.search(r"([a-z_]+_kernel)(?:I(.*?)E+v)?", m.group(1))
                targs = f.group(2) or ""
                args = (["bf16"] if "__nv_bfloat16" in targs else
                        ["f32"] if targs.startswith("f") else [])
                args += re.findall(r"L[ib](\d+)E", targs + "E")
                cur = f.group(1) + (f"<{','.join(args)}>" if args else "")
                funcs[cur] = [None, None]
            elif cur and "spill stores" in line:
                funcs[cur][1] = int(re.search(r"(\d+) bytes spill stores",
                                              line).group(1))
            elif cur and "Used" in line and "registers" in line:
                funcs[cur][0] = int(re.search(r"Used (\d+) registers",
                                              line).group(1))
        out[name] = funcs
    return out


def bound(nbytes: float, flops: float, flops_s: float = FP32_FLOPS_S):
    t_b, t_f = nbytes / HBM_BYTES_S, flops / flops_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def within_scale(got, want, tol) -> float:
    """max |got - want|, asserting it is <= tol * max |want|."""
    d = float((got.float() - want.float()).abs().max())
    assert d <= tol * float(want.float().abs().max()), d
    return d


def within(got, want, tol) -> float:
    """max |got - want|, asserting |got - want| <= tol + tol * |want|."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    assert bool((d <= tol + tol * want.abs()).all()), float(d.max())
    return float(d.max())


# --------------------------------------------------------------- kernels --
def check_greedy(ops, dev, rng):
    """greedy_round at N = 50,000 (and ragged 49,999), d = 512, R in
    {1, 8, r_block}, weighted and unweighted, carried-in -1 rows and a
    planted exact tie (two identical far rows: the lower index must win;
    they sit 256 rows apart, at the same offset in any power-of-two tile,
    so the plain version's matrix product treats them alike too)."""
    from repro_torch.kernels.pairwise import autotune
    r_block = autotune.model_blocks(POOL, D).r_block
    worst, cases = 0.0, 0
    for n in (POOL, POOL - 1):
        x = torch.from_numpy((rng.standard_normal((n, D)) * 0.05).astype(
            np.float32)).to(dev)
        tie = (1234, 1234 + 256 * ((n - 1235) // 512))
        x[tie[1]] = x[tie[0]] = x[tie[0]] * 3.0
        others = np.setdiff1d(np.arange(n), tie)
        for r in (1, 8, r_block):
            for weighted in (False, True):
                mind = torch.full((n,), 3.4e38, device=dev)
                mind[torch.from_numpy(rng.choice(others, 500, replace=False))
                     .to(dev)] = -1.0
                sel = torch.from_numpy(rng.choice(
                    others, r, replace=False).astype(np.int32)).to(dev)
                w = None
                if weighted:
                    w = torch.rand(n, device=dev)
                    w[tie[0]] = w[tie[1]] = 1.0
                args = (x, mind, x[sel.long()], sel, w)
                kn, ki, ks = ops.greedy_round(*args)
                pn, pi, ps = ops.greedy_round(*args, impl="ref")
                torch.cuda.synchronize()
                err = float((kn - pn).abs().max())
                assert err <= ATOL, (n, r, weighted, err)
                assert int(ki) == int(pi) == tie[0], (n, r, weighted,
                                                      int(ki), int(pi))
                assert abs(float(ks) - float(ps)) <= ATOL * max(
                    1.0, abs(float(ps)))
                worst, cases = max(worst, err), cases + 1
    return worst, cases, r_block


def time_greedy(ops, dev, rng):
    """The k-center round the main path runs most: R = 1, unweighted, at
    50,000 x 512; and at the prefilter's fold shape, 256 x 512 (the
    largest ``_bucket`` a segment fold pads to on the unclumped pool),
    where the CUDA events measure the wrapper's host time as much as the
    kernel, so the profiler's device time a launch stands beside them."""
    x = torch.from_numpy((rng.standard_normal((POOL, D)) * 0.05).astype(
        np.float32)).to(dev)
    mind = torch.full((POOL,), 3.4e38, device=dev)
    c, sel = x[7:8], torch.tensor([7], dtype=torch.int32, device=dev)
    ms = median_ms(lambda: ops.greedy_round(x, mind, c, sel))
    plain = median_ms(lambda: ops.greedy_round(x, mind, c, sel, impl="ref"))
    nb = -(-POOL // 64)
    nbytes = 4 * (POOL * D + D + 1 + 2 * POOL + 2 * nb)
    n = FOLD_ROWS
    xs, ms_ = x[:n].contiguous(), mind[:n].clone()
    fold = {"timed_shape": [n, D, 1],
            "ms": median_ms(lambda: ops.greedy_round(xs, ms_, c, sel)),
            "device_ms": profiled_ms(lambda: ops.greedy_round(xs, ms_, c, sel),
                                     "greedy_round"),
            "plain_ms": median_ms(
                lambda: ops.greedy_round(xs, ms_, c, sel, impl="ref"))}
    fb = 4 * (n * D + D + 1 + 2 * n + 2 * -(-n // 64))
    fold["bound_ms"], fold["bound_by"] = bound(fb, 3.0 * n * D)
    return ms, plain, bound(nbytes, 3.0 * POOL * D), fold


def round_shapes():
    """B1's timed shapes (n, d, R): the image pool's k-center round, the
    text pool's, the Core-Set warm start's chunk (R = the model's
    r_block) and the prefilter's fold slice."""
    from repro_torch.kernels.pairwise import autotune
    return ((POOL, D, 1), (TEXT_POOL, WIDE, 1),
            (POOL, D, autotune.model_blocks(POOL, D).r_block),
            (FOLD_ROWS, D, 1))


def time_round(ops, dev):
    """B1 at each of ``round_shapes``, unweighted, as a main path calls it
    (``ops.greedy_round``, default rows per CTA): the CUDA-event median;
    torch.profiler's device time of the round's kernel(s) a call, warm
    and L2-cold (rotating over enough pools, mind-dists with them, that
    each call finds its own out of the 50 MB L2); the device time of every
    kernel the call launches; the host's µs to enqueue a call. Bound: the
    pool read once, mind in and out, the centers; against 3·n·d
    operations at R = 1 and 2·n·R·d above."""
    g = torch.Generator(device=dev).manual_seed(7)
    out = []
    for n, d, r in round_shapes():
        sets = max(2, int(2 * L2_BYTES // (4 * n * d)) + 2)
        xs = torch.randn((sets, n, d), generator=g, device=dev) * (
            0.05 / np.sqrt(d / D))
        minds = torch.full((sets, n), 3.4e38, device=dev)
        c = xs[0, 7:7 + r].clone()
        sel = (torch.tensor([7], dtype=torch.int32, device=dev) if r == 1
               else torch.full((r,), -1, dtype=torch.int32, device=dev))
        turn = [0]

        def warm():
            return ops.greedy_round(xs[0], minds[0], c, sel)

        def cold():
            i = turn[0] % sets
            turn[0] += 1
            return ops.greedy_round(xs[i], minds[i], c, sel)
        nbytes = 4.0 * (n * d + r * d + 2 * n)
        bnd, by = bound(nbytes, 3.0 * n * d if r == 1 else 2.0 * n * r * d)
        out.append({"shape": [n, d, r], "ms": median_ms(warm),
                    "device_ms": profiled_ms(warm, "greedy_round"),
                    "cold_device_ms": profiled_ms(cold, "greedy_round"),
                    "call_device_ms": profiled_ms(warm, ""),
                    "host_us": host_us(warm), "bound_ms": bnd,
                    "bound_by": by, "cold_pools": sets})
        del xs, minds
    return out


def device_launches(fn):
    """{kernel name: launches} of one call of ``fn`` under torch.profiler
    (copies and fills included)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


def check_round_bytes(ops, dev, rng):
    """B1's in-launch argmax and its row bytes at 50,000 x 512, R in {1, 8,
    r_block}, weighted or not, with an exact tie planted in rows 100 and
    40,100 (other CTAs under every rows per CTA): the index equals the
    plain version's and the lower tie row; new min-dists, index and score
    are the same bytes under every rows-per-CTA candidate of the picker
    and the default plan, over the 49,999-row prefix (its rows), and with
    the centers read by index in place of gathered rows. Also: the
    kernel's difference-form layout equals ``ops.round_plan``'s at d in
    {32, 96, 192, 512, 513, 4,096}."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.pairwise import autotune
    lib = build.load("greedy_round")
    for d in (32, 96, 192, D, D + 1, WIDE):
        got = (ctypes.c_int * 4)()
        lib.greedy_round_layout(ctypes.c_int(d), got)
        p = ops.round_plan(POOL, d)
        assert list(got) == [p.chunk, p.lanes, p.chunks_in_flight,
                             p.rows_in_flight], (d, list(got), p)
    x = torch.from_numpy((rng.standard_normal((POOL, D)) * 0.05).astype(
        np.float32)).to(dev)
    tie = (100, 40_100)
    x[tie[1]] = x[tie[0]] = x[tie[0]] * 3.0
    plans = sorted(set(autotune.N_BLOCK_CANDIDATES) |
                   {ops.round_plan(POOL, D, r).rows_per_cta
                    for r in (1, 8)})
    cases = 0
    for r in (1, 8, autotune.model_blocks(POOL, D).r_block):
        idx = torch.from_numpy(rng.choice(
            np.setdiff1d(np.arange(POOL), tie), r, replace=False).astype(
                np.int32)).to(dev)
        sel = idx if r == 1 else torch.full_like(idx, -1)
        for weighted in (False, True):
            w = None
            if weighted:
                w = torch.rand(POOL, device=dev)
                w[tie[0]] = w[tie[1]] = 1.0
            mind = torch.full((POOL,), 3.4e38, device=dev)
            base = ops.greedy_round(x, mind, x[idx.long()], sel, w)
            _, pi, _ = ops.greedy_round(x, mind, x[idx.long()], sel, w,
                                        impl="ref")
            assert int(base[1]) == int(pi) == tie[0], (r, weighted,
                                                       int(base[1]), int(pi))
            variants = [ops.greedy_round(x, mind, x[idx.long()], sel, w,
                                         n_block=nb) for nb in plans]
            variants.append(ops.greedy_round(x, mind, idx, sel, w))
            for v in variants:
                assert all(torch.equal(a, b) for a, b in zip(v, base)), \
                    (r, weighted, "rows per CTA or index centers")
            pre = ops.greedy_round(x[:POOL - 1], mind[:POOL - 1],
                                   x[idx.long()], sel,
                                   None if w is None else w[:POOL - 1])
            assert torch.equal(pre[0], base[0][:POOL - 1]), (r, "prefix")
            cases += len(variants) + 2
    return {"cases": cases, "rows_per_cta": plans, "tie": list(tie)}


def check_round_streams(ops, dev):
    """Two threads, each on a CUDA stream of its own, run 64 k-center rounds
    at once (each round's argmax elected by the stream's own ticket) on
    pools of their own; their picks and final min-dists equal serial runs'
    bytes."""
    import threading
    g = torch.Generator(device=dev).manual_seed(9)
    pools = [torch.randn((POOL, D), generator=g, device=dev) * 0.05,
             torch.randn((TEXT_POOL, WIDE), generator=g, device=dev) * 0.01]

    def rounds(x):
        mind = torch.full((x.shape[0],), 3.4e38, device=dev)
        nxt = torch.tensor(3, dtype=torch.int32, device=dev)
        picks = []
        for _ in range(64):
            idx = nxt.reshape(1)
            mind, nxt, _ = ops.greedy_round(x, mind, idx, idx)
            picks.append(nxt)
        return torch.stack(picks), mind

    serial = [rounds(x) for x in pools]
    torch.cuda.synchronize()
    out, start = [None, None], threading.Barrier(2)

    def lane(i):
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            start.wait()
            out[i] = rounds(pools[i])
        s.synchronize()
    threads = [threading.Thread(target=lane, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (sp, sm), (cp, cm) in zip(serial, out):
        assert torch.equal(sp, cp) and torch.equal(sm, cm), \
            "concurrent rounds differ from serial ones"
    return {"threads": 2, "rounds": 64, "equal_to_serial": True}


def time_kcenter(dev):
    """k-center greedy (``k_center_greedy``, seeded first pick) over random
    pools at the image path's (50,000 x 512, budget 1,000) and text path's
    (2,048 x 4,096, budget 256) shapes: the device operations a round
    launches, counted by torch.profiler as the difference between budgets
    48 and 16 over 32 rounds (by kernel name), and the wall time a round
    over the full budget."""
    from repro_torch.common import rng as rnglib
    from repro_torch.core.strategies.diversity import k_center_greedy
    g = torch.Generator(device=dev).manual_seed(8)
    out = {}
    for path, n, d, budget in (("image", POOL, D, BUDGET),
                               ("text", TEXT_POOL, WIDE, TEXT_BUDGET)):
        x = torch.randn((n, d), generator=g, device=dev) * (
            0.05 / np.sqrt(d / D))
        k = rnglib.key(0)
        k_center_greedy(k, 8, x)                         # warm
        few, many = (device_launches(lambda b=b: k_center_greedy(k, b, x))
                     for b in (16, 48))
        per_round = {name: (many.get(name, 0) - few.get(name, 0)) / 32
                     for name in many}
        torch.cuda.synchronize()
        t = time.perf_counter()
        k_center_greedy(k, budget, x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        out[path] = {"shape": [n, d], "budget": budget,
                     "launches_per_round": sum(per_round.values()),
                     "by_kernel": {k_: v for k_, v in per_round.items() if v},
                     "wall_s": wall, "ms_per_round": wall / budget * 1e3}
        del x
    return out


GATED_NB = 256                            # the reference's default gate block


def _gated_case(ops, dev, rng, x, live_share, pending, r, weighted):
    """One gated round at (x.shape, n_block GATED_NB) against its plain
    version: min-dists within ATOL, dead rows bit for bit, the index
    exactly equal where the plain version's top two scores are separated
    by more than 10 * ATOL (else the kernel's pick must score within ATOL
    of the max). Returns max |d|."""
    n = x.shape[0]
    nn = -(-n // GATED_NB)
    live = (torch.ones(nn, dtype=torch.int32) if live_share == 1.0 else
            torch.from_numpy((rng.uniform(size=nn) < live_share)
                             .astype(np.int32)))
    pend = (torch.zeros(nn, dtype=torch.int32) if not pending else
            torch.from_numpy(rng.integers(0, r + 1, nn).astype(np.int32)))
    live, pend = live.to(dev), pend.to(dev)
    mind = torch.from_numpy((np.abs(rng.standard_normal(n)) * 3.0).astype(
        np.float32)).to(dev)
    mind[torch.from_numpy(rng.choice(n, 500, replace=False)).to(dev)] = -1.0
    c = x[torch.from_numpy(rng.choice(n, r, replace=False)).to(dev)]
    w = torch.rand(n, device=dev) if weighted else None
    kn, ki, ks = ops.gated_greedy_round(x, mind, c, live, pend, w,
                                        n_block=GATED_NB)
    pn, pi, ps = ops.gated_greedy_round(x, mind, c, live, pend, w,
                                        n_block=GATED_NB, impl="ref")
    torch.cuda.synchronize()
    err = float((kn - pn).abs().max())
    assert err <= ATOL, ("gated", live_share, pending, r, weighted, err)
    dead = torch.repeat_interleave(live == 0, GATED_NB)[:n]
    assert torch.equal(kn[dead], mind[dead]), "dead rows not copied"
    score = ops.masked_weighted_score(pn, w)
    score = torch.where(torch.repeat_interleave(live > 0, GATED_NB)[:n],
                        score, -3.4e38)
    top2 = torch.topk(score, 2).values
    if float(top2[0] - top2[1]) > 10 * ATOL:
        assert int(ki) == int(pi), ("gated index", int(ki), int(pi))
    else:
        assert abs(float(score[int(ki)]) - float(top2[0])) <= ATOL
    assert abs(float(ks) - float(ps)) <= ATOL * max(1.0, abs(float(ps)))
    return err


def check_gated(ops, dev, rng):
    """gated_greedy_round at N = 50,000 (ragged last block of 80 rows), d =
    512, n_block 256: live share all / ~10 % / none x pending zeros or
    seeded in [0, R] x R in {1, 8} x weights or not; planted exact ties
    across two live blocks (the lower index must win); all-live,
    zero-pending R = 8 against greedy_round, bit for bit."""
    x = torch.from_numpy((rng.standard_normal((POOL, D)) * 0.05).astype(
        np.float32)).to(dev)
    worst, cases = 0.0, 0
    for live_share in (1.0, 0.1, 0.0):
        for pending in (False, True):
            for r in (1, 8):
                for weighted in (False, True):
                    worst = max(worst, _gated_case(
                        ops, dev, rng, x, live_share, pending, r, weighted))
                    cases += 1
    # planted ties: two identical far rows in blocks 4 and 100, both live
    nn = -(-POOL // GATED_NB)
    tie = (4 * GATED_NB + 17, 100 * GATED_NB + 17)
    xt = x.clone()
    xt[tie[1]] = xt[tie[0]] = xt[tie[0]] * 3.0
    live = torch.from_numpy((rng.uniform(size=nn) < 0.1).astype(
        np.int32)).to(dev)
    live[4] = live[100] = 1
    pend = torch.zeros(nn, dtype=torch.int32, device=dev)
    mind = torch.full((POOL,), 3.4e38, device=dev)
    for r in (1, 8):
        c = xt[:r]
        for weighted in (False, True):
            w = None
            if weighted:
                w = torch.rand(POOL, device=dev)
                w[tie[0]] = w[tie[1]] = 1.0
            _, ki, _ = ops.gated_greedy_round(xt, mind, c, live, pend, w,
                                              n_block=GATED_NB)
            _, pi, _ = ops.gated_greedy_round(xt, mind, c, live, pend, w,
                                              n_block=GATED_NB, impl="ref")
            assert int(ki) == int(pi) == tie[0], (r, weighted, int(ki),
                                                  int(pi))
            cases += 1
    # all live, nothing pending, R = 8: the plain fused round's floats
    ones = torch.ones(nn, dtype=torch.int32, device=dev)
    c8 = x[1000:1008]
    for w in (None, torch.rand(POOL, device=dev)):
        gn, gi, gs = ops.gated_greedy_round(x, mind, c8, ones, pend, w,
                                            n_block=GATED_NB)
        bn, bi, bs = ops.greedy_round(
            x, mind, c8, torch.full((8,), -1, dtype=torch.int32, device=dev),
            w)
        torch.cuda.synchronize()
        assert torch.equal(gn, bn) and int(gi) == int(bi) and \
            float(gs) == float(bs), "all-live gated != greedy_round"
        cases += 1
    return worst, cases


def time_gated(ops, dev, rng):
    """R = 1, zero pending, unweighted, n_block 256, at 100 % and ~10 %
    live, in the matmul form (no forms, the reference's) and in the
    difference form (forms [0], the prefilter's single centers), at the
    plan's tile. Bound by bytes, each stream the timed call moves once:
    the live rows of x, mind in and out (N each), the R centers,
    block_live and block_pending in and the (max, index) pairs out (nn
    each), all 4 bytes: 4 * (live rows * d + 2 * N + R * d + 4 * nn). No
    weights."""
    x = torch.from_numpy((rng.standard_normal((POOL, D)) * 0.05).astype(
        np.float32)).to(dev)
    mind = torch.full((POOL,), 3.4e38, device=dev)
    nn = -(-POOL // GATED_NB)
    pend = torch.zeros(nn, dtype=torch.int32, device=dev)
    c = x[7:8]
    diff = torch.zeros(1, dtype=torch.int8, device=dev)
    out = {}
    for share in (1.0, 0.1):
        live = (torch.ones(nn, dtype=torch.int32) if share == 1.0 else
                torch.from_numpy((rng.uniform(size=nn) < share).astype(
                    np.int32))).to(dev)
        lv = live.cpu().numpy().nonzero()[0]
        rows = int(sum(min(GATED_NB, POOL - b * GATED_NB) for b in lv))
        def call(forms=None):
            return ops.gated_greedy_round(x, mind, c, live, pend,
                                          n_block=GATED_NB, forms=forms,
                                          matmul=None if forms is None
                                          else False)
        ms = median_ms(call)
        plain = median_ms(lambda: ops.gated_greedy_round(
            x, mind, c, live, pend, n_block=GATED_NB, impl="ref"))
        bnd, by = bound(4.0 * (rows * D + 2 * POOL + D + 4 * nn),
                        3.0 * rows * D)
        out[share] = {"live_blocks": len(lv), "blocks": nn, "live_rows": rows,
                      "tile_rows": ops.gated_plan(POOL, D, GATED_NB),
                      "ms": ms, "device_ms": profiled_ms(
                          call, "gated_greedy_round"),
                      "call_device_ms": profiled_ms(call, ""),
                      "host_us": host_us(call), "plain_ms": plain,
                      "bound_ms": bnd, "bound_by": by,
                      "difference_form": {
                          "ms": median_ms(lambda: call(diff)),
                          "device_ms": profiled_ms(lambda: call(diff),
                                                   "gated_greedy_round")}}
    return out


# The prefilter engine's wave at the sharded image pool: a shard's
# ~16,700 rows in 64 segments padded to gate blocks of 32 rows, one queued
# center a slot in the difference form (R = 200 by slot 200), every block
# one center behind (the slot's new center), all or ~10 % of the segments'
# blocks live.
WAVE_ROWS, WAVE_R = 16_672 + 64 * 16, 200


def time_wave(ops, dev, rng):
    """``gated_greedy_round`` as the engine calls it (n_block =
    prefilter.GATE_ROWS, forms all 0, block_pending R - 1, per-block
    pairs), at 100 % and ~10 % live: CUDA-event ms, device ms,
    the plain version's ms, the bound (bytes: live rows of x, mind in and
    out, the pending centers, the block vectors and pairs) and the
    library call's: none (no single PyTorch call folds a gate mask)."""
    from repro_torch.core.prefilter import GATE_ROWS
    n, nb, r = WAVE_ROWS, GATE_ROWS, WAVE_R
    nn = n // nb
    x = torch.from_numpy((rng.standard_normal((n, D)) * 0.05).astype(
        np.float32)).to(dev)
    c = torch.from_numpy((rng.standard_normal((r, D)) * 0.05).astype(
        np.float32)).to(dev)
    forms = torch.zeros(r, dtype=torch.int8, device=dev)
    mind = torch.full((n,), 3.4e38, device=dev)
    pend = torch.full((nn,), r - 1, dtype=torch.int32, device=dev)
    out = {}
    for share in (1.0, 0.1):
        live_np = (np.ones(nn, np.int32) if share == 1.0 else
                   (rng.uniform(size=nn) < share).astype(np.int32))
        live = torch.from_numpy(live_np).to(dev)
        rows = int(live_np.sum()) * nb

        def call(impl="auto"):
            return ops.gated_greedy_round(
                x, mind, c, live, pend, impl=impl, n_block=nb, forms=forms,
                matmul=False, blocks=True)
        bnd, by = bound(4.0 * (rows * D + 2 * n + D + 4 * nn),
                        3.0 * rows * D)
        out[share] = {"shape": [n, D, r], "n_block": nb,
                      "tile_rows": ops.gated_plan(n, D, nb),
                      "live_rows": rows, "ms": median_ms(call),
                      "device_ms": profiled_ms(call, "gated_greedy_round"),
                      "host_us": host_us(call),
                      "plain_ms": median_ms(lambda: call("ref")),
                      "bound_ms": bnd, "bound_by": by, "library_ms": None}
    return out


# entries as the prefilter queues them: warm-start chunks (matmul form)
# and single centers (difference form), a one-center last chunk included
FORM_ENTRIES = (5, 1, 3, 1, 1, 2, 1)


def check_gated_forms(ops, dev, rng):
    """The mixed-form kernel against B1, bit for bit: at d = 32, 192 and
    512 over 20,003 rows in gate blocks of 256 and 32 rows, ~half live,
    each block folding the entries from its own cursor on, one gated
    launch (forms 0 for single centers, 1 for chunks) must give the new
    min-dists of one ``greedy_round`` launch per entry, and the per-block
    pairs and the argmax that follow from them."""
    rows = np.concatenate([[0], np.cumsum(FORM_ENTRIES)])
    forms = torch.from_numpy(np.concatenate(
        [np.full(k, int(k > 1), np.int8) for k in FORM_ENTRIES])).to(dev)
    n, cases = 20_003, 0
    for d in (32, 192, 512):
        x = torch.from_numpy((rng.standard_normal((n, d)) * 0.25).astype(
            np.float32)).to(dev)
        c = torch.from_numpy((rng.standard_normal((int(rows[-1]), d))
                              * 0.25).astype(np.float32)).to(dev)
        mind = torch.full((n,), 3.4e38, device=dev)
        mind[torch.from_numpy(rng.choice(n, 300, replace=False)).to(dev)] \
            = -1.0
        # from each cursor e0 on, one B1 launch per entry
        seq = {}
        for e0 in range(len(FORM_ENTRIES) + 1):
            m = mind
            for e in range(e0, len(FORM_ENTRIES)):
                chunk = c[int(rows[e]):int(rows[e + 1])]
                m = ops.greedy_round(x, m, chunk, torch.full(
                    (chunk.shape[0],), -1, dtype=torch.int32, device=dev))[0]
            seq[e0] = m
        for nb in (256, 32):
            nn = -(-n // nb)
            live = (rng.uniform(size=nn) < 0.5).astype(np.int32)
            ent = rng.integers(0, len(FORM_ENTRIES) + 1, nn)
            nm, idx, score, pairs = ops.gated_greedy_round(
                x, mind, c, torch.from_numpy(live).to(dev),
                torch.from_numpy(rows[ent].astype(np.int32)).to(dev),
                n_block=nb, forms=forms, blocks=True)
            blk = np.repeat(np.arange(nn), nb)[:n]
            want = mind.clone()
            for e0 in range(len(FORM_ENTRIES)):
                sel = torch.from_numpy((live[blk] > 0) & (ent[blk] == e0)
                                       ).to(dev)
                want = torch.where(sel, seq[e0], want)
            torch.cuda.synchronize()
            assert torch.equal(nm.view(torch.int32), want.view(torch.int32)), \
                ("mixed forms != B1 per entry", d, nb)
            sc = torch.where(torch.from_numpy(live[blk] > 0).to(dev)
                             & ~(want < 0), want, -3.4e38)
            padded = torch.full((nn * nb,), -3.4e38, device=dev)
            padded[:n] = sc
            bi = torch.argmax(padded.view(nn, nb), dim=1)
            assert torch.equal(pairs[0], padded.view(nn, nb).gather(
                1, bi[:, None])[:, 0]), ("block maxima", d, nb)
            assert torch.equal(pairs[1].view(torch.int32), (
                bi + torch.arange(nn, device=dev) * nb).to(torch.int32)), \
                ("block indices", d, nb)
            assert int(idx) == int(torch.argmax(sc)) and \
                float(score) == float(sc.max()), ("argmax", d, nb)
            cases += 1
    return cases


def check_argmin(ops, dev, rng):
    """pairwise_min_argmin at N = 10,000 x M = 1,000 x d = 512 (DBAL's
    Lloyd step at budget 1,000), plus ragged N and M, with planted exact
    ties (center 3 duplicated at 259 and 515: the same offset in any
    power-of-two tile). Indices must match exactly on tie rows and
    on rows whose best and second-best distances differ by > 10 * ATOL;
    on the other rows the kernel's pick must be within ATOL of the min.
    The outputs' bytes must not depend on the CTA tile or the rows."""
    worst, compared = 0.0, 0
    for n, m in ((10 * BUDGET, BUDGET), (10 * BUDGET - 3, BUDGET - 5)):
        x = torch.from_numpy((rng.standard_normal((n, D)) * 0.05).astype(
            np.float32)).to(dev)
        c = torch.from_numpy((rng.standard_normal((m, D)) * 0.05).astype(
            np.float32)).to(dev)
        c[259] = c[515] = c[3]                      # three-way tie at 3
        x[:100] = c[3] + 1e-3
        km, ka = ops.pairwise_min_and_argmin(x, c)
        pm, pa = ops.pairwise_min_and_argmin(x, c, impl="ref")
        torch.cuda.synchronize()
        err = float((km - pm).abs().max())
        assert err <= ATOL, (n, m, err)
        assert bool((ka[:100] == 3).all()) and bool((pa[:100] == 3).all())
        d = ops.pairwise_sq_dists(x, c)
        top2 = torch.topk(d, 2, dim=1, largest=False).values
        sep = (top2[:, 1] - top2[:, 0]) > 10 * ATOL
        sep[:100] = True
        assert torch.equal(ka[sep], pa[sep]), (n, m)
        picked = torch.gather(d, 1, ka.long()[:, None])[:, 0]
        assert float((picked - pm).abs().max()) <= ATOL
        argmin_bytes_invariant(ops, x, c, km, ka)
        worst, compared = max(worst, err), compared + int(sep.sum())
    return worst, compared


def argmin_bytes_invariant(ops, x, c, km, ka):
    """The argmin's outputs are the same bytes under two forced CTA tiles
    and for a row subset against the full call."""
    for plan in ((128, 64), (32, 32)):
        vm, va = ops.pairwise_min_and_argmin(x, c, plan=plan)
        assert torch.equal(vm, km) and torch.equal(va, ka), plan
    sub = slice(7, x.shape[0] - 5)
    sm, sa = ops.pairwise_min_and_argmin(x[sub], c)
    assert torch.equal(sm, km[sub]) and torch.equal(sa, ka[sub])


def time_argmin(ops, dev, rng):
    n, m = 10 * BUDGET, BUDGET
    x = torch.from_numpy((rng.standard_normal((n, D)) * 0.05).astype(
        np.float32)).to(dev)
    c = torch.from_numpy((rng.standard_normal((m, D)) * 0.05).astype(
        np.float32)).to(dev)
    ms = median_ms(lambda: ops.pairwise_min_and_argmin(x, c))
    plain = median_ms(lambda: ops.pairwise_min_and_argmin(x, c, impl="ref"))
    library = median_ms(lambda: torch.cdist(x, c).min(1))
    nbytes = 4 * ((n + m) * D + 2 * n)
    return ms, plain, library, bound(nbytes, 2.0 * n * m * D + 2.0 * (n + m) * D)


def wide_inputs(rng, n, dev):
    """(n, 4,096) rows scaled so squared distances stay O(1), as at d = 512."""
    return torch.from_numpy((rng.standard_normal((n, WIDE)) * 0.05 /
                             np.sqrt(WIDE / D)).astype(np.float32)).to(dev)


def check_wide(ops, dev, rng):
    """Both selection kernels at d = 4,096 (text features): greedy_round at
    N = 2,048, R in {1, 8}, weighted or not, with a planted tie 256 rows
    apart; pairwise_min_argmin at 2,048 x 256 with a planted center tie.
    Then their times at those shapes."""
    n, m = TEXT_POOL, TEXT_BUDGET
    worst, cases = 0.0, 0
    x = wide_inputs(rng, n, dev)
    x[1024] = x[768] = x[768] * 3.0                   # tie: 768 must win
    for r in (1, 8):
        for weighted in (False, True):
            mind = torch.full((n,), 3.4e38, device=dev)
            sel = torch.arange(5, 5 + r, dtype=torch.int32, device=dev)
            w = None
            if weighted:
                w = torch.rand(n, device=dev)
                w[768] = w[1024] = 1.0
            args = (x, mind, x[sel.long()], sel, w)
            kn, ki, _ = ops.greedy_round(*args)
            pn, pi, _ = ops.greedy_round(*args, impl="ref")
            torch.cuda.synchronize()
            err = float((kn - pn).abs().max())
            assert err <= ATOL, ("wide greedy", r, weighted, err)
            assert int(ki) == int(pi) == 768, (r, weighted, int(ki), int(pi))
            worst, cases = max(worst, err), cases + 1
    c = wide_inputs(rng, m, dev)
    c[200] = c[3]
    xa = x.clone()
    xa[:50] = c[3] + 1e-3
    km, ka = ops.pairwise_min_and_argmin(xa, c)
    pm, pa = ops.pairwise_min_and_argmin(xa, c, impl="ref")
    torch.cuda.synchronize()
    a_err = float((km - pm).abs().max())
    assert a_err <= ATOL, ("wide argmin", a_err)
    top2 = torch.topk(ops.pairwise_sq_dists(xa, c), 2, dim=1,
                      largest=False).values
    sep = (top2[:, 1] - top2[:, 0]) > 10 * ATOL
    sep[:50] = True
    assert bool((ka[:50] == 3).all()) and torch.equal(ka[sep], pa[sep])
    argmin_bytes_invariant(ops, xa, c, km, ka)

    mind = torch.full((n,), 3.4e38, device=dev)
    c1, s1 = x[7:8], torch.tensor([7], dtype=torch.int32, device=dev)
    g_ms = median_ms(lambda: ops.greedy_round(x, mind, c1, s1))
    g_plain = median_ms(lambda: ops.greedy_round(x, mind, c1, s1, impl="ref"))
    nb = -(-n // 64)
    g_bound = bound(4 * (n * WIDE + WIDE + 1 + 2 * n + 2 * nb),
                    3.0 * n * WIDE)
    a_ms = median_ms(lambda: ops.pairwise_min_and_argmin(x, c))
    a_plain = median_ms(lambda: ops.pairwise_min_and_argmin(x, c, impl="ref"))
    a_lib = median_ms(lambda: torch.cdist(x, c).min(1))
    a_bound = bound(4 * ((n + m) * WIDE + 2 * n),
                    2.0 * n * m * WIDE + 2.0 * (n + m) * WIDE)
    return {"greedy_round": {"cases": cases, "max_abs_err": worst,
                             "timed_shape": [n, WIDE, 1], "ms": g_ms,
                             "plain_ms": g_plain, "bound_ms": g_bound[0],
                             "bound_by": g_bound[1]},
            "pairwise_min_argmin": {"max_abs_err": a_err,
                                    "index_rows": int(sep.sum()),
                                    "timed_shape": [n, m, WIDE], "ms": a_ms,
                                    "plain_ms": a_plain, "library_ms": a_lib,
                                    "bound_ms": a_bound[0],
                                    "bound_by": a_bound[1]}}


def check_flash(fa, dev, rng):
    """flash_attention against its plain version (naive attention) over
    D in {64, 128}, G in {1, 4}, S in {512, 500}, kv_block in {64, 128}
    and window in {None, 128}, at B 2 and KH 2; each row must also come
    out bit-identical when fewer query rows are launched."""
    worst, cases = 0.0, 0
    for hd in (64, 128):
        for g in (1, 4):
            for s in (512, 500):
                q = torch.from_numpy(rng.standard_normal(
                    (2, s, 2 * g, hd)).astype(np.float32)).to(dev)
                k, v = (torch.from_numpy(rng.standard_normal(
                    (2, s, 2, hd)).astype(np.float32)).to(dev)
                    for _ in range(2))
                for kb in (64, 128):
                    for window in (None, 128):
                        got = fa.flash_attention_auto(
                            q, k, v, window=window, kv_chunk=kb)
                        want = fa.flash_attention_auto(
                            q, k, v, window=window, impl="ref")
                        part = fa.flash_attention_auto(
                            q[:, :300], k, v, window=window, kv_chunk=kb)
                        torch.cuda.synchronize()
                        err = float((got - want).abs().max())
                        assert err <= FLASH_ATOL, (hd, g, s, kb, window, err)
                        assert torch.equal(part, got[:, :300]), \
                            ("query rows changed a row", hd, g, s, kb, window)
                        worst, cases = max(worst, err), cases + 1
    return worst, cases


def time_flash(fa, dev):
    """At the text path's shape: B 32, S 512, H 32, KH 8, D 128, causal,
    kv_block 128. Bound: the two products, 4·B·H·D·S(S+1)/2 FLOP for the
    causal half, against q, k, v read and out written once."""
    import torch.nn.functional as F
    b, s, h, kh, hd = TEXT_BATCH, TEXT_SEQ, 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, s, h, hd), generator=g, device=dev)
    k = torch.randn((b, s, kh, hd), generator=g, device=dev)
    v = torch.randn((b, s, kh, hd), generator=g, device=dev)
    ms = median_ms(lambda: fa.flash_attention_auto(q, k, v, kv_chunk=128))
    plain = median_ms(lambda: fa.flash_attention_auto(q, k, v, impl="ref"))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    flops = 4.0 * b * h * hd * s * (s + 1) / 2
    nbytes = 4.0 * (2 * b * s * h * hd + 2 * b * s * kh * hd)
    return ms, plain, library, bound(nbytes, flops)


BF16_FLASH_CASES = [(hd, g, s, w, c) for hd in (16, 64, 96, 128)
                    for g in (1, 4) for s in (96, 500, 512)
                    for w in (None, 128) for c in (True, False)]
# recurrentgemma-2b's head layout: D 256, G 10
BF16_FLASH_CASES += [(256, 10, s, w, c) for s in (96, 500, 512)
                     for w in (None, 128) for c in (True, False)]
# the enc-dec and patch-prefix layouts at B 2, (Sq, Skv, H, KH, D, causal):
# whisper-medium's cross-attention (512 queries over 1,500 frames) and
# encoder (1,500 x 1,500), non-causal, neither a multiple of the 64-key
# tiles; llava-next-34b's G 7 at D 128, causal and over 1,500 keys
ENCDEC_FLASH_CASES = [(512, 1_500, 16, 16, 64, False),
                      (1_500, 1_500, 16, 16, 64, False),
                      (512, 512, 56, 8, 128, True),
                      (512, 1_500, 56, 8, 128, False)]


def check_flash_bf16(fa, dev):
    """The bf16 tensor-core kernel against its plain version (naive
    attention) over D in {16, 64, 96 (zero-padded to 128), 128}, G in
    {1, 4}, and D 256 at G 10 (recurrentgemma-2b's layout), S in {96,
    500, 512}, window in {None, 128}, causal or not, at B 2 and KH 2: out
    bf16 and within ATT_TOL, and each row bit-identical when fewer query
    rows are launched; the same over ENCDEC_FLASH_CASES (Sq != Skv,
    G 7). Then the qwen3-8b serve prefill (``time_flash_bf16``)."""
    tol = ATT_TOL[torch.bfloat16]
    worst, cases = 0.0, 0
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = [(s, s, 2 * grp, 2, hd, causal, window)
              for hd, grp, s, window, causal in BF16_FLASH_CASES]
    shapes += [(sq, skv, h, kh, hd, causal, None)
               for sq, skv, h, kh, hd, causal in ENCDEC_FLASH_CASES]
    for sq, skv, h, kh, hd, causal, window in shapes:
        q = torch.randn((2, sq, h, hd), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((2, skv, kh, hd), generator=g,
                            device=dev).bfloat16() for _ in range(2))
        got = fa.flash_attention_auto(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_auto(q, k, v, causal=causal,
                                       window=window, impl="ref")
        rows = 300 if sq > 300 else 50
        part = fa.flash_attention_auto(q[:, :rows], k, v, causal=causal,
                                       window=window)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16, got.dtype
        case = (sq, skv, h, kh, hd, window, causal)
        worst = max(worst, within(got, want, tol))
        assert torch.equal(part, got[:, :rows]), ("query rows changed a row",
                                                  case)
        cases += 1
    return {"cases": cases, "max_abs_err_cases": worst,
            **time_flash_bf16(fa, dev, 32, 8, 128)}


def time_flash_bf16(fa, dev, h, kh, hd, window=None, sq=SERVE_PROMPT,
                    skv=SERVE_PROMPT, causal=True):
    """The bf16 kernel at a serve prefill (B 16, the arch's H, KH and D;
    Sq = Skv = 512, causal, and the arch's window for local attention; or
    whisper's non-causal Sq x Skv, its encoder's 1,500 x 1,500 and its
    cross-attention's 512 x 1,500): out bf16 and within ATT_TOL of the
    plain version, and timed. Bound: the two products at the bf16 peak
    against q, k, v, out in bf16, over the keys the masks allow. Library:
    scaled_dot_product_attention, causal where the kernel is (with a band
    mask where the window is shorter than the prompt)."""
    import torch.nn.functional as F
    tol = ATT_TOL[torch.bfloat16]
    b = SERVE_BATCH
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((b, skv, kh, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((b, skv, kh, hd), generator=g, device=dev).bfloat16()

    def kernel():
        return fa.flash_attention_auto(q, k, v, causal=causal,
                                       kv_chunk=skv, window=window)
    got = kernel()
    want = fa.flash_attention_auto(q, k, v, causal=causal, window=window,
                                   impl="ref")
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 == want.dtype, got.dtype
    err = within(got, want, tol)
    del want
    ms = median_ms(kernel)
    plain = median_ms(lambda: fa.flash_attention_auto(
        q, k, v, causal=causal, window=window, impl="ref"))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(sq, device=dev)
    if not causal:                        # every key of every row
        mask, lib_causal, keys = None, False, float(sq * skv)
    elif window is None or window >= sq:  # the window allows every key
        mask, lib_causal, keys = None, True, sq * (sq + 1) / 2
    else:
        band = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        mask, lib_causal, keys = band, False, float(band.sum())
    library = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=lib_causal, enable_gqa=True))
    flops = 4.0 * b * h * hd * keys
    nbytes = 2.0 * (2 * b * sq * h * hd + 2 * b * skv * kh * hd)
    bnd, by = bound(nbytes, flops, BF16_FLOPS_S)
    return {"max_abs_err": err,
            "out_dtype": str(got.dtype), "tolerance": tol,
            "timed_shape": [b, sq, skv, h, kh, hd], "window": window,
            "causal": causal, "kv_block": "fixed 64 keys",
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": library, "ms_over_library": ms / library}


def _logits(g, n, v, dev, scale=3.0):
    return torch.randn((n, v), generator=g, device=dev) * scale


def check_uncertainty(unc, dev):
    """uncertainty_stats against its plain version: V = 152,064 at N 1,
    16 and 4,096 (fp32), the other served archs' padded vocabularies at
    N 16 (92,672, 100,352, 102,400: ragged last splits), ragged V 37 and
    300, bf16 logits, scale-80 logits, and rows with a planted top-2 tie
    (mc exactly 0, rc exactly 1). Returns the worst |d| of the cases held
    at the fp32 tolerance (fp32 and bf16 inputs) and the case count."""
    g = torch.Generator(device=dev).manual_seed(3)
    cases = [(1, VOCAB, torch.float32, 3.0, "fp32"),
             (16, VOCAB, torch.float32, 3.0, "fp32"),
             (4_096, VOCAB, torch.float32, 3.0, "fp32"),
             (16, 37, torch.float32, 3.0, "fp32"),
             (16, 300, torch.float32, 3.0, "fp32"),
             (16, VOCAB, torch.bfloat16, 3.0, "fp32"),
             (8, VOCAB, torch.float32, 80.0, "scale80")]
    cases += [(16, v, torch.float32, 3.0, "fp32") for v in serve_vocabs()]
    worst = 0.0
    for n, v, dtype, scale, tol in cases:
        x = _logits(g, n, v, dev, scale).to(dtype)
        got = unc.uncertainty_stats(x)
        want = unc.uncertainty_stats(x, impl="ref")
        torch.cuda.synchronize()
        for kind in KINDS:
            err = within(got[kind], want[kind], UNC_TOL[tol])
            if tol == "fp32":
                worst = max(worst, err)
        del x, got, want
    x = torch.round(_logits(g, 16, VOCAB, dev) * 8) / 8    # a bf16 grid
    a = torch.randint(0, VOCAB, (16,), generator=g, device=dev)
    b = (a + torch.randint(1, VOCAB, (16,), generator=g, device=dev)) % VOCAB
    top = x.amax(1) + 1.0
    rows = torch.arange(16, device=dev)
    x[rows, a] = top
    x[rows, b] = top
    x[0, :2] = top[0]                            # adjacent columns too
    tied = unc.uncertainty_stats(x)
    assert bool((tied["mc"] == 0).all()) and bool((tied["rc"] == 1).all())
    return worst, len(cases) + 1


def check_uncertainty_split(unc, dev):
    """B4 against its split-and-merge plain version
    (``ref.uncertainty_stats_split_ref``, the kernel's split size) at
    16 x 152,064, fp32 and bf16, and at 16 x each other served arch's
    padded vocabulary, fp32, within UNC_TOL; a row's score bytes
    alone equal its bytes among 4,096 rows (fp32 and bf16, rows 0, 1,234
    and 4,095); top-2 ties straddling split boundaries (the last column of
    a split and the first of the next; column 10 and column 150,000):
    mc exactly 0 and rc exactly 1. Returns the worst |d| and the cases."""
    from repro_torch.kernels.uncertainty import ref as uref
    g = torch.Generator(device=dev).manual_seed(10)
    worst, cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        split = unc.SPLIT_ELEMS[dtype]
        x = _logits(g, 16, VOCAB, dev).to(dtype)
        got = unc.uncertainty_stats(x)
        want = uref.uncertainty_stats_split_ref(x, split)
        for kind in KINDS:
            worst = max(worst, within(got[kind], want[kind],
                                      UNC_TOL["fp32"]))
        big = _logits(g, 4_096, VOCAB, dev).to(dtype)
        whole = unc.uncertainty_stats(big)
        for r in (0, 1_234, 4_095):
            one = unc.uncertainty_stats(big[r:r + 1])
            assert all(torch.equal(one[k], whole[k][r:r + 1])
                       for k in KINDS), ("rows launched changed a row", r,
                                         dtype)
        del big, whole
        x = torch.round(_logits(g, 4, VOCAB, dev) * 8) / 8
        top = x.amax(1) + 1.0
        for row, (a, b) in enumerate(((split - 1, split),
                                      (2 * split - 1, 2 * split),
                                      (10, 150_000), (split, 150_000))):
            x[row, a] = x[row, b] = top[row]
        tied = unc.uncertainty_stats(x.to(dtype))
        assert bool((tied["mc"] == 0).all()) and \
            bool((tied["rc"] == 1).all()), (dtype, tied["mc"], tied["rc"])
        cases += 3
    for v in serve_vocabs():
        x = _logits(g, 16, v, dev)
        got = unc.uncertainty_stats(x)
        want = uref.uncertainty_stats_split_ref(x, unc.SPLIT_ELEMS[x.dtype])
        worst = max([worst] + [within(got[k], want[k], UNC_TOL["fp32"])
                               for k in KINDS])
        cases += 1
    return worst, cases


def time_uncertainty(unc, dev, vocab=VOCAB, rows=(SERVE_BATCH, 4_096)):
    """At the decode shape (16 x 152,064 fp32; 9.7 MB, which stays in the
    50 MB L2 between launches as it does after the LM head's product) and
    at a pool-scoring shape (4,096 x 152,064; 2.5 GB), or at 16 rows of
    another served arch's padded vocabulary. Bound: one read of
    the logits and the (4, N) write, against ~5 operations a logit. The
    library yardstick is torch.logsumexp alone ("lse only"): no single
    PyTorch call computes the four scores."""
    g = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for n in rows:
        x = _logits(g, n, vocab, dev)
        ms = median_ms(lambda: unc.uncertainty_stats(x))
        plain = median_ms(lambda: unc.uncertainty_stats(x, impl="ref"))
        library = median_ms(lambda: torch.logsumexp(x, -1))
        bnd, by = bound(4.0 * n * vocab + 16.0 * n, 5.0 * n * vocab)
        out[n] = {"timed_shape": [n, vocab], "ms": ms,
                  "splits": unc.split_plan(n, vocab, x.dtype).splits,
                  "device_ms": profiled_ms(lambda: unc.uncertainty_stats(x),
                                           "uncertainty_stats"),
                  "host_us": host_us(lambda: unc.uncertainty_stats(x)),
                  "plain_ms": plain,
                  "bound_ms": bnd, "bound_by": by, "library_ms": library,
                  "library": "torch.logsumexp (lse only)"}
        del x
    return out


DECODE_CASES = [dict(B=2, H=4, KH=2, D=32, S=128, cur=77, win=None),
                dict(B=1, H=8, KH=1, D=64, S=96, cur=96, win=None),
                dict(B=2, H=4, KH=4, D=16, S=64, cur=13, win=8),
                dict(B=3, H=16, KH=2, D=64, S=200, cur=1, win=None)]
QWEN3_DECODE = [dict(B=SERVE_BATCH, H=32, KH=8, D=128, S=SERVE_MAX,
                     cur=SERVE_CUR, win=w) for w in (None, 128)]


def serve_config(arch):
    """A served arch's full config, its depth cut where SERVE_DEPTH says."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_DEPTH[arch])
    return cfg


def serve_layout(arch):
    """(H, KH, head_dim, padded vocab) of a served arch's full config."""
    cfg = serve_config(arch)
    return cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.padded_vocab


def serve_attention(arch):
    """(flash attention launches in prefill, decode attention launches a
    step) of a served arch's full config: its serve path launches flash
    attention once per attention layer (global or local), encoder layer
    and cross-attention layer in prefill, and decode attention once per
    global attention layer and cross-attention layer a step (local decode
    is plain torch, as the reference's; MLA runs neither)."""
    from repro_torch.models.transformer import build_segments
    cfg = serve_config(arch)
    specs = [spec for seg in build_segments(cfg)
             for _ in range(seg.count) for spec in seg.unit]
    cross = sum(sp.cross_attn for sp in specs)
    enc = cfg.n_enc_layers if cfg.enc_dec else 0
    return (sum(sp.mixer in ("attn", "attn_local") for sp in specs) + enc
            + cross, sum(sp.mixer == "attn" for sp in specs) + cross)


def serve_vocabs():
    """The other served archs' padded vocabularies, qwen3-8b's left out."""
    return sorted({serve_layout(a)[3] for a in SERVE_ARCHS[1:]} - {VOCAB})


def layout_decode():
    """The decode shapes (B 16, cache 1,024, cur_len 577, window none) of
    the other served archs with global attention: G 6 (internlm2), KH 10
    (phi3), G 1 (qwen1.5, deepseek-moe, whisper at D 64), G 7 (llava);
    and whisper's cross-attention step over its 1,500 cached frames
    (cache = cur_len = n_enc_frames; labelled ``whisper_medium:cross``).
    rwkv6-3b has no attention, recurrentgemma-2b only local attention and
    deepseek-v3 MLA, so none of them runs B6."""
    out = []
    for arch in SERVE_ARCHS[1:]:
        if not serve_attention(arch)[1]:
            continue
        h, kh, hd, _ = serve_layout(arch)
        out.append(dict(B=SERVE_BATCH, H=h, KH=kh, D=hd, S=SERVE_MAX,
                        cur=SERVE_CUR, win=None, arch=arch))
        cfg = serve_config(arch)
        if cfg.enc_dec:
            out.append(dict(out[-1], S=cfg.n_enc_frames,
                            cur=cfg.n_enc_frames, arch=arch + ":cross"))
    return out


def _decode_inputs(g, c, dtype, dev):
    q = torch.randn((c["B"], 1, c["H"], c["D"]), generator=g, device=dev)
    k = torch.randn((c["B"], c["S"], c["KH"], c["D"]), generator=g,
                    device=dev)
    v = torch.randn((c["B"], c["S"], c["KH"], c["D"]), generator=g,
                    device=dev)
    cur = torch.tensor(c["cur"], dtype=torch.int32, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype), cur


def check_decode(da, dev):
    """decode_attention against its plain version on the reference's four
    cases, the qwen3-8b decode shape (window none and 128) and the other
    served archs' decode shapes (whisper's cross-attention at cur_len =
    cache = 1,500, llava's G 7 among them), each at fp32 (ATT_TOL) and
    bf16 (DECODE_BF16_TOL); cur_len read from the device. At every served
    shape a row's bytes must repeat from run to run and, where the live
    prefix fits 640 entries, must not depend on the cache's capacity (the
    same live prefix in caches of 640 and 1,024 entries)."""
    g = torch.Generator(device=dev).manual_seed(5)
    tol = {torch.float32: ATT_TOL[torch.float32],
           torch.bfloat16: DECODE_BF16_TOL}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    served = QWEN3_DECODE + layout_decode()
    for c in DECODE_CASES + served:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, cur = _decode_inputs(g, c, dtype, dev)
            got = da.decode_attention_auto(q, k, v, cur, window=c["win"])
            want = da.decode_attention_auto(q, k, v, cur, window=c["win"],
                                            impl="ref")
            torch.cuda.synchronize()
            assert got.dtype == dtype
            worst[dtype] = max(worst[dtype],
                               within(got, want, tol[dtype]))
            if c in served:
                again = da.decode_attention_auto(q, k, v, cur,
                                                 window=c["win"])
                assert torch.equal(got, again), ("repeat", c, dtype)
            if c in served and c["cur"] <= 640:  # a live prefix to cut to
                small = da.decode_attention_auto(
                    q, k[:, :640].contiguous(), v[:, :640].contiguous(), cur,
                    window=c["win"])
                assert torch.equal(got, small), ("capacity", c, dtype)
            del q, k, v
    return worst, 2 * len(DECODE_CASES + served)


def time_decode(da, dev, c=QWEN3_DECODE[0]):
    """At a served arch's decode shape (bf16, window none; qwen3-8b's by
    default). Bound: the live
    K/V (cur_len keys) read once, q read and out written, against the two
    products at the bf16 peak. Library: scaled_dot_product_attention with
    a length mask and enable_gqa.

    ``ms`` is the CUDA-event median with the caches warm: the 37.8 MB of
    live K/V stay in the 50 MB L2 from one call to the next. ``cold``
    rotates over enough caches (each a separate K/V pair) that every call
    finds its own cache out of L2, as the serve loop finds each layer's.
    ``device_ms`` is the kernels' own duration a call from torch.profiler
    over the same calls, and ``host_us`` what a call costs the host to
    enqueue: where host_us exceeds the device time, back-to-back events
    measure the host."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, cur = _decode_inputs(g, c, torch.bfloat16, dev)
    ms = median_ms(lambda: da.decode_attention_auto(q, k, v, cur))
    plain = median_ms(lambda: da.decode_attention_auto(q, k, v, cur,
                                                       impl="ref"))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = (torch.arange(c["S"], device=dev) < cur)[None, None, None, :]
    library = median_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    b, h, kh, hd, n = c["B"], c["H"], c["KH"], c["D"], c["cur"]
    nbytes = 2.0 * (2 * b * n * kh * hd + 2 * b * h * hd)
    bnd, by = bound(nbytes, 4.0 * b * h * hd * n, BF16_FLOPS_S)
    n_sets = int(2 * L2_BYTES // nbytes) + 2
    sets = [(k, v)] + [tuple(torch.randn_like(k) for _ in range(2))
                       for _ in range(n_sets - 1)]
    turn = [0]

    def rotating():
        kk, vv = sets[turn[0] % n_sets]
        turn[0] += 1
        return da.decode_attention_auto(q, kk, vv, cur)

    def warm():
        return da.decode_attention_auto(q, k, v, cur)
    cold = {"caches": n_sets, "ms": median_ms(rotating),
            "device_ms": profiled_ms(rotating, "decode_attention")}
    del sets
    return {"timed_shape": [b, c["S"], n, h, kh, hd], "group": h // kh,
            "split_keys": da.SPLIT_KEYS,
            "ms": ms, "device_ms": profiled_ms(warm, "decode_attention"),
            "split_merge_device_ms": [
                profiled_ms(warm, key) for key in ("decode_attention_split",
                                                   "decode_attention_merge")],
            "host_us": host_us(warm), "cold": cold,
            "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": library}


def flash_layouts(arch):
    """(label, ``time_flash_bf16`` keywords) of each B3 layout a served
    arch's prefill runs: its decoder's (causal, 512 x 512, the window for
    local attention) under the arch's name and, for an enc-dec config,
    the encoder's (n_enc_frames x n_enc_frames) and the cross-attention's
    (512 x n_enc_frames), both non-causal, under ``arch:encoder`` and
    ``arch:cross``."""
    cfg = serve_config(arch)
    out = [(arch, dict(window=None if cfg.griffin is None
                       else cfg.griffin.window))]
    if cfg.enc_dec:
        n = cfg.n_enc_frames
        out += [(arch + ":encoder", dict(sq=n, skv=n, causal=False)),
                (arch + ":cross", dict(skv=n, causal=False))]
    return out


def time_serve_shapes(fa, da, unc, dev):
    """B3 (bf16), B6 and B4 timed at each other served arch's shapes,
    each where the arch's serve path runs it: B3 at each of an arch's
    attention layouts (``flash_layouts``: recurrentgemma-2b's local
    layers at their window, 2,048; whisper-medium's encoder and
    cross-attention), B6 at each global or cross-attention decode layout
    (``layout_decode``), B4 at every arch (B3 also held there; B6's and
    B4's checks at these shapes are ``check_decode``'s and
    ``check_uncertainty``'s). Keyed by label: the arch, or
    ``arch:encoder`` / ``arch:cross``."""
    decode = layout_decode()
    out = {}
    for arch in SERVE_ARCHS[1:]:
        h, kh, hd, vocab = serve_layout(arch)
        out[arch] = {}
        if serve_attention(arch)[0]:
            for label, kw in flash_layouts(arch):
                out.setdefault(label, {})["flash_attention_bf16"] = \
                    time_flash_bf16(fa, dev, h, kh, hd, **kw)
        for c in decode:
            if c["arch"].split(":")[0] == arch:
                out.setdefault(c["arch"], {})["decode_attention"] = \
                    time_decode(da, dev, c)
        out[arch]["uncertainty_stats"] = time_uncertainty(
            unc, dev, vocab, (SERVE_BATCH,))[SERVE_BATCH]
    return out


def check_recurrent(dev):
    """Card oracles of the recurrent arithmetic at the full widths, fp32
    with TF32 off (the WKV and the gates are fp32 matmuls): the chunked
    WKV against the sequential recurrence for one rwkv6-3b layer at its
    prefill (B 16, S 512, H 40, D 64, chunk 64; the reference's test's
    inputs: N(0, 1) r, k, v, log w = -exp(N(0, 0.5)), bonus N(0, 0.2), a
    carried state N(0, 0.3)), outputs and final state within WKV_TOL of
    their largest magnitude; and
    the RG-LRU log-depth scan against a stepwise float64 loop at
    recurrentgemma-2b's prefill (B 16, S 512, W 2,560, a carried h0), at
    every position within SCAN_TOL. Each path timed (CUDA events), the
    scan also against a stepwise fp32 loop (the alternative to the
    log-depth scan)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import rglru, rwkv
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    g = torch.Generator(device=dev).manual_seed(12)
    rc = get_config("rwkv6_3b")
    B, S = SERVE_BATCH, SERVE_PROMPT
    H, D = rc.d_model // rc.rwkv.head_dim, rc.rwkv.head_dim

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    r, k, v = (randn((B, S, H, D)) for _ in range(3))
    log_w = -torch.exp(randn((B, S, H, D), 0.5))
    bonus, s0 = randn((H, D), 0.2), randn((B, H, D, D), 0.3)
    args = (r, k, v, log_w, bonus, s0)
    o1, st1 = rwkv.wkv_sequential(*args)
    o2, st2 = rwkv.wkv_chunked(*args, rc.rwkv.chunk)
    torch.cuda.synchronize()
    wkv = {"shape": [B, S, H, D], "chunk": rc.rwkv.chunk,
           "tolerance_of_max": WKV_TOL,
           "max_abs_err": within_scale(o2, o1, WKV_TOL),
           "state_max_abs_err": within_scale(st2, st1, WKV_TOL),
           "out_abs_max": float(o1.abs().max()),
           "state_abs_max": float(st1.abs().max()),
           "chunked_ms": median_ms(lambda: rwkv.wkv_chunked(
               *args, rc.rwkv.chunk), reps=5, inner=2),
           "sequential_ms": median_ms(lambda: rwkv.wkv_sequential(*args),
                                      reps=3, inner=1)}
    del r, k, v, log_w, args, o1, o2
    W = get_config("recurrentgemma_2b").griffin.lru_width
    log_a = -torch.exp(randn((B, S, W), 0.5))
    gated, h0 = randn((B, S, W)), randn((B, W))
    got = rglru.rglru_scan(log_a, gated, h0)
    a = torch.exp(log_a.double())
    b = torch.sqrt(torch.clamp_min(1 - a * a, 0)) * gated.double()
    h, want = h0.double(), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    want = torch.stack(want, 1)
    torch.cuda.synchronize()

    def stepwise32():
        a32 = torch.exp(log_a)
        b32 = torch.sqrt(torch.clamp_min(1 - a32 * a32, 0)) * gated
        hh, hs = h0, []
        for t in range(S):
            hh = a32[:, t] * hh + b32[:, t]
            hs.append(hh)
        return torch.stack(hs, 1)
    scan = {"shape": [B, S, W], "tolerance": SCAN_TOL,
            "max_abs_err": within(got, want, SCAN_TOL),
            "out_abs_max": float(want.abs().max()),
            "log_depth_ms": median_ms(lambda: rglru.rglru_scan(
                log_a, gated, h0), reps=5, inner=4),
            "stepwise_fp32_ms": median_ms(stepwise32, reps=3, inner=1)}
    return {"wkv_chunked_vs_sequential": wkv,
            "rglru_scan_vs_stepwise": scan}


def check_mla(dev):
    """The MLA card oracle at deepseek-v3's full widths (d 7,168, H 128,
    q/kv ranks 1,536/512, QK 128 + 64, V 128), one layer, B 16: the
    absorbed decode of token 577 against a 1,024-entry latent cache that
    holds the chunked prefill's 577 latents and noise in the other rows
    (the mask must hide them), held to the last row of the prefill's
    expansion: fp32 (TF32 off) within the reference's 2e-4, bf16 within
    MLA_BF16_TOL (allclose). Weights N(0, 1/fan_in), norm scales N(1,
    0.5), x N(0, 1), from one generator. The bf16 decode is timed (CUDA
    events): no kernel runs in it, as none does in the reference's."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import mla
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("deepseek_v3_671b")
    g = torch.Generator(device=dev).manual_seed(13)
    params = {}
    for name, decl in mla.mla_decls(cfg).items():
        if isinstance(decl, dict):
            params[name] = {"scale": 1.0 + 0.5 * torch.randn(
                decl["scale"].shape, generator=g, device=dev)}
        else:
            params[name] = torch.randn(decl.shape, generator=g, device=dev
                                       ).mul_(decl.shape[0] ** -0.5)
    B, n = SERVE_BATCH, MLA_CACHED
    x = torch.randn((B, n, cfg.d_model), generator=g, device=dev)
    pos = torch.arange(n, device=dev)[None].expand(B, n)
    noise = [torch.randn((B, SERVE_MAX - n, w), generator=g, device=dev)
             for w in (cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim)]
    out = {"shape": {"batch": B, "cached": n, "cache": SERVE_MAX,
                     "heads": cfg.n_heads, "kv_rank": cfg.mla.kv_lora_rank,
                     "rope": cfg.mla.qk_rope_head_dim}}
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, MLA_BF16_TOL)):
        p = {k: ({kk: vv.to(dtype) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dtype))
             for k, v in params.items()}
        xx = x.to(dtype)
        full, (ckv, kr) = mla.mla_prefill(p, xx, cfg, pos, impl="chunked")
        ckv = torch.cat([ckv, noise[0].to(dtype)], 1)
        kr = torch.cat([kr, noise[1].to(dtype)], 1)
        cur = torch.tensor(n, dtype=torch.int32, device=dev)

        def decode():
            return mla.mla_decode(p, xx[:, n - 1:n], cfg, ckv, kr, cur,
                                  pos[:, n - 1:n])
        dec = decode()[:, 0].float()
        want = full[:, -1].float()
        torch.cuda.synchronize()
        err = float((dec - want).abs().max())
        assert torch.allclose(dec, want, rtol=tol, atol=tol), (dtype, err)
        out[str(dtype).replace("torch.", "")] = {
            "max_abs_err": err, "tolerance": tol,
            "out_abs_max": float(want.abs().max()),
            "decode_ms": median_ms(decode, reps=5, inner=4)}
        del p, xx, full, ckv, kr, dec, want
    return out


# ---------------------------------------------------------------- server --
YML = f"""
name: "CIFAR10_RESNET18"
active_learning:
  strategy:
    type: "lc"
  model:
    name: "resnet18"
    batch_size: {BATCH_IMG}
  device: cuda
  target_accuracy: 0.99
al_worker:
  protocol: "tcp"
  host: "127.0.0.1"
  port: 0
  replicas: 1
"""


def run_server(counters):
    """The image path over TCP. ``counters`` maps each kernel module's
    reset to its LAUNCHES; returns this path's launch counts, the pool's
    features, the server's backend and its selections (the sharded phase
    holds its servers against them)."""
    from repro_torch.data.synthetic import image_pool
    from repro_torch.service.client import ALClient, serve_tcp
    from repro_torch.service.config import ALServiceConfig
    from repro_torch.service.server import ALServer

    cfg = ALServiceConfig.from_yaml(YML)
    srv = ALServer(cfg)
    assert srv.device.type == "cuda" and cfg.replicas == 1
    rpc = serve_tcp(srv, cfg.host, cfg.port)
    cli = ALClient(url=f"{cfg.host}:{rpc.port}")
    wall = {}
    try:
        xs, ys = image_pool(POOL, hw=HW, seed=3)
        ex, ey = image_pool(EVAL, hw=HW, seed=4)
        for reset in counters:
            reset()                              # the main path starts here
        t = time.perf_counter()
        keys = []
        for s in range(0, POOL, 2_500):
            keys += cli.push_data(list(xs[s:s + 2_500]))
        wall["push_pool"] = time.perf_counter() - t
        key2y = dict(zip(keys, (int(y) for y in ys)))
        t = time.perf_counter()
        srv.attach_oracle(lambda ks: [key2y[k] for k in ks], ex, ey)
        wall["attach_oracle_eval"] = time.perf_counter() - t
        picks = {}
        for strategy in ("lc", "mc", "rc", "es", "kcg", "dbal", "badge"):
            t = time.perf_counter()
            res = cli.query(budget=BUDGET, strategy=strategy, rng_seed=1)
            wall[f"query_{strategy}"] = time.perf_counter() - t
            assert len(set(res["keys"])) == BUDGET, strategy
            picks[strategy] = res["keys"]
        t = time.perf_counter()
        cli.label(picks["lc"], [key2y[k] for k in picks["lc"]])
        wall["label"] = time.perf_counter() - t
        t = time.perf_counter()
        acc = cli.train_eval()
        wall["train_eval"] = time.perf_counter() - t
        t = time.perf_counter()
        res = cli.query(budget=BUDGET, strategy="coreset", rng_seed=2)
        wall["query_coreset_warm"] = time.perf_counter() - t
        assert len(set(res["keys"])) == BUDGET
        assert not set(res["keys"]) & set(picks["lc"])
        picks["coreset"] = res["keys"]
        t = time.perf_counter()
        auto = cli.query(budget=AUTO_BUDGET, strategy="auto")
        wall["query_auto"] = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = {}
        for counts in counters.values():         # ... and ends here
            launches.update(counts)
        stats = cli.stats()
        feats = srv.session()._artifact_snapshot()[0][0]
        # the standing path on this server, over TCP, after its checks
        stream = standing_stream(xs, keys, picks["lc"])
        standing = run_standing("replicas1", srv, cli, counters, stream)
    finally:
        cli.close()
        rpc.stop()
        srv.close()
    assert np.isfinite(acc) and 0.0 <= acc <= 1.0
    assert auto["budget_spent"] > 0 and auto["rounds"] >= 1
    assert stats["pool"] == POOL and stats["labeled"] == BUDGET
    for name in ("greedy_round", "pairwise_min_argmin"):
        assert launches[name] > 0, f"{name} never launched on the main path"
    for name in ("flash_attention", "decode_attention", "uncertainty_stats"):
        assert launches[name] == 0, launches     # no LM on this path
    assert feats.shape == (POOL, D) and np.isfinite(feats).all()
    log("server", wall_s=wall, launches=launches,
        embed_rows=srv.embed_rows, accuracy=acc,
        strategy_state=stats["strategy_state"],
        auto={k: auto[k] for k in ("strategy", "accuracy", "stop_reason",
                                   "rounds", "eliminated", "budget_spent")})
    return {"launches": launches, "feats": feats, "backend": srv.backend,
            "picks": picks, "key2y": key2y, "stream": stream,
            "standing": standing}


# -------------------------------------------------------------- standing --
# the stream a coreset standing query (budget BUDGET, rng 2) watches: six
# deltas of 256 near-duplicates of labeled images (each row a labeled
# image plus N(0, 1e-4) noise, so a new content key), then 1,024 fresh
# images from a new seed, then one more near-duplicate delta pushed
# asynchronously (its emit is the ingest worker's)
STANDING_DUPS, STANDING_ROWS, STANDING_FRESH, STANDING_SEED = 6, 256, 1_024, 2


def standing_stream(xs, keys, labeled):
    from repro_torch.data.synthetic import image_pool
    rng = np.random.default_rng(5)
    pos = {k: i for i, k in enumerate(keys)}
    src = xs[np.asarray([pos[k] for k in labeled])]

    def dups(i):
        rows = src[(np.arange(STANDING_ROWS) + i * STANDING_ROWS) % len(src)]
        return list(rows + rng.normal(scale=1e-4, size=rows.shape)
                    .astype(np.float32))

    fresh, _ = image_pool(STANDING_FRESH, hw=HW, seed=6)
    return ([dups(i) for i in range(STANDING_DUPS)] + [list(fresh)],
            dups(STANDING_DUPS))


def run_standing(name, srv, cli, counters, stream, poll_each=True):
    """A coreset standing query at budget BUDGET on ``cli``'s server,
    watching ``stream``. With ``poll_each`` every sync delta is followed by
    a poll on this thread, whose one emit is timed with its B1 launches,
    ``pool_rows``, the replay's rounds and readbacks, and held against a
    one-shot query at that moment; the modes must be replay x 6, then full.
    Without it (the ``strategy_state_cache: false`` server: full emits
    only) the sync deltas go in unpolled. Either way the async delta's
    emit is the ingest worker's, and its keys equal a one-shot query.
    Launch counts are zeroed just before and read just after. Returns
    (final keys, launch counts)."""
    from repro_torch.kernels.pairwise import ops
    sync_deltas, async_delta = stream
    oneshot = dict(budget=BUDGET, strategy="coreset", rng_seed=STANDING_SEED)
    for reset in counters:
        reset()                                  # the standing path starts
    t = time.perf_counter()
    reg = cli.standing_register(**oneshot)
    register_ms = (time.perf_counter() - t) * 1e3
    qid, seq = reg["query_id"], reg["seq"]
    assert reg["keys"] == cli.query(**oneshot)["keys"], name
    emits = []
    for rows in sync_deltas:
        cli.push_data(rows)
        if not poll_each:
            continue
        sq0 = srv.stats()["standing_queries"]
        b1 = ops.LAUNCHES["greedy_round"]
        t = time.perf_counter()
        with ops.track_ops() as st:
            r = cli.standing_poll(qid, since=seq)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        pool_rows = st["pool_rows"]
        b1 = ops.LAUNCHES["greedy_round"] - b1
        sq1 = srv.stats()["standing_queries"]
        assert len(r["emits"]) == 1, (name, r["emits"])
        seq = r["seq"]
        e = r["emits"][0]
        emits.append({
            "mode": e["mode"], "rows": len(rows), "wall_ms": wall_ms,
            "b1_launches": b1, "pool_rows": pool_rows,
            "replay_rounds": sq1["replay_rounds"] - sq0["replay_rounds"],
            "host_readbacks": (sq1["replay_readbacks"]
                               - sq0["replay_readbacks"]),
            "added": len(e["added"]),
            "keys_equal_oneshot": r["keys"] == cli.query(**oneshot)["keys"]})
    cli.push_data(async_delta, asynchronous=True)
    cli.flush()
    r = cli.standing_poll(qid, since=seq)
    assert len(r["emits"]) == 1, (name, r["emits"])
    final = r["keys"]
    async_equal = final == cli.query(**oneshot)["keys"]
    torch.cuda.synchronize()
    launches = {}
    for counts in counters.values():             # ... and ends here
        launches.update(counts)
    sq = srv.stats()["standing_queries"]
    cli.standing_cancel(qid)
    replay = [e for e in emits if e["mode"] == "replay"]
    full = [e for e in emits if e["mode"] == "full"]
    ratio = (np.mean([e["pool_rows"] for e in full])
             / np.mean([e["pool_rows"] for e in replay])
             if replay and full else None)
    log("standing", server=name, budget=BUDGET, register_ms=register_ms,
        emits=emits, async_emit_mode=r["emits"][0]["mode"],
        pool_rows_ratio_full_over_replay=ratio, counters=sq,
        launches=launches)
    assert async_equal, name
    assert all(e["keys_equal_oneshot"] for e in emits), (name, emits)
    if poll_each:
        assert [e["mode"] for e in emits] == ["replay"] * STANDING_DUPS + [
            "full"], (name, emits)
        for e in replay:
            # budget - 1 B1 rounds, one readback; the rest of its launches
            # extend the persisted state over the delta rows
            assert e["replay_rounds"] == BUDGET - 1, e
            assert e["host_readbacks"] == 1 and e["b1_launches"] >= \
                BUDGET - 1, e
    else:
        assert sq["replay_emits"] == 0 and sq["full_emits"] == sq["emits"]
    assert launches["greedy_round"] > 0, (name, launches)
    return final, launches


def agreement(feats, dev):
    """k-center greedy, budget 1,000, over the server's real features,
    through the kernel and through the plain version, same seed."""
    from repro_torch.common import rng as rnglib
    from repro_torch.core.strategies.diversity import k_center_greedy
    x = torch.from_numpy(np.ascontiguousarray(feats)).to(dev)
    k = rnglib.key(0)
    t = time.perf_counter()
    a = k_center_greedy(k, BUDGET, x).cpu().numpy()
    t_kernel = time.perf_counter() - t
    t = time.perf_counter()
    b = k_center_greedy(k, BUDGET, x, impl="ref").cpu().numpy()
    t_plain = time.perf_counter() - t
    diff = np.nonzero(a != b)[0]
    first = int(diff[0]) if diff.size else BUDGET
    assert len(set(a.tolist())) == BUDGET
    log("agree", rounds_before_divergence=first, budget=BUDGET,
        same_set=bool(set(a.tolist()) == set(b.tolist())),
        kernel_s=t_kernel, plain_s=t_plain)


# ---------------------------------------------------------------- picker --
def run_picker(dev, counters, tune_dir):
    """``autotune_blocks(POOL, D, measure=True)`` for both round variants
    into a fresh cache directory (the kernels phase's calls already tuned
    some shapes into the run's first one; the later phases use this one);
    each candidate's time and the winner; then the disk entry must serve a
    lookup after the in-memory cache is cleared, launching nothing.
    Returns the launch counts and the winners."""
    from repro_torch.kernels.pairwise import autotune, ops
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE_DIR"] = os.path.join(tune_dir,
                                                                "picker")
    autotune.clear_cache()
    for reset in counters:
        reset()                                  # the picker path starts here
    picks = {}
    for variant in autotune.VARIANTS:
        t = time.perf_counter()
        ch = autotune.autotune_blocks(POOL, D, measure=True, variant=variant,
                                      device=dev)
        picks[variant] = {"n_block": ch.n_block, "r_block": ch.r_block,
                          "source": ch.source, "ms": ch.wall_s * 1e3,
                          "ms_by_n_block": {nb: s * 1e3 for nb, s in ch.timed},
                          "tune_wall_s": time.perf_counter() - t}
        assert ch.source == "measured" and len(ch.timed) == len(
            autotune.N_BLOCK_CANDIDATES), ch
        assert ch.r_block == autotune.model_blocks(POOL, D).r_block
    torch.cuda.synchronize()
    launches = {}
    for counts in counters.values():             # ... and ends here
        launches.update(counts)
    assert launches["gated_greedy_round"] > 0, launches
    assert launches["greedy_round"] > 0, launches
    before = dict(ops.LAUNCHES)
    autotune.clear_cache()                       # as a fresh process
    for variant in autotune.VARIANTS:
        again = autotune.autotune_blocks(POOL, D, measure=True,
                                         variant=variant, device=dev)
        assert again.source == "measured" and \
            again.n_block == picks[variant]["n_block"], (variant, again)
        assert os.path.exists(os.path.join(
            autotune.cache_dir(), f"n{POOL}_d{D}_float32_{variant}.json"))
    assert ops.LAUNCHES == before, "a disk hit must not measure again"
    log("picker", shape=[POOL, D], cache_dir=autotune.cache_dir(),
        winners=picks, launches=launches, disk_reread=True)
    return launches, picks


# --------------------------------------------------------------- sharded --
SHARDED_STRATEGIES = ("lc", "kcg", "dbal", "badge")
# a second, shorter k-center depth on the full-scan and prefilter servers:
# the depth the prefilter's queries were timed at before its engine folded
# a slot in one round (greedy picks are a prefix property, so its keys
# are held against the first SHORT keys of replicas 1)
SHORT = 200


def engine_query(ops, fn):
    """Runs ``fn()`` (one query) with the prefilter engine's counters and
    the selection kernels' launches read around it. Returns (fn's result,
    the engine's counts with per-(slot, shard) means, or None when the
    query ran no gated k-center engine)."""
    from repro_torch.core import prefilter as pf
    pf.reset_engine_stats()
    before = dict(ops.LAUNCHES)
    res = fn()
    eng = dict(pf.ENGINE_STATS)
    if not eng["proposals"]:
        return res, None
    eng["b1_launches"] = ops.LAUNCHES["greedy_round"] - before["greedy_round"]
    eng["b5_launches"] = (ops.LAUNCHES["gated_greedy_round"]
                          - before["gated_greedy_round"])
    per = eng["proposals"]
    eng["per_slot_shard"] = {k: eng[k] / per for k in (
        "waves", "syncs", "b5_launches", "segments_folded")}
    return res, eng


def run_sharded(base, counters):
    """Servers at ``replicas: 3`` over the image pool, pushed in-process:
    (a) prefilter off, (b) prefilter off with ``strategy_state_cache:
    false`` (warm coreset only: from-scratch min-dists against the
    persisted state), (c) prefilter on at slack 1e6, (d) prefilter on at
    the default slack. Each repeats the image phase's selections (rng 1
    before labels; label its lc picks, train_eval, warm coreset at rng 2)
    and is held against the ``replicas: 1`` server's keys ``base``; the
    prefilter servers' k-center queries log the engine's waves, B5
    launches and host syncs per (slot, shard) and must launch no B1. As in
    the reference's prefilter
    benchmark, a budget-1 lc query (and a budget-1 coreset query after
    labeling) builds the artifact columns, the centroid summaries and the
    persisted k-center state outside the ``pool_rows`` windows."""
    from repro_torch.data.synthetic import image_pool
    from repro_torch.kernels.pairwise import ops
    from repro_torch.service.client import ALClient
    from repro_torch.service.config import ALServiceConfig
    from repro_torch.service.server import ALServer
    picks, key2y = base["picks"], base["key2y"]
    xs, _ = image_pool(POOL, hw=HW, seed=3)
    full = {s: BUDGET for s in SHARDED_STRATEGIES + ("coreset",)}
    gated = {"lc": BUDGET, "kcg": BUDGET, "coreset": BUDGET}
    runs = (("replicas3", {}, full),
            # the from-scratch oracle of the persisted k-center state: its
            # warm coreset must equal the state-backed servers' keys
            ("replicas3_no_state", dict(strategy_state_cache=False),
             {"coreset": BUDGET}),
            ("prefilter_loose", dict(prefilter=True, prefilter_slack=1e6),
             gated),
            ("prefilter_default", dict(prefilter=True), gated))
    out, all_launches = {}, {}
    standing = dict(base["standing"][1])
    for name, extra, budgets in runs:
        cfg = dataclasses.replace(ALServiceConfig.from_yaml(YML), replicas=3,
                                  **extra)
        srv = ALServer(cfg, backend=base["backend"])
        cli = ALClient(local=srv)
        wall, rows, keys_of, engine = {}, {}, {}, {}
        try:
            for reset in counters:
                reset()                          # this server's path starts
            t = time.perf_counter()
            keys = []
            for s in range(0, POOL, 2_500):
                keys += cli.push_data(list(xs[s:s + 2_500]))
            wall["push_pool"] = time.perf_counter() - t
            assert keys == list(key2y)

            def query(strategy, seed, budget, tag=None):
                tag = tag or strategy
                t = time.perf_counter()
                with ops.track_ops() as st:
                    res, eng = engine_query(ops, lambda: cli.query(
                        budget=budget, strategy=strategy, rng_seed=seed))
                wall[f"query_{tag}"] = time.perf_counter() - t
                rows[tag] = st["pool_rows"]
                keys_of[tag] = res["keys"]
                if eng is not None:
                    engine[tag] = eng

            t = time.perf_counter()
            cli.query(budget=1, strategy="lc")   # columns and summaries
            wall["warm_lc_budget1"] = time.perf_counter() - t
            for strategy in SHARDED_STRATEGIES:
                if strategy in budgets:
                    query(strategy, 1, budgets[strategy])
            if "kcg" in budgets:
                query("kcg", 1, SHORT, f"kcg_{SHORT}")
            t = time.perf_counter()
            cli.label(picks["lc"], [key2y[k] for k in picks["lc"]])
            cli.train_eval()
            cli.query(budget=1, strategy="coreset")   # persisted state
            wall["label_train_eval_warm_coreset"] = time.perf_counter() - t
            query("coreset", 2, budgets["coreset"])
            if "kcg" in budgets:
                query("coreset", 2, SHORT, f"coreset_{SHORT}")
            torch.cuda.synchronize()
            launches = {}
            for counts in counters.values():     # ... and ends here
                launches.update(counts)
            stats = srv.stats()
            if name in ("replicas3", "replicas3_no_state"):
                # the same stream as the replicas 1 server's standing query
                final, sl = run_standing(name, srv, cli, counters,
                                         base["stream"],
                                         poll_each=name == "replicas3")
                assert final == base["standing"][0], name
                for k, v in sl.items():
                    standing[k] = standing.get(k, 0) + v
        finally:
            cli.close()
            srv.close()
        assert stats["replicas"] == 3 and stats["workers"]["lanes"] == 3
        assert launches["greedy_round"] > 0, (name, launches)
        assert stats["strategy_state"]["enabled"] == (
            name != "replicas3_no_state"), (name, stats["strategy_state"])
        # every selection against replicas 1's keys at the same depth
        want = {s: picks[s.split("_")[0]][:len(keys_of[s])] for s in keys_of}
        equal = {s: keys_of[s] == want[s] for s in keys_of}
        agree = {s: len(set(keys_of[s]) & set(want[s])) / len(want[s])
                 for s in keys_of}
        out[name] = {"keys": keys_of, "rows": rows}
        all_launches[name] = launches
        base_rows = out["replicas3"]["rows"]
        ratio = ({s: base_rows[s] / max(rows[s], 1) for s in rows}
                 if name != "replicas3" else None)
        log("sharded", server=name, replicas=3, wall_s=wall,
            keys_equal=equal, key_agreement_with_replicas1=agree,
            pool_rows=rows, pool_rows_ratio_full_over_this=ratio,
            launches=launches, engine=engine,
            workers={k: stats["workers"][k] for k in
                     ("tasks", "restarts", "straggler_events")},
            summary_builds=stats["artifacts"]["summary_builds"],
            strategy_state=stats["strategy_state"])
        if name.startswith("prefilter"):
            assert engine["kcg"]["b1_launches"] == 0, engine["kcg"]
        # the bound prunes only clusters that cannot hold the argmax, at
        # any slack: gated keys equal the full scan's at both slacks
        assert all(equal.values()), (name, equal)
    all_launches.update(run_clumped(counters))
    total = {}
    for launches in all_launches.values():
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total, standing


# --------------------------------------------------------------- process --
# the process lanes' pool: cut from 50,000 to 8,192 images to stay in the
# run's time (every artifact build re-embeds through the children)
PROC_POOL, PROC_EXTRA, PROC_LABELED, PROC_BUDGET = 8_192, 768, 512, 256


def run_process(counters):
    """``worker_backend: process`` at ``replicas: 3`` (ResNet-18 on the
    card in every child) against a ``thread`` server fed the same pushes,
    both with ``cache_bytes: 1`` so every artifact build re-embeds through
    ``_embed_chunk`` (as ``embed_batch`` jobs on the process server). The
    children start together on a first job each (their start time and the
    device memory they took); each job's bytes equal the inline chunk's;
    coreset and kcg keys at budget 256 equal the thread server's; then
    lane 0's child is SIGKILLed at its first job of a query (after a
    768-row push), which must still return the thread server's keys with
    the lane restarted. Launch counts zeroed before, read after."""
    from repro_torch.data.synthetic import image_pool
    from repro_torch.service.config import ALServiceConfig
    from repro_torch.service.server import ALServer
    base = dataclasses.replace(ALServiceConfig.from_yaml(YML), replicas=3,
                               cache_bytes=1, worker_timeout_s=600.0)
    xs, ys = image_pool(PROC_POOL, hw=HW, seed=7)
    extra, _ = image_pool(PROC_EXTRA, hw=HW, seed=8)
    for reset in counters:
        reset()                                  # the process path starts
    srvs = {kind: ALServer(dataclasses.replace(base, worker_backend=kind))
            for kind in ("thread", "process")}
    proc, thread = srvs["process"], srvs["thread"]
    rt = proc.shard_runtime()
    jobs = {"jobs": 0, "rows": 0, "kill_armed": False}
    run_job = rt.run_job

    def counted(shard, name, payload, on_death=None):
        jobs["jobs"] += 1
        jobs["rows"] += len(payload["raw"])
        if jobs["kill_armed"] and shard == 0:
            jobs["kill_armed"] = False
            rt.kill(0)                           # SIGKILL, mid-query
        return run_job(shard, name, payload, on_death)

    wall, keys_of = {}, {}
    try:
        rt.run_job = counted
        job = {"config": dataclasses.asdict(proc.config),
               "raw": xs[:BATCH_IMG], "bs": BATCH_IMG}
        torch.cuda.synchronize()
        free0 = torch.cuda.mem_get_info()[0]

        def first_job(i):
            t = time.perf_counter()
            out = rt.run_job(i, "embed_batch", job)
            return time.perf_counter() - t, out

        with cf.ThreadPoolExecutor(3) as ex:
            started = list(ex.map(first_job, range(3)))
        free1 = torch.cuda.mem_get_info()[0]
        inline = thread._embed_chunk(job["raw"], BATCH_IMG, shard_hint=0,
                                     backend=thread.backend)
        bytes_equal = [bool(np.array_equal(out, inline))
                       for _, out in started]
        ragged = xs[BATCH_IMG:BATCH_IMG + 100]
        bytes_equal.append(bool(np.array_equal(
            proc._embed_chunk(ragged, BATCH_IMG, shard_hint=1,
                              backend=proc.backend),
            thread._embed_chunk(ragged, BATCH_IMG, shard_hint=1,
                                backend=thread.backend))))
        jobs_before = dict(jobs)
        for kind, srv in srvs.items():
            t = time.perf_counter()
            keys = []
            for s in range(0, PROC_POOL, 2_048):
                keys += srv.push_data(list(xs[s:s + 2_048]))
            wall[f"{kind}_push"] = time.perf_counter() - t
            t = time.perf_counter()
            srv.query(budget=1, strategy="lc")   # re-embeds all 8,192 rows
            torch.cuda.synchronize()
            wall[f"{kind}_reembed"] = time.perf_counter() - t
            srv.label(keys[:PROC_LABELED], [int(y) for y in
                                            ys[:PROC_LABELED]])
            srv.train_and_eval()
            for strategy in ("coreset", "kcg"):
                t = time.perf_counter()
                keys_of[kind, strategy] = srv.query(
                    budget=PROC_BUDGET, strategy=strategy,
                    rng_seed=1)["keys"]
                wall[f"{kind}_query_{strategy}"] = time.perf_counter() - t
            srv.push_data(list(extra))
            jobs["kill_armed"] = kind == "process"
            t = time.perf_counter()
            keys_of[kind, "coreset_after_kill"] = srv.query(
                budget=PROC_BUDGET, strategy="coreset", rng_seed=3)["keys"]
            wall[f"{kind}_query_coreset_after_push"] = \
                time.perf_counter() - t
        torch.cuda.synchronize()
        launches = {}
        for counts in counters.values():         # ... and ends here
            launches.update(counts)
        workers = rt.stats()
    finally:
        for srv in srvs.values():
            srv.close()
    equal = {s: keys_of["process", s] == keys_of["thread", s]
             for s in ("coreset", "kcg", "coreset_after_kill")}
    rows = PROC_POOL
    log("process", replicas=3, pool=PROC_POOL, budget=PROC_BUDGET,
        child_first_job_s=[s for s, _ in started],
        child_device_mib=(free0 - free1) / 3 / 2**20,
        job_bytes_equal_inline=bytes_equal, keys_equal=equal,
        jobs=jobs["jobs"], job_rows=jobs["rows"],
        reembed_rows_per_s={"jobs": rows / wall["process_reembed"],
                            "inline": rows / wall["thread_reembed"]},
        jobs_in_reembed=jobs["jobs"] - jobs_before["jobs"],
        wall_s=wall, launches=launches,
        workers={k: workers[k] for k in ("tasks", "restarts",
                                         "generations", "deaths")})
    assert all(bytes_equal), bytes_equal
    assert all(equal.values()), equal
    assert workers["restarts"] >= 1 and workers["generations"][0] >= 1, \
        workers
    assert launches["greedy_round"] > 0, launches
    return launches


# The reference's prefilter benchmark (benchmarks/table2_pipeline.py,
# ``_prefilter_gated``): a redundancy-heavy 12,288 x 192 vector pool, an
# MLP backend (feat_dim 32), replicas 3, 128 clusters a shard, 4 labeled
# members per clump, budgets lc/es 16 and coreset/kcg 48; it asserts
# gated == full-scan keys and >= 10x fewer pool rows for lc and coreset.
CLUMP_N, CLUMP_K, CLUMP_D = 12_288, 48, 192
CLUMP_QUERIES = (("lc", 16), ("es", 16), ("coreset", 48), ("kcg", 48))


def dupe_pool(n, clumps, d, seed=11):
    """97 % of rows near-duplicates inside ``clumps`` tight clusters, 3 %
    spread wide, shuffled (the reference benchmark's recipe)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clumps, d)) * 6.0
    n_dupe = int(n * 0.97)
    assign = rng.integers(0, clumps, size=n_dupe)
    dup = centers[assign] + 0.03 * rng.normal(size=(n_dupe, d))
    spread = 8.0 * rng.normal(size=(n - n_dupe, d))
    x = np.concatenate([dup, spread]).astype(np.float32)
    clump_of = np.concatenate([assign, np.full(n - n_dupe, -1)])
    perm = rng.permutation(n)
    return x[perm], clump_of[perm]


def run_clumped(counters, device="cuda"):
    """The prefilter where it prunes: the reference benchmark's clumped
    pool on three ``replicas: 3`` servers (prefilter off, on at the
    default slack, on at slack 1e9). Gated keys must equal the full
    scan's at both slacks, and at the default slack lc and the warm
    coreset must touch >= 10x fewer pool rows, as the reference asserts.
    Launch counts zeroed before each server, read after; returns them."""
    from repro_torch.kernels.pairwise import ops
    from repro_torch.service.backends import MLPBackend
    from repro_torch.service.config import ALServiceConfig
    from repro_torch.service.server import ALServer
    x, clump_of = dupe_pool(CLUMP_N, CLUMP_K, CLUMP_D)
    lab = [int(m) for c in range(CLUMP_K)
           for m in np.nonzero(clump_of == c)[0][:4]]
    runs = (("clumped_full", {}),
            ("clumped_default", dict(prefilter=True)),
            ("clumped_loose", dict(prefilter=True, prefilter_slack=1e9)))
    picks, rows, out = {}, {}, {}
    for name, extra in runs:
        if extra:
            extra.update(prefilter_clusters=128, prefilter_min_rows=64)
        srv = ALServer(ALServiceConfig(device=device, batch_size=64,
                                       replicas=3, **extra),
                       backend=MLPBackend(in_dim=CLUMP_D, feat_dim=32,
                                          device=device))
        wall = {}
        try:
            for reset in counters:
                reset()                          # this server's path starts
            t = time.perf_counter()
            keys = srv.push_data(list(x))
            wall["push_pool"] = time.perf_counter() - t
            srv.label([keys[i] for i in lab],
                      [i % 4 for i in range(len(lab))])
            srv.train_and_eval()
            t = time.perf_counter()
            srv.query(budget=1, strategy="lc")   # columns, summaries
            srv.query(budget=1, strategy="coreset")   # persisted state
            wall["warm_lc_coreset_budget1"] = time.perf_counter() - t
            engine = {}
            for strategy, budget in CLUMP_QUERIES:
                t = time.perf_counter()
                with ops.track_ops() as st:
                    res, eng = engine_query(ops, lambda: srv.query(
                        budget=budget, strategy=strategy, rng_seed=7))
                picks[name, strategy] = res["keys"]
                wall[f"query_{strategy}"] = time.perf_counter() - t
                rows[name, strategy] = st["pool_rows"]
                if eng is not None:
                    engine[strategy] = eng
            if device == "cuda":
                torch.cuda.synchronize()
            launches = {}
            for counts in counters.values():     # ... and ends here
                launches.update(counts)
            builds = srv.stats()["artifacts"]["summary_builds"]
        finally:
            srv.close()
        equal = {s: picks[name, s] == picks["clumped_full", s]
                 for s, _ in CLUMP_QUERIES}
        ratio = {s: rows["clumped_full", s] / max(rows[name, s], 1)
                 for s, _ in CLUMP_QUERIES}
        log("sharded", server=name, replicas=3,
            pool=[CLUMP_N, CLUMP_D], clumps=CLUMP_K, labeled=len(lab),
            wall_s=wall, keys_equal=equal,
            pool_rows={s: rows[name, s] for s, _ in CLUMP_QUERIES},
            pool_rows_ratio_full_over_this=ratio, launches=launches,
            engine=engine, summary_builds=builds)
        if extra:
            assert engine["kcg"]["b1_launches"] == 0, engine["kcg"]
        assert all(equal.values()), (name, equal)
        if name == "clumped_default":
            assert ratio["lc"] >= 10 and ratio["coreset"] >= 10, ratio
        out[name] = launches
    return out


# ------------------------------------------------------------------ text --
TEXT_YML = f"""
name: "TEXT_AL_QWEN3_WIDTHS"
active_learning:
  strategy:
    type: "lc"
  model:
    name: "transformer"
    batch_size: {TEXT_BATCH}
    block_size: 128
    seq_len: {TEXT_SEQ}
    pooling: mean
    modality: text
  device: cuda
  target_accuracy: 0.99
al_worker:
  protocol: "tcp"
  host: "127.0.0.1"
  port: 0
  replicas: 1
"""


def text_backend(cfg):
    """TransformerBackend at qwen3-8b widths, depth cut to TEXT_LAYERS,
    random weights from seed 11, the flash kernel (``"pallas"``)."""
    from repro_torch.configs import get_config
    from repro_torch.service.backends import make_backend
    arch = dataclasses.replace(get_config("qwen3_8b"), n_layers=TEXT_LAYERS)
    return make_backend(cfg.model_name, config=cfg, cfg=arch, seed=11,
                        kv_chunk=128, attention_impl="pallas")


def text_bitwise(be):
    """Features of 64 sequences: bit-identical at block sizes 96, 128 and
    512, and when each sequence has other batchmates (the 64 permuted);
    within FEAT_ATOL of the plain chunked attention path."""
    from repro_torch.data.synthetic import text_pool
    toks, _ = text_pool(64, seq_len=TEXT_SEQ, vocab=be.cfg.vocab, seed=5)
    x = be.preprocess(toks)

    def feats(block, impl="pallas", rows=x):
        be.block_size, be.impl = block, impl
        return np.concatenate([be.features(rows[i:i + TEXT_BATCH])
                               for i in range(0, len(rows), TEXT_BATCH)])

    t = time.perf_counter()
    by_block = {b: feats(b) for b in (96, 128, 512)}
    t_kernel = time.perf_counter() - t
    perm = np.random.default_rng(6).permutation(len(x))
    moved = int((perm // TEXT_BATCH != np.arange(len(x)) // TEXT_BATCH).sum())
    shuffled = np.empty_like(by_block[128])
    shuffled[perm] = feats(128, rows=x[perm])
    t = time.perf_counter()
    chunked = feats(128, "chunked")
    t_chunked = time.perf_counter() - t
    be.block_size, be.impl = 128, "pallas"
    base = by_block[128]
    assert base.shape == (64, be.feat_dim) and np.isfinite(base).all()
    for b, f in by_block.items():
        assert np.array_equal(f, base), f"block {b} changed feature bytes"
    assert moved > 0 and np.array_equal(shuffled, base), \
        "batchmates changed feature bytes"
    err = float(np.abs(chunked - base).max())
    assert err <= FEAT_ATOL, ("kernel vs chunked features", err)
    batch, kernels, batch_wall = profile_device(
        lambda: be.features(x[:TEXT_BATCH]))
    log("text_batch_profile", sequences=TEXT_BATCH, seq_len=TEXT_SEQ,
        device_ms=batch, device_busy_ms=sum(batch.values()),
        kernels=kernels, profiled_wall_s=batch_wall)
    log("bitwise", blocks=sorted(by_block), bit_identical=True,
        batchmates_bit_identical=True, rows_in_another_batch=moved,
        max_abs_err_vs_chunked=err, tolerance_abs=FEAT_ATOL,
        feature_abs_max=float(np.abs(base).max()),
        kernel_s_3_blocks=t_kernel, chunked_s=t_chunked)


def run_text(cfg, be, counters):
    """Text AL over TCP through the transformer backend. Returns the
    launch counts of this path."""
    from repro_torch.data.synthetic import text_pool
    from repro_torch.service.client import ALClient, serve_tcp
    from repro_torch.service.server import ALServer

    srv = ALServer(cfg, backend=be)
    assert srv.device.type == "cuda" and cfg.replicas == 1
    rpc = serve_tcp(srv, cfg.host, cfg.port)
    cli = ALClient(url=f"{cfg.host}:{rpc.port}")
    wall = {}
    try:
        toks, ys = text_pool(TEXT_POOL, seq_len=TEXT_SEQ, vocab=be.cfg.vocab,
                             seed=3)
        etoks, eys = text_pool(TEXT_EVAL, seq_len=TEXT_SEQ,
                               vocab=be.cfg.vocab, seed=4)
        for reset in counters:
            reset()                              # the text path starts here
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        keys = []
        for s in range(0, TEXT_POOL, TEXT_PUSH):
            keys += cli.push_data(list(toks[s:s + TEXT_PUSH]))
        wall["push_pool"] = time.perf_counter() - t
        key2y = dict(zip(keys, (int(y) for y in ys)))
        t = time.perf_counter()
        srv.attach_oracle(lambda ks: [key2y[k] for k in ks], etoks, eys)
        wall["attach_oracle_eval"] = time.perf_counter() - t
        picks = {}
        for strategy in ("lc", "kcg", "dbal", "coreset"):
            t = time.perf_counter()
            res = cli.query(budget=TEXT_BUDGET, strategy=strategy,
                            rng_seed=1)
            wall[f"query_{strategy}"] = time.perf_counter() - t
            assert len(set(res["keys"])) == TEXT_BUDGET, strategy
            picks[strategy] = res["keys"]
        t = time.perf_counter()
        cli.label(picks["lc"], [key2y[k] for k in picks["lc"]])
        wall["label"] = time.perf_counter() - t
        t = time.perf_counter()
        acc = cli.train_eval()
        wall["train_eval"] = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = {}
        for counts in counters.values():         # ... and ends here
            launches.update(counts)
        peak = torch.cuda.max_memory_allocated()
        stats = cli.stats()
    finally:
        cli.close()
        rpc.stop()
    assert np.isfinite(acc) and 0.0 <= acc <= 1.0
    assert stats["pool"] == TEXT_POOL and stats["labeled"] == TEXT_BUDGET
    assert srv.embed_rows == TEXT_POOL
    for name in ("greedy_round", "pairwise_min_argmin", "flash_attention"):
        assert launches[name] > 0, f"{name} never launched on the text path"
    for name in ("decode_attention", "uncertainty_stats"):
        assert launches[name] == 0, launches     # an encoder, no decoding
    # once per layer per encoder call: the pool in canonical batches, the
    # eval set in one call
    calls = TEXT_POOL // TEXT_BATCH + 1
    assert launches["flash_attention"] == TEXT_LAYERS * calls, launches
    feats = srv.session()._artifact_snapshot()[0][0]
    assert feats.shape == (TEXT_POOL, be.feat_dim) and \
        np.isfinite(feats).all()
    log("text", wall_s=wall, launches=launches, embed_rows=srv.embed_rows,
        accuracy=acc, peak_allocated_gb=peak / 1e9,
        encoder_calls=calls)
    return launches


# ----------------------------------------------------------------- serve --
# The kernel path and the plain path of the same bf16 model, teacher-forced
# on the same tokens. Both round p to bf16 before p.v, but the flash
# kernel's products run on the tensor cores in other sum orders, over
# fixed 64-key tiles (the plain path's softmax is one-shot over the
# prompt), in base 2; decode_attention keeps q and p in fp32 where the
# plain path rounds them to bf16. Over 36 bf16 layers that moves the fp32
# logits (O(1) here: random weights) by up to ~0.1 (0.098 on an H100 80GB
# HBM3 at 700 W with the fp32 flash kernel inside, 0.094 with the bf16
# tensor-core one). Random weights
# give near-uniform next-token distributions (p1 ~ 4e-4), where lc = 1 - p1
# and mc = p2 - p1 cannot move by 1e-3 whatever the kernels do; so lc is
# compared as log p1 = log(1 - lc) and mc as mc / p1 = mc / (1 - lc),
# scales on which they vary with the logits. The logits' limit alone
# would allow 0.4 on log p1 = m1 - lse and on log rc = m2 - m1 (each a
# difference of two quantities that move by at most 0.2), so about 0.5 on
# rc and mc / p1 = rc - 1 near rc = 1: the limits below test more than
# it does. It also covers the argmax of every row whose top-2 gap exceeds
# twice it; the share of rows whose argmax agrees is printed, not held.
AGREE_TOL = {"logits": 0.2, "log_p1": 0.15, "mc_over_p1": 0.15, "rc": 0.15,
             "es": 5e-3}
PROFILE_STEPS = 4


def run_serve(counters, arch):
    """``run_serving`` of the arch's ``serve_config`` (full width and
    depth, but for SERVE_DEPTH), bf16. Returns this path's launch
    counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_serving
    cfg = serve_config(arch)
    for reset in counters:
        reset()                                  # the serve path starts here
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = run_serving(cfg, batch=SERVE_BATCH,
                      prompt_len=SERVE_PROMPT, decode_steps=SERVE_STEPS,
                      max_len=SERVE_MAX, seed=0, log=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {}
    for counts in counters.values():             # ... and ends here
        launches.update(counts)
    peak = torch.cuda.max_memory_allocated()
    flash, decode = serve_attention(arch)
    assert launches["flash_attention"] == flash, launches
    assert launches["decode_attention"] == decode * SERVE_STEPS, launches
    assert launches["uncertainty_stats"] == SERVE_STEPS, launches
    assert launches["greedy_round"] == launches["pairwise_min_argmin"] == \
        launches["gated_greedy_round"] == 0
    assert out["final_len"] == SERVE_PROMPT + SERVE_STEPS, out
    assert 0.0 <= out["mean_lc"] <= 1.0, out
    assert 0.0 <= out["mean_es"] <= float(np.log(cfg.padded_vocab)) + 1e-3, \
        out
    log("serve", **out, run_serving_wall_s=wall,
        peak_allocated_gb=peak / 1e9, launches=launches,
        shape={"batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
               "decode_steps": SERVE_STEPS, "max_len": SERVE_MAX,
               "layers": cfg.n_layers,
               "layers_full": get_config(arch).n_layers,
               "first_dense": cfg.moe.first_dense if cfg.moe else None,
               "moe_layers": (cfg.n_layers - cfg.moe.first_dense
                              if cfg.moe else 0),
               "mla": cfg.mla is not None,
               "flash_launches_prefill": flash,
               "decode_launches_step": decode,
               "encoder_layers": cfg.n_enc_layers if cfg.enc_dec else 0,
               "n_patches": cfg.n_patches, "family": cfg.family,
               "heads": [cfg.n_heads, cfg.n_kv_heads],
               "padded_vocab": cfg.padded_vocab, "moe": cfg.moe is not None,
               "soft_cap": cfg.logits_soft_cap, "dtype": "bfloat16"})
    return launches


def _kernel_class(name: str) -> str:
    for key, label in (("decode_attention", "decode_attention"),
                       ("flash_fwd", "flash_attention"),
                       ("uncertainty_stats", "uncertainty_stats")):
        if key in name:
            return label
    if any(k in name.lower() for k in ("gemm", "gemv", "xmma", "nvjet",
                                       "cutlass", "cublas")):
        return "matmul (cuBLAS)"
    return "other (norms, rope, casts, copies, elementwise)"


def profile_device(fn):
    """Device time by kernel class over one call of ``fn`` under
    torch.profiler, and the host wall time of that (profiled) call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_class, kernels = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        label = _kernel_class(ev.key)
        by_class[label] = by_class.get(label, 0.0) + us / 1e3
        kernels += ev.count
    return by_class, kernels, wall


def route_flips(kernel, plain, mo):
    """Shares of (token, layer, choice) routes that differ between two
    runs' recorded routes (``moe.Routes`` lists in call order): the expert
    chosen, and whether the choice was kept, over the prefill's calls and
    the decode steps'."""
    from repro_torch.models.layers import moe
    n_moe = len(kernel) // (1 + AGREE_STEPS)
    out = {}
    for part, calls in (("prefill", slice(0, n_moe)),
                        ("decode", slice(n_moe, None))):
        n = expert = kept = 0
        for a, b in zip(kernel[calls], plain[calls]):
            C = moe.capacity(mo, a.topi.shape[1])
            n += a.topi.numel()
            expert += int((a.topi != b.topi).sum())
            kept += int(((a.slot < C) != (b.slot < C)).sum())
        out[part] = {"routes": n, "expert_share": expert / n,
                     "kept_share": kept / n}
    return out


def frontend(cfg, dev, zeros=False):
    """A served arch's frontend inputs, bf16: frames (SERVE_BATCH,
    n_enc_frames, d) for an enc-dec config, min(n_patches, SERVE_PROMPT)
    patch embeddings for a patch-prefix one; N(0, 1) from a numpy seed,
    or zeros (what ``run_serving`` feeds, as the reference's). Empty for
    the other archs."""
    rng = np.random.default_rng(12)
    out = {}
    for key, n, on in (("frames", cfg.n_enc_frames, cfg.enc_dec),
                       ("patch_embeds", min(cfg.n_patches, SERVE_PROMPT),
                        cfg.n_patches > 0)):
        if on:
            shape = (SERVE_BATCH, n, cfg.d_model)
            a = (np.zeros(shape, np.float32) if zeros
                 else rng.standard_normal(shape, dtype=np.float32))
            out[key] = torch.from_numpy(a).to(dev, torch.bfloat16)
    return out


def serve_checks(dev, arch):
    """On the same weights (seed 0): (1) prefill + AGREE_STEPS
    teacher-forced decode steps through the kernel path and the plain
    path (``attention_impl="chunked"``, plain scores), max |d| of the
    logits and of the four scores, on the scales of AGREE_TOL, against
    it; an enc-dec or patch-prefix arch feeds both paths seeded N(0, 1)
    frames or patch embeddings (``frontend``: zeros would leave whisper's
    encoder output at zero and every llava prompt position a zero patch),
    and its kernel path runs once more on zeros: the logits' largest
    difference between the two runs must exceed AGREE_TOL's, so that
    the frontend is seen to reach the logits. For a MoE config the plain
    path first routes by its own router
    (the share of routes that differ from the kernel path's is printed,
    not held: routing is discontinuous and the paths differ by bf16
    rounding), then again with the kernel path's routes forced
    (``moe.RouteTape``), and that run is held; (2) a torch.profiler
    window over the kernel path's prefill and over PROFILE_STEPS decode
    steps: device time by kernel class, for the device's busy share."""
    from repro_torch.data.synthetic import lm_pool
    from repro_torch.kernels.uncertainty import ops as unc
    from repro_torch.models.layers import moe
    from repro_torch.models.transformer import Model
    cfg = serve_config(arch)
    prompt = torch.from_numpy(lm_pool(SERVE_BATCH, SERVE_PROMPT, cfg.vocab,
                                      seed=0)[0]).to(dev)
    feed = torch.from_numpy(lm_pool(SERVE_BATCH, AGREE_STEPS, cfg.vocab,
                                    seed=1)[0].T.copy()).to(dev)
    params = Model(cfg).init(0, dev)
    front = frontend(cfg, dev)

    def agree_run(impl, score_impl, routes=None, inputs=front):
        model = Model(dataclasses.replace(cfg, attention_impl=impl),
                      routes=routes)
        cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + AGREE_STEPS,
                                 dev)
        t = time.perf_counter()
        cache, logits = model.prefill(params, {"tokens": prompt, **inputs},
                                      cache)
        outs, scores = [logits], []
        for step in range(AGREE_STEPS):
            logits, cache = model.decode_step(params, cache,
                                              feed[step][:, None])
            s = unc.uncertainty_stats(logits, impl=score_impl)
            outs.append(logits)
            scores.append(torch.stack([s[k] for k in KINDS]))
        torch.cuda.synchronize()
        return (torch.stack(outs), torch.stack(scores, 1),
                time.perf_counter() - t)

    def compared(s):                             # (4, steps, B) -> by name
        lc, mc, rc, es = s
        return {"log_p1": torch.log(1.0 - lc), "mc_over_p1": mc / (1.0 - lc),
                "rc": rc, "es": es}

    def diffs(lk, sk, lp, sp):
        ck, cp = compared(sk), compared(sp)
        res = {"logits": float((lk - lp).abs().max())}
        res.update({k: float((ck[k] - cp[k]).abs().max()) for k in ck})
        return res, ck, cp

    extra = {}
    if cfg.moe is None:
        lk, sk, tk = agree_run("pallas", "auto")
        lp, sp, tp = agree_run("chunked", "ref")
    else:
        taken = moe.RouteTape()
        lk, sk, tk = agree_run("pallas", "auto", taken)
        own = moe.RouteTape()
        lo, so, _ = agree_run("chunked", "ref", own)
        unforced, _, _ = diffs(lk, sk, lo, so)
        extra = {"unforced_route_flips": route_flips(
                     taken.recorded, own.recorded, cfg.moe),
                 "unforced_max_abs_diff": unforced,
                 "unforced_argmax_agree_all_rows": float(
                     (lk.argmax(-1) == lo.argmax(-1)).float().mean()),
                 "routes_forced": "kernel path's"}
        del lo, so, own
        lp, sp, tp = agree_run("chunked", "ref",
                               moe.RouteTape(force=taken.recorded))
        del taken
    if front:                  # the frontend reaches the logits
        lz, _, _ = agree_run("pallas", "auto",
                             inputs=frontend(cfg, dev, zeros=True))
        extra["frontend_logits_max_abs_diff"] = float((lk - lz).abs().max())
        extra["frontend_inputs"] = {k: list(v.shape)
                                    for k, v in front.items()}
        del lz
    same = lk.argmax(-1) == lp.argmax(-1)
    res, ck, cp = diffs(lk, sk, lp, sp)
    spread = {k: [float(cp[k].min()), float(cp[k].max())] for k in cp}
    finite = bool(torch.isfinite(lk).all() and torch.isfinite(sk).all()
                  and all(torch.isfinite(v).all() for v in ck.values()))
    log("serve_agree", arch=arch, layers=cfg.n_layers, steps=AGREE_STEPS,
        rows=int(same.numel()), max_abs_diff=res, tolerance=AGREE_TOL,
        finite=finite, logits_abs_max=float(lp.abs().max()),
        plain_range=spread,
        argmax_agree_all_rows=float(same.float().mean()),
        kernel_path_s=tk, plain_path_s=tp, **extra)
    assert finite, res
    for key in AGREE_TOL:
        assert res[key] <= AGREE_TOL[key], (arch, key, res)
    if front:
        seen = extra["frontend_logits_max_abs_diff"]
        assert seen > AGREE_TOL["logits"], (arch, seen)
    del lk, lp, sk, sp, ck, cp

    model = Model(dataclasses.replace(cfg, attention_impl="pallas"))
    n_steps = 2 + PROFILE_STEPS
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + n_steps, dev)
    state = {}

    def prefill():
        state["cache"], state["logits"] = model.prefill(
            params, {"tokens": prompt, **front}, cache)

    def steps(n):
        for _ in range(n):
            tok = torch.argmax(state["logits"], -1).to(torch.int32)
            state["logits"], state["cache"] = model.decode_step(
                params, state["cache"], tok[:, None])
            unc.uncertainty_stats(state["logits"])

    pre, pre_kernels, pre_wall = profile_device(prefill)
    steps(2)                                     # warm
    dec, dec_kernels, dec_wall = profile_device(lambda: steps(PROFILE_STEPS))
    per_step = {k: v / PROFILE_STEPS for k, v in dec.items()}
    log("serve_profile", arch=arch, prefill_device_ms=pre,
        prefill_device_busy_ms=sum(pre.values()),
        prefill_kernels=pre_kernels, prefill_profiled_wall_s=pre_wall,
        decode_steps=PROFILE_STEPS, decode_device_ms_per_step=per_step,
        decode_device_busy_ms_per_step=sum(per_step.values()),
        decode_kernels_per_step=dec_kernels / PROFILE_STEPS,
        decode_profiled_wall_ms_per_step=dec_wall / PROFILE_STEPS * 1e3)
    del params, cache, state, front


# --------------------------------------------------------------- train --
TRAIN_ARCH = "qwen1.5-4b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARM = 4, 512, 20, 3
TRAIN_LR, TRAIN_WARMUP = 3e-4, 5
TRAIN_TOP_OPS = 12


def path_launches(counters):
    out = {}
    for counts in counters.values():
        out.update(counts)
    return out


class SplitUpdate:
    """An optimizer whose ``update`` is the given one's, with CUDA events
    recorded just before and just after it while ``events`` is set."""

    def __init__(self, opt):
        self.opt, self.events = opt, None

    def update(self, grads, state, params):
        if self.events:
            self.events[1].record()
        out = self.opt.update(grads, state, params)
        if self.events:
            self.events[2].record()
        return out


class MeasuredSteps:
    """Stands in for ``launch.train.make_train_step`` during one
    ``run_training`` call and measures two of that run's own steps: the
    one before the last split by CUDA events into the loss's forward +
    backward and the optimizer's update, the last under torch.profiler.
    Every step is the entry point's own ``train_step``."""

    def __init__(self, make_train_step):
        self.make, self.events, self.prof, self.wall = (make_train_step,
                                                        None, None, None)

    def __call__(self, model, opt):
        split = SplitUpdate(opt)
        step_fn = self.make(model, split)
        calls = [0]

        def train_step(params, opt_state, batch):
            calls[0] += 1
            if calls[0] == TRAIN_STEPS - 1:
                self.events = split.events = [
                    torch.cuda.Event(enable_timing=True) for _ in range(3)]
                self.events[0].record()
                try:
                    return step_fn(params, opt_state, batch)
                finally:
                    split.events = None
            if calls[0] == TRAIN_STEPS:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    out = step_fn(params, opt_state, batch)
                    torch.cuda.synchronize()
                    self.wall = time.perf_counter() - t
                self.prof = prof
                return out
            return step_fn(params, opt_state, batch)
        return train_step

    def report(self):
        """(fwd_bwd ms, optimizer ms) by events; (busy ms, kernels, ms by
        class, top rows) of the profiled step's device time."""
        self.events[2].synchronize()
        ev = self.events
        rows, by_class, kernels = [], {}, 0
        for e in self.prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            rows.append((us / 1e3, e.count, e.key[:120]))
            label = _kernel_class(e.key)
            by_class[label] = by_class.get(label, 0.0) + us / 1e3
            kernels += e.count
        rows.sort(reverse=True)
        return ((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])),
                (sum(r[0] for r in rows), kernels, by_class, rows))


def run_train(counters):
    """``run_training`` of qwen1.5-4b's full config (full width, all 40
    layers, bf16 params, AdamW with fp32 state, remat), B 4 x S 512, 20
    steps at the reference's lr 3e-4, warmup 5; no checkpoint, TF32 off.
    Launch counts zeroed just before, read just after (the path runs no
    hand-written kernel: chunked attention and a plain cross-entropy, as
    the reference trains). Checks every loss finite and the mean of the
    last 5 below the mean of the first 5 (``tests/test_train.py``'s
    rule); logs the median step after 3 warm-up steps (the profiled last
    step left out), tokens/s, ``train_mfu`` (6 * n_params * tokens a step
    / step time / the bf16 dense peak) and peak memory. Then the
    ``train_profile`` line: the run's step 19 split by CUDA events, its
    step 20 under torch.profiler (``MeasuredSteps``): the device's busy
    share and its top kernels. Returns the path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    measured = MeasuredSteps(train.make_train_step)
    train.make_train_step = measured
    try:
        for reset in counters:
            reset()                              # the train path starts here
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rep = train.run_training(
            TRAIN_ARCH, smoke=False, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
            seq=TRAIN_SEQ, lr=TRAIN_LR, warmup=TRAIN_WARMUP, log_every=0,
            device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = path_launches(counters)       # ... and ends here
    finally:
        train.make_train_step = measured.make
    peak = torch.cuda.max_memory_allocated()
    losses = np.asarray(rep.losses)
    assert len(losses) == TRAIN_STEPS and np.isfinite(losses).all(), losses
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    assert last < first, (first, last)
    step_s = float(np.median(rep.step_s[TRAIN_WARM:-1]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6.0 * cfg.n_params() * tokens
    log("train", arch=TRAIN_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
        n_params=cfg.n_params(), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
        optimizer="adamw", param_dtype="bfloat16", state_dtype="float32",
        remat=cfg.remat, attention_impl=cfg.attention_impl, tf32=False,
        losses=rep.losses, first5_mean=first, last5_mean=last,
        step_ms=[s * 1e3 for s in rep.step_s],
        median_step_ms=step_s * 1e3, warmup_steps=TRAIN_WARM,
        median_of_steps=[TRAIN_WARM + 1, TRAIN_STEPS - 1],
        tokens_per_s=tokens / step_s, model_flops_per_step=flops,
        peak_flops_s=BF16_FLOPS_S, train_mfu=flops / step_s / BF16_FLOPS_S,
        peak_allocated_gb=peak / 1e9, run_training_wall_s=wall,
        straggler_events=rep.straggler_events, launches=launches,
        nvidia_smi=nvidia_smi())
    (fwd_bwd, upd), (busy, kernels, by_class, rows) = measured.report()
    log("train_profile", arch=TRAIN_ARCH, events_step=TRAIN_STEPS - 1,
        profiled_step=TRAIN_STEPS, events_fwd_bwd_ms=fwd_bwd,
        events_optimizer_ms=upd,
        optimizer_share_of_step=upd / (fwd_bwd + upd),
        profiled_step_wall_ms=measured.wall * 1e3, device_busy_ms=busy,
        device_busy_share=busy / (measured.wall * 1e3), kernels=kernels,
        device_ms_by_class=by_class,
        top_kernels=[{"ms": ms, "count": n, "name": k}
                     for ms, n, k in rows[:TRAIN_TOP_OPS]],
        nvidia_smi=nvidia_smi())
    return launches


def run_train_resume(counters, tmp):
    """``run_training`` of the smoke config on the card with
    ``ckpt_every=5, fail_at=[8]``, 16 steps: one restart, the last
    checkpoint at step 16. Then the device -> host -> device trip: the
    step-16 checkpoint restored onto the card, saved again from there
    (sync and async), and restored again equals the first restore bit for
    bit, and so does a restore onto the CPU."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import run_training
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizer import make_optimizer
    for reset in counters:
        reset()
    t = time.perf_counter()
    rep = run_training(TRAIN_ARCH, smoke=True, steps=16, batch=2, seq=32,
                       pool_size=32, ckpt_dir=os.path.join(tmp, "ck"),
                       ckpt_every=5, fail_at=[8], log_every=0, device="cuda")
    wall = time.perf_counter() - t
    launches = path_launches(counters)
    assert rep.restarts == 1 and rep.steps == 16, rep
    assert rep.ckpt_steps[-1] == 16, rep.ckpt_steps
    assert np.isfinite(rep.losses).all() and len(rep.losses) == 19
    cfg = get_smoke_config(TRAIN_ARCH)
    params = Model(cfg).init(0, "cuda")
    template = (params, make_optimizer("adamw").init(params))
    mgr = CheckpointManager(os.path.join(tmp, "ck"))
    first, step, _ = mgr.restore(template)
    on_cpu, _, _ = mgr.restore(tree_map(lambda t: t.cpu(), template))
    again = CheckpointManager(os.path.join(tmp, "again"))
    again.save(step, first)
    second, _, _ = again.restore(template)
    again.save_async(step + 1, first)
    again.wait()
    third, _, _ = again.restore(template, step + 1)
    leaves = tree_leaves(first)
    for other in (second, third, on_cpu):
        for a, b in zip(leaves, tree_leaves(other)):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    assert all(t.device.type == "cuda" for t in leaves)
    log("train_resume", arch=TRAIN_ARCH, smoke=True, restarts=rep.restarts,
        ckpt_steps=rep.ckpt_steps, losses=rep.losses, wall_s=wall,
        restored_step=step, leaves=len(leaves),
        trip_bitwise_equal=True, launches=launches)
    return launches


AL_MIN_FALL = 0.5      # nats; the two strategies' untrained losses on
                       # their labeled rows differ by ~0.02 (smoke, CPU)


def run_al_train(counters):
    """The AL-train loop (``repro_torch.examples.al_train_loop``) at
    qwen1.5-4b's full width, depth cut to 4 layers: pool 256 x 48, 3
    rounds of budget 32, 30 AdamW fine-tune steps a round, es against
    random. Checks, for both strategies: every loss finite, and the loss
    on the rows labeled by the end falls by more than AL_MIN_FALL from the
    weights before round 0 to those after the last round (what the
    fine-tuning must move). Logs every round's held-out loss (the
    reference's eval, on ``lm_pool`` at seed 99, whose token tables share
    almost no tokens with the training pool's at V 152,064, so fine-tuning
    need not move it) and wall seconds."""
    from repro_torch.examples import al_train_loop as alt
    cfg = alt.config(full=True, depth=4)
    for reset in counters:
        reset()
    out = {s: alt.run(s, cfg, "cuda", log=False) for s in ("es", "random")}
    launches = path_launches(counters)
    for s, o in out.items():
        losses = np.asarray([o["eval0"], *o["evals"], o["labeled0"],
                             o["labeled"]])
        assert np.isfinite(losses).all(), (s, o)
        assert o["labeled"] < o["labeled0"] - AL_MIN_FALL, (s, o)
    log("al_train", arch=alt.ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
        pool=alt.POOL, seq=alt.SEQ, rounds=alt.ROUNDS, budget=alt.BUDGET,
        ft_steps=alt.FT_STEPS, min_fall=AL_MIN_FALL,
        labeled_loss_before={s: o["labeled0"] for s, o in out.items()},
        labeled_loss_after={s: o["labeled"] for s, o in out.items()},
        eval_untrained={s: o["eval0"] for s, o in out.items()},
        evals={s: o["evals"] for s, o in out.items()},
        round_s={s: o["round_s"] for s, o in out.items()},
        launches=launches, nvidia_smi=nvidia_smi())
    return launches


# ---------------------------------------------------------------- mesh --
# (name, N, d, classes, budget): the distributed-selection example's pool
# and the image path's 50,000 x 512 features
MESH_SHAPES = (("example", 65_536, 64, 512, 128),
               ("image", 50_000, 512, 10, 1_000))
MESH_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_pool(n, d, c, seed=0):
    """(features (n, d), logits (n, c), weights (n,)), fp32, from a seed."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d), dtype=np.float32)
    logits = rng.standard_normal((n, c), dtype=np.float32) * 2
    w = rng.uniform(0.001, 1.0, n).astype(np.float32)
    return emb, logits, w


class CheckedRounds:
    """Stands in for ``ops.greedy_round`` in a rank while a k-center runs
    a second time: every kernel round, at the inputs the path gives it
    (the shard's rows, the carried min-dists, the gathered winner, a mask
    of -1 where the winner is another rank's), is held against the plain
    round on the same inputs. The new min-dists within ATOL of the plain
    ones relative to their size (masked rows -1 in both), and the
    kernel's pick scoring, under the plain min-dists, within that much of
    the plain round's best (so the index is the plain one wherever the
    plain top two are further apart) and its score within that much of
    the plain score of that row. Kept on the device, read once."""

    def __init__(self, ops, device):
        self.ops, self.kernel = ops, ops.greedy_round
        self.worst = torch.zeros((), device=device)
        self.bad = torch.zeros((), dtype=torch.bool, device=device)
        self.rounds = 0

    def __call__(self, x, mind, centers, sel_idx, weights=None, **kw):
        got = self.kernel(x, mind, centers, sel_idx, weights=weights, **kw)
        pn, _, ps = self.kernel(x, mind, centers, sel_idx, weights=weights,
                                impl="ref")
        kn, ki, ks = got
        rel = ((kn - pn).abs() / pn.abs().clamp_min(1.0)).max()
        self.worst = torch.maximum(self.worst, rel)
        s = self.ops.masked_weighted_score(pn, weights)
        tol = ATOL * ps.abs().clamp_min(1.0)
        pick = s[ki.long()]
        self.bad |= (rel > ATOL) | ((kn < 0) != (pn < 0)).any()
        self.bad |= pick < ps - tol
        self.bad |= (ks - pick).abs() > tol
        self.rounds += 1
        return got

    def result(self):
        return float(self.worst), bool(self.bad)


def mesh_rank(rank, world, group, device):
    """One rank of the mesh phase: for each shape, its shard's B4 scores
    (held against the plain scores within UNC_TOL) and the replicated
    top-k, k-center unweighted and weighted; launches zeroed just before
    each call, read just after; each k-center timed (ms a round) beside
    ``budget - 1`` all_gathers of a round's buffer alone, then run again
    with every B1 round held against the plain round (``CheckedRounds``),
    which must pick the same indices; the seed's min-dists of the shard
    against the whole pool's rows, bit for bit."""
    import torch.distributed as dist

    from repro_torch.core.selection import (_all_gather,
                                            distributed_k_center,
                                            distributed_top_k,
                                            sharded_scores)
    from repro_torch.kernels.pairwise import ops
    from repro_torch.kernels.uncertainty import ops as unc
    out = {}
    for name, n_all, d, c, budget in MESH_SHAPES:
        emb, logits, w = mesh_pool(n_all, d, c)
        n = n_all // world
        sl = slice(rank * n, (rank + 1) * n)
        x = torch.from_numpy(emb[sl]).to(device)
        lg = torch.from_numpy(logits[sl]).to(device)
        wt = torch.from_numpy(w[sl]).to(device)
        whole = torch.from_numpy(emb).to(device)
        seed_bits = bool(torch.equal(
            ops.sq_dist_to_center(x, whole[0]),
            ops.sq_dist_to_center(whole, whole[0])[sl]))
        del whole
        # warm: the libraries load and the group connects
        distributed_k_center(x, 3, group)
        sync(device)
        r = {"seed_bits_equal": seed_bits}
        ops.reset_launches()
        unc.reset_launches()
        scores = sharded_scores(lg, "lc")
        r["b4_launches"] = unc.LAUNCHES["uncertainty_stats"]
        r["b4_err"] = within(scores, unc.uncertainty_scores(lg, "lc",
                                                            impl="ref"),
                             UNC_TOL["fp32"])
        r["scores"] = scores.cpu()
        r["top_k"] = distributed_top_k(scores, budget, group).cpu()
        for wname, weights in (("unweighted", None), ("weighted", wt)):
            ops.reset_launches()
            dist.barrier(group)
            sync(device)
            t = time.perf_counter()
            sel = distributed_k_center(x, budget, group, weights=weights)
            sync(device)
            dt = time.perf_counter() - t
            r[f"kc_{wname}"] = sel.cpu()
            r[f"kc_{wname}_b1"] = ops.LAUNCHES["greedy_round"]
            r[f"kc_{wname}_ms_round"] = dt * 1e3 / (budget - 1)
            checked = CheckedRounds(ops, device)
            ops.greedy_round = checked
            try:
                again = distributed_k_center(x, budget, group,
                                             weights=weights)
            finally:
                ops.greedy_round = checked.kernel
            worst, bad = checked.result()
            assert not bad and checked.rounds == budget - 1, \
                (name, world, rank, wname, worst, checked.rounds)
            assert torch.equal(again.cpu(), r[f"kc_{wname}"]), \
                (name, world, rank, wname)
            r[f"kc_{wname}_b1_rel_err"] = worst
        buf = torch.zeros(d + 3, device=device)
        dist.barrier(group)
        sync(device)
        t = time.perf_counter()
        for _ in range(budget - 1):
            _all_gather(buf, group)
        sync(device)
        r["gather_ms_round"] = (time.perf_counter() - t) * 1e3 / (budget - 1)
        out[name] = r
    return out


def run_mesh(counters, dev):
    """A11 on the card: ``mesh_rank`` at world 1 (NCCL) and 2 and 4 (gloo,
    every rank on cuda:0), each a spawned debug mesh (the kernels built
    once before, by the env phase). Checks: k-center's indices equal,
    bit for bit, across the world sizes (unweighted and weighted);
    every rank's B1 rounds within ATOL of the plain rounds on the same
    inputs and its B4 scores within UNC_TOL of the plain scores (checked
    in ``mesh_rank``); ``distributed_top_k`` equal to ``stable_top_k`` of
    the unsharded B4 scores; ``sharded_scores`` equal to the unsharded
    scores bit for bit, per row; the seed's min-dists of every shard equal
    to the pool's rows; B1 launches world x (budget - 1) a k-center and
    B4 launches world.
    Returns the path's launches (B1 and B4 summed over ranks and
    calls)."""
    from repro_torch.core.selection import stable_top_k
    from repro_torch.kernels.uncertainty import ops as unc
    from repro_torch.launch.mesh import run_debug_mesh
    for reset in counters:
        reset()                                  # the mesh path starts here
    by_world = {}
    for world, backend in MESH_WORLDS:
        t = time.perf_counter()
        ranks = run_debug_mesh(mesh_rank, world, backend=backend,
                               device=dev.type)
        by_world[world] = (ranks, time.perf_counter() - t)
    launches = path_launches(counters)           # ... and ends here
    b1 = b4 = 0
    for name, n_all, d, c, budget in MESH_SHAPES:
        _, logits, _ = mesh_pool(n_all, d, c)
        whole = unc.uncertainty_scores(torch.from_numpy(logits).to(dev),
                                       "lc").cpu()
        want_top = stable_top_k(whole, budget)[1]
        first = by_world[1][0][0][name]
        summary = {}
        for world, backend in MESH_WORLDS:
            ranks, spawn_s = by_world[world]
            rs = [o[name] for o in ranks]
            assert all(r["seed_bits_equal"] for r in rs), name
            got = torch.cat([r["scores"] for r in rs])
            assert torch.equal(got, whole), (name, world)
            assert sum(r["b4_launches"] for r in rs) == world
            for r in rs:
                assert torch.equal(r["top_k"], want_top), (name, world)
                for wname in ("unweighted", "weighted"):
                    assert torch.equal(r[f"kc_{wname}"],
                                       first[f"kc_{wname}"]), \
                        (name, world, wname)
            for wname in ("unweighted", "weighted"):
                n_b1 = sum(r[f"kc_{wname}_b1"] for r in rs)
                assert n_b1 == world * (budget - 1), (name, world, n_b1)
                b1 += n_b1
            b4 += world
            summary[world] = {
                "backend": backend, "spawn_and_run_s": spawn_s,
                "ms_round": {w: max(r[f"kc_{w}_ms_round"] for r in rs)
                             for w in ("unweighted", "weighted")},
                "gather_ms_round": max(r["gather_ms_round"] for r in rs),
                "b1_max_rel_err_vs_plain": {
                    w: max(r[f"kc_{w}_b1_rel_err"] for r in rs)
                    for w in ("unweighted", "weighted")},
                "b4_max_abs_err_vs_plain": max(r["b4_err"] for r in rs)}
        assert len(set(first["kc_unweighted"].tolist())) == budget
        log("mesh", shape=name, pool=[n_all, d], classes=c, budget=budget,
            tolerance={"b1_rel": ATOL, "b4": UNC_TOL["fp32"]},
            worlds=summary, nvidia_smi=nvidia_smi())
    # the ranks' own launches (the parent's comparison above not counted)
    launches["greedy_round"] += b1
    launches["uncertainty_stats"] += b4
    return launches


def free_device():
    gc.collect()
    torch.cuda.empty_cache()


def run_serve_archs(counters, dev):
    """Each served arch in turn (launch counts zeroed just before its
    ``run_serving``, read just after), its agreement and profile checks,
    and its weights freed before the checks draw theirs and before the
    next arch. Returns launches by arch."""
    out = {}
    for arch in SERVE_ARCHS:
        out[arch] = run_serve(counters, arch)
        free_device()
        serve_checks(dev, arch)
        free_device()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # the block picker's winners go to a directory of this run's own
    tune_dir = tempfile.mkdtemp(prefix="repro-torch-autotune-")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE_DIR"] = tune_dir
    try:
        return run(tune_dir, kernels_only="--kernels-only" in sys.argv[1:])
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run(tune_dir, kernels_only=False) -> int:
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.pairwise import ops
    from repro_torch.kernels.uncertainty import ops as unc
    from repro_torch.service.config import ALServiceConfig

    dev = torch.device("cuda")
    smi = nvidia_smi()
    t = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t
    log("env", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        kernel_build_s=build_s, kernels=sorted(build.SOURCES),
        ptxas_registers_spills=ptxas_report(logs))

    rng = np.random.default_rng(0)
    g_err, g_cases, r_block = check_greedy(ops, dev, rng)
    g_ms, g_plain, (g_bound, g_by), g_fold = time_greedy(ops, dev, rng)
    a_err, a_rows = check_argmin(ops, dev, rng)
    a_ms, a_plain, a_lib, (a_bound, a_by) = time_argmin(ops, dev, rng)
    wide = check_wide(ops, dev, rng)
    f_err, f_cases = check_flash(fa, dev, rng)
    f_ms, f_plain, f_lib, (f_bound, f_by) = time_flash(fa, dev)
    f_bf16 = check_flash_bf16(fa, dev)
    u_err, u_cases = check_uncertainty(unc, dev)
    u_times = time_uncertainty(unc, dev)
    d_err, d_cases = check_decode(da, dev)
    d_time = time_decode(da, dev)
    at_serve = time_serve_shapes(fa, da, unc, dev)
    recurrent = check_recurrent(dev)
    mla_oracle = check_mla(dev)
    gt_err, gt_cases = check_gated(ops, dev, rng)
    gt_forms = check_gated_forms(ops, dev, rng)
    gt_time = time_gated(ops, dev, rng)
    gt_wave = time_wave(ops, dev, rng)
    g_bytes = check_round_bytes(ops, dev, rng)
    g_streams = check_round_streams(ops, dev)
    us_err, us_cases = check_uncertainty_split(unc, dev)
    g_times = time_round(ops, dev)
    kcenter = time_kcenter(dev)
    log("kernels", tolerance_abs=ATOL,
        greedy_round={"cases": g_cases, "max_abs_err": g_err,
                      "r_block": r_block, "timed_shape": [POOL, D, 1],
                      "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound,
                      "bound_by": g_by, "fold_shape": g_fold,
                      "bytes_and_ties": g_bytes, "streams": g_streams,
                      "timed": g_times, "kcenter": kcenter},
        pairwise_min_argmin={"max_abs_err": a_err, "index_rows": a_rows,
                             "timed_shape": [10 * BUDGET, BUDGET, D],
                             "ms": a_ms, "plain_ms": a_plain,
                             "bound_ms": a_bound, "bound_by": a_by,
                             "library_ms": a_lib},
        d4096=wide,
        flash_attention={"cases": f_cases, "max_abs_err": f_err,
                         "tolerance_abs": FLASH_ATOL,
                         "timed_shape": [TEXT_BATCH, TEXT_SEQ, 32, 8, 128],
                         "kv_block": 128, "ms": f_ms, "plain_ms": f_plain,
                         "bound_ms": f_bound, "bound_by": f_by,
                         "library_ms": f_lib, "bf16_prefill": f_bf16},
        uncertainty_stats={"cases": u_cases, "max_abs_err_fp32": u_err,
                           "tolerance": UNC_TOL, "split_ref": {
                               "cases": us_cases, "max_abs_err": us_err,
                               "split_elems": {str(k): v for k, v in
                                               unc.SPLIT_ELEMS.items()}},
                           "decode_shape": u_times[SERVE_BATCH],
                           "pool_scoring_shape": u_times[4_096]},
        decode_attention={"cases": d_cases,
                          "max_abs_err": {"fp32": d_err[torch.float32],
                                          "bf16": d_err[torch.bfloat16]},
                          "tolerance": {"fp32": ATT_TOL[torch.float32],
                                        "bf16": DECODE_BF16_TOL},
                          **d_time},
        gated_greedy_round={"cases": gt_cases, "max_abs_err": gt_err,
                            "mixed_forms_bitwise_b1_cases": gt_forms,
                            "timed_shape": [POOL, D, 1], "n_block": GATED_NB,
                            "live_100": gt_time[1.0],
                            "live_10": gt_time[0.1],
                            "engine_wave": {"live_100": gt_wave[1.0],
                                            "live_10": gt_wave[0.1]}},
        at_serve_shapes=at_serve, recurrent_oracles=recurrent,
        mla_oracle=mla_oracle)
    if kernels_only:
        return 0

    counters = {ops.reset_launches: ops.LAUNCHES,
                fa.reset_launches: fa.LAUNCHES,
                unc.reset_launches: unc.LAUNCHES,
                da.reset_launches: da.LAUNCHES}
    picker_launches, _ = run_picker(dev, counters, tune_dir)
    base = run_server(counters)
    launches = base["launches"]
    agreement(base.pop("feats"), dev)
    sharded_launches, standing_launches = run_sharded(base, counters)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    process_launches = run_process(counters)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = ALServiceConfig.from_yaml(TEXT_YML)
    be = text_backend(cfg)
    text_bitwise(be)
    text_launches = run_text(cfg, be, counters)
    del be
    gc.collect()
    torch.cuda.empty_cache()                 # free the text encoder

    serve_launches = run_serve_archs(counters, dev)

    train_launches = run_train(counters)
    free_device()
    with tempfile.TemporaryDirectory(prefix="repro-torch-ckpt-") as tmp:
        resume_launches = run_train_resume(counters, tmp)
    free_device()
    al_launches = run_al_train(counters)
    free_device()
    mesh_launches = run_mesh(counters, dev)

    def counts(name):
        by_path = {"picker": picker_launches[name], "image": launches[name],
                   "sharded": sharded_launches.get(name, 0),
                   "standing": standing_launches[name],
                   "process": process_launches[name],
                   "text": text_launches[name]}
        by_path.update({"serve_" + arch: counts_[name]
                        for arch, counts_ in serve_launches.items()})
        by_path.update({"train": train_launches[name],
                        "train_resume": resume_launches[name],
                        "al_train": al_launches[name],
                        "mesh": mesh_launches[name]})
        return sum(by_path.values()), by_path

    src = "src/repro_torch/kernels/"
    rows = [
        ("greedy_round", "pairwise/csrc/greedy_round.cu",
         "src/repro/kernels/pairwise/kernel.py:159",
         max(g_err, wide["greedy_round"]["max_abs_err"]), g_ms, g_plain,
         g_bound, g_by, None),
        ("gated_greedy_round", "pairwise/csrc/gated_greedy_round.cu",
         "src/repro/kernels/pairwise/kernel.py:263", gt_err,
         *(gt_wave[1.0][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by")), None),
        ("pairwise_min_argmin", "pairwise/csrc/pairwise_min_argmin.cu",
         "src/repro/kernels/pairwise/kernel.py:87",
         max(a_err, wide["pairwise_min_argmin"]["max_abs_err"]), a_ms,
         a_plain, a_bound, a_by, a_lib),
        ("flash_attention", "flash_attention/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:70", f_err, f_ms,
         f_plain, f_bound, f_by, f_lib),
        ("uncertainty_stats", "uncertainty/csrc/uncertainty_stats.cu",
         "src/repro/kernels/uncertainty/kernel.py:77", u_err,
         *(u_times[SERVE_BATCH][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms"))),
        ("decode_attention", "decode_attention/csrc/decode_attention.cu",
         "src/repro/kernels/decode_attention/kernel.py:62",
         max(d_err.values()),
         *(d_time[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms"))),
    ]
    device_ms = {"greedy_round": g_times[0]["device_ms"],
                 "gated_greedy_round": gt_wave[1.0]["device_ms"],
                 "uncertainty_stats": u_times[SERVE_BATCH]["device_ms"],
                 "decode_attention": d_time["device_ms"]}
    kernels = []
    for name, source, replaces, err, ms, plain, bnd, by, lib in rows:
        total, by_path = counts(name)
        kernels.append({"name": name, "route": "cuda",
                        "source": src + source, "replaces": replaces,
                        "launches": total, "launches_by_path": by_path,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bnd, "bound_by": by, "library_ms": lib,
                        "device_ms": device_ms.get(name)})
    # the flash row's numbers are the fp32 kernel's (text path); the bf16
    # kernel's (serve prefill) stand beside them
    flash = next(r for r in kernels if r["name"] == "flash_attention")
    flash["bf16_source"] = src + "flash_attention/csrc/flash_attention_bf16.cu"
    flash.update({"bf16_" + k: f_bf16[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")})
    # B3 (bf16), B6 and B4 at the other served archs' shapes, where their
    # serve paths run them (by label: the arch, or arch:encoder/:cross)
    for row in kernels:
        key = ("flash_attention_bf16" if row["name"] == "flash_attention"
               else row["name"])
        labels = [a for a in at_serve if key in at_serve[a]]
        if labels:
            row["at_serve_shapes"] = {
                label: {k: v for k, v in at_serve[label][key].items()
                        if k in ("timed_shape", "window", "causal",
                                 "max_abs_err", "ms", "device_ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}
                for label in labels}
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
