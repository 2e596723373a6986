#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: its main path, once, on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on any failed check (exit code != 0):

  build   compiles every CUDA kernel of the port from
          src/repro_torch/kernels/csrc/ with nvcc for sm_90a, all at once;
          fails if ptxas reports spills in K2's Hopper instances
          (flash_fwd_ws), and prints whether it serialized their wgmma.
  kernel  holds K1 (residual_xent) against its plain PyTorch version on
          the card at the reference's test shapes and every zoo vocab,
          then times the kernel, the plain version and one library call
          with CUDA events at the shape the main path gives it, beside the
          bytes bound (H100 SXM peak rates).
  flash   holds K2 (flash_attention) against its plain version at the
          reference's test cells, at head_dim 64/80/128 x three masks x
          ragged lengths x GQA ratios 4 and 1, in f32 and bf16, and at the
          edges of the Hopper design's 128-row, 128-key tiles (lengths,
          windows, qwen3-1.7b's and stablelm-1.6b's heads, a strided
          batch); then, at the prefill shape q (1, 32768, 32, 128), k/v
          (1, 32768, 8, 128) bf16 causal, against the memory-bounded
          chunked plain path (the full plain version would need a 137 GB
          score tensor), and times the kernel, the chunked plain path and
          one SDPA call beside the operations bound; and the same at
          stablelm-1.6b's heads, q and k/v (1, 32768, 32, 64). Prints the
          design the library dispatches each timed shape to.
  slice   one LM-scale GAL fit (repro_torch.core.gal_lm.fit_lm) at the
          published llama3-8b width with depth cut to 2 layers: two orgs,
          batch 4 x seq 512, 2 rounds of 4 local AdamW steps, residuals
          through the residual_xent kernel. Launch counters are zeroed
          just before the fit and read just after it: every kernel of
          the path must have launched. Checks: finite history that falls,
          residual rows summing to 0, predict(rounds=t) replaying the fit.
  prefill the reference's prefill (scoring) step,
          make_prefill_step(cfg, flash=True), at the published llama3-8b
          width with depth cut to 2 layers, on (1, 32768) tokens (the
          prefill_32k shape, batch cut 32 -> 1). Counters are zeroed just
          before the step and read just after: K2 must have launched once
          per layer, and the profiler must show the Hopper design's
          kernel (flash_fwd_ws) n_layers times in one more step. Checks:
          finite (1, 32768, 128256) logits that agree
          with the flash=False step (chunked attention, chunk 1024), a
          control that the comparison catches a wrong mask, and a
          backward through K2 raising NotImplementedError.
  tabular the tabular GAL fit (repro_torch.core.gal.fit, python engine)
          on the card: (c) first, the card against the CPU on the same
          seeded draws (the quickstart's four org models at n 512, one
          round; then six rounds with the MLP org swapped for a Linear
          one); (a) the quickstart's model-autonomy fit at n 16384, d 16,
          four orgs [Linear, StumpBoost(40), KernelRidge, MLP((32,))], mse,
          6 rounds, test MAD, with a train loss that must not rise; (b) a
          K = 1024 classification fit (make_blobs n 20480, d 64), orgs
          [Linear, MLP((64,))] x 2, xent, 4 rounds, test accuracy, whose
          residual goes through K1: counters zeroed just before the fit
          and read just after must show K1 once per round, the profiler
          over a 2-round fit must show the K1 kernel once per round and
          none of a plain softmax's kernels (learnt from calls of it),
          and one round's K1 output must agree with the closed form to
          2e-5.

Prints the card's name and power limit, one JSON line of kernel figures,
and as its last line {"ok": true, "device": {...}}. Exits non-zero without
a CUDA device, and when the port's sources are not beside it.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks from NVIDIA's data sheet: HBM3 bytes/s, f32 flop/s
# outside the tensor cores, and dense bf16 flop/s on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12

ZOO_VOCABS = (32000, 32064, 49152, 51865, 65536, 100352, 128256, 131072,
              151936)
F32_ATOL, BF16_ATOL, ROW_SUM_ATOL = 2e-5, 5e-3, 1e-4

# the slice: llama3-8b at full width, depth cut 32 -> 2. The local AdamW
# lr is the example's 3e-3 (tuned at the smoke width, d_model 256) cut for
# width: Adam moves every weight by ~lr a step, so a logit moves by
# ~lr * d_model, and at d_model 4096 the example's lr leaves the orgs'
# fitted values all noise (etas ~1e-4, train xent flat to 1e-6).
N_LAYERS, BATCH, SEQ, ROUNDS, LOCAL_STEPS, LR = 2, 4, 512, 2, 4, 1e-4

# K2: the reference's tolerances (tests/test_kernels.py), f32 and bf16; a
# bf16 result must also stay within 2^-6 relative RMS of the plain one
# (both round p and the output to bf16, 2^-9 each: a few 2^-9 apart).
FLASH_F32_ATOL, FLASH_BF16_ATOL, FLASH_BF16_REL = 2e-5, 3e-2, 2.0 ** -6
# (B, S, H, KV, hd, causal, window): the reference's four f32 cells and its
# bf16 cell (tests/test_kernels.py); its head_dim-32 cell is held at 64, the
# smallest head_dim the kernel takes (the CPU tests hold hd 32's plain
# version against the reference)
FLASH_REF_CELLS = [(2, 128, 4, 2, 64, True, None),
                   (1, 200, 4, 4, 64, True, 64),
                   (2, 256, 8, 2, 64, False, None),
                   (1, 130, 2, 1, 128, True, 32)]
FLASH_REF_BF16_CELL = (1, 128, 4, 2, 64, True, None)
FLASH_HEAD_DIMS = (64, 80, 128)
FLASH_MASKS = ((True, None), (True, 96), (False, 96))   # (causal, window)
FLASH_LENGTHS = (130, 200, 1000)
FLASH_HEADS = ((8, 2), (4, 4))             # GQA ratio 4 (llama3-8b), MHA
# (B, S, H, KV, hd, causal, window), bf16: the edges of the Hopper design's
# 128-row, 128-key tiles, in length and in window, at both of its head dims;
# qwen3-1.7b's heads (16 / 8, hd 128) and stablelm-1.6b's (32 / 32, hd 64)
FLASH_EDGE_CELLS = (
    [(2, s, 4, 2, hd, True, None) for hd in (128, 64)
     for s in (1, 64, 127, 128, 129, 255, 257, 4097)]
    + [(1, 300, 4, 2, hd, causal, window) for hd in (128, 64)
       for causal in (True, False) for window in (1, 127, 128, 129)]
    + [(1, 1000, 16, 8, 128, True, None), (1, 1000, 32, 32, 64, True, None)])
# a batch of 3 read through a batch stride of twice the contiguous one
FLASH_STRIDED_BATCH = (3, 200, 8, 2)
# the prefill: llama3-8b's published width, depth 32 -> 2, the reference's
# prefill_32k sequence (configs/base.py SHAPES), batch 32 -> 1; the plain
# step runs attention in chunks of 1024 keys (launch/dryrun.py's policy)
PREFILL_SEQ, PREFILL_CHUNK = 32768, 1024
# K2 timed at the prefill length with each head layout of the Hopper
# design's head dims: (H, KV, hd) of llama3-8b and of stablelm-1.6b
TIMED_HEADS = ((32, 8, 128), (32, 32, 64))
HOPPER_DESIGN, HOPPER_KERNEL = "tma-wgmma-ws", "flash_fwd_ws"
# the tabular slice: (a) the quickstart's model-autonomy fit
# (examples/quickstart.py: make_regression, 4 orgs, [Linear,
# StumpBoost(40), KernelRidge, MLP((32,))], mse, 6 rounds) at n 16384, d 16
# (KernelRidge's train kernel 13107^2 f32, 0.69 GB); (b) a K = 1024 blobs
# classification fit, whose (16384, 1024) residual reaches K1; (c) the
# card against the CPU at n 512
TAB_ORGS = 4
TAB_AUTONOMY = dict(n=16384, d=16, rounds=6)
TAB_K1024 = dict(n=20480, d=64, k=1024, rounds=4)
TAB_SMALL_N, TAB_CARD_CPU_RTOL = 512, 1e-3
PROFILED_ROUNDS = 2


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_functions(report):
    """{kernel name: (spill stores, spill loads)} from a -Xptxas -v report."""
    out, name = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif name and "spill stores" in line:
            words = line.replace(",", "").split()
            out[name] = (int(words[words.index("stores") - 3]),
                         int(words[words.index("loads") - 3]))
            name = None
    return out


def time_in_turns(fns, rounds=6, iters=10, warmup=2):
    """{name: [ms per turn]}: each fn timed by time_ms, in rounds that run
    the fns forwards, then backwards, so that drift (the card's clock
    under its power limit) falls on all of them alike."""
    names = list(fns)
    out = {name: [] for name in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            out[name].append(time_ms(fns[name], iters=iters, warmup=warmup))
    return out


class SmClock:
    """Samples the SM clock and power draw with nvidia-smi while open."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        self.samples = [tuple(float(x) for x in line.split(","))
                        for line in out.splitlines() if "," in line]

    def __str__(self):
        busy = [c for c, w in self.samples if w > 300]
        top = max((w for _, w in self.samples), default=0.0)
        return (f"nvidia-smi, {len(self.samples)} samples: SM clock "
                f"{min(busy, default=0):.0f}-{max(busy, default=0):.0f} MHz "
                f"while drawing over 300 W, power up to {top:.0f} W")


def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    secs = time.perf_counter() - t0
    for name in build.KERNELS:
        print(f"[build] {name}: nvcc report\n{build.report(name).strip()}")
    print(f"[build] kernels {list(build.KERNELS)} ready in {secs:.1f} s")
    report = build.report("flash_attention")
    ws = {n: sp for n, sp in ptxas_functions(report).items()
          if HOPPER_KERNEL in n}
    # head_dim 64 and 128
    check(len(ws) == 2, f"ptxas reports {len(ws)} {HOPPER_KERNEL} instances")
    for name, (stores, loads) in ws.items():
        print(f"[build] {name}: {stores} bytes spill stores, {loads} bytes "
              f"spill loads")
        check(stores == 0 and loads == 0, f"{name} spills")
    serial = [line for line in report.splitlines() if "serialized" in line]
    print(f"[build] ptxas serialized wgmma: {'yes' if serial else 'no'}"
          + "".join(f"\n[build]   {line.strip()}" for line in serial))


def kernel_phase(dev):
    """K1 against its plain version; returns the kernel's figures."""
    from repro_torch.kernels.ops import residual_xent
    from repro_torch.kernels.ref import residual_xent_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    cells = [(7, 300, torch.float32), (130, 513, torch.float32),
             (256, 2048, torch.float32)]
    cells += [(64, v, torch.float32) for v in ZOO_VOCABS]
    cells += [(64, 32000, torch.bfloat16), (64, 151936, torch.bfloat16)]
    max_err = {}

    def hold(x, y, label):
        out = residual_xent(x, y)
        torch.cuda.synchronize()
        want = residual_xent_ref(x, y)
        err = float((out - want).abs().max())
        valid = (y >= 0) & (y < x.shape[-1])      # a -1 label pads a row
        row = float(out.sum(-1)[valid].abs().max())
        tol = F32_ATOL if x.dtype == torch.float32 else BF16_ATOL
        print(f"[kernel] residual_xent {label}: max |kernel - plain| = "
              f"{err:.3g} (tol {tol:g}), max |row sum| = {row:.3g} "
              f"(tol {ROW_SUM_ATOL:g})")
        check(out.dtype == torch.float32 and out.shape == x.shape,
              f"residual_xent {label} output {out.dtype} {tuple(out.shape)}")
        check(err <= tol, f"residual_xent {label} error {err}")
        check(row <= ROW_SUM_ATOL, f"residual_xent {label} row sum {row}")
        max_err[label] = err

    for t, v, dtype in cells:
        x = (torch.randn((t, v), generator=gen, device=dev) * 3).to(dtype)
        y = torch.randint(0, v, (t,), generator=gen, device=dev,
                          dtype=torch.int32)
        hold(x, y, f"({t}, {v}) {str(dtype).removeprefix('torch.')}")
    # tied row maxima far apart, and a -1 (padding) label
    x = torch.zeros((4, 128256), device=dev)
    x[:, 3] = 9.0
    x[:, 128250] = 9.0
    x[1, 64000] = 9.0
    y = torch.tensor([3, 128250, -1, 7], device=dev, dtype=torch.int32)
    hold(x, y, "(4, 128256) f32 tied maxima, label -1")

    # timing at the main path's shape: F is (B*S, V) f32, labels int32
    t, v = BATCH * SEQ, 128256
    x = torch.randn((t, v), generator=gen, device=dev) * 3
    y = torch.randint(0, v, (t,), generator=gen, device=dev,
                      dtype=torch.int32)
    hold(x, y, f"({t}, {v}) f32 main-path shape")
    ms = time_ms(lambda: residual_xent(x, y))
    plain_ms = time_ms(lambda: residual_xent_ref(x, y))
    y64 = y.long()
    library_ms = time_ms(
        lambda: torch.nn.functional.one_hot(y64, v).float()
        - torch.softmax(x, dim=-1))
    n_bytes = t * v * (4 + 4) + t * 4     # read logits + labels, write r
    n_ops = t * v * 9     # per element: 4 in the stats pass, 5 in the write
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_F32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[kernel] residual_xent ({t}, {v}) f32: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (one_hot - softmax) "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by bytes "
          f"({n_bytes / 1e9:.3f} GB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; "
          f"ops {ops_ms:.4f} ms); {n_bytes / ms / 1e6:.0f} GB/s achieved")
    return {"name": "residual_xent", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/residual_xent.cu",
            "replaces": "src/repro/kernels/residual_xent.py:68",
            "max_abs_err": max(max_err.values()),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def visible_pairs(s, causal, window):
    """(query, key) pairs that K2's masks leave visible in one (batch,
    head) of length s: the work these inputs need."""
    i = np.arange(s, dtype=np.int64)
    hi = i + 1 if causal else np.full(s, s, np.int64)
    lo = np.maximum(0, i - window + 1) if window is not None else 0
    return int((hi - lo).sum())


def flash_phase(dev):
    """K2 against its plain version; returns the kernel's figures."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, kernel_design)
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.attention import _chunked_attention, _repeat_kv

    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = {}

    def inputs(b, s, h, kv, hd, dtype, q_scale=0.5):
        q = torch.randn((b, s, h, hd), generator=gen, device=dev) * q_scale
        k = torch.randn((b, s, kv, hd), generator=gen, device=dev) * q_scale
        v = torch.randn((b, s, kv, hd), generator=gen, device=dev)
        return q.to(dtype), k.to(dtype), v.to(dtype)

    def hold(out, want, label, bf16):
        diff = (out.float() - want.float())
        err = float(diff.abs().max())
        rel = float(diff.norm() / want.float().norm())
        tol = FLASH_BF16_ATOL if bf16 else FLASH_F32_ATOL
        print(f"[flash] flash_attention {label}: max |kernel - plain| = "
              f"{err:.3g} (tol {tol:g}), relative RMS {rel:.3g}"
              + (f" (tol {FLASH_BF16_REL:g})" if bf16 else ""))
        check(out.dtype == want.dtype and out.shape == want.shape,
              f"flash_attention {label} output {out.dtype} "
              f"{tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"flash_attention {label} "
              f"finite")
        check(err <= tol, f"flash_attention {label} error {err}")
        check(not bf16 or rel <= FLASH_BF16_REL,
              f"flash_attention {label} relative RMS {rel}")
        max_err[label] = err

    cells = [(c, torch.float32) for c in FLASH_REF_CELLS]
    cells.append((FLASH_REF_BF16_CELL, torch.bfloat16))
    for dtype in (torch.float32, torch.bfloat16):
        for hd in FLASH_HEAD_DIMS:
            for causal, window in FLASH_MASKS:
                for s in FLASH_LENGTHS:
                    for h, kv in FLASH_HEADS:
                        cells.append(((2, s, h, kv, hd, causal, window),
                                      dtype))
    cells += [(c, torch.bfloat16) for c in FLASH_EDGE_CELLS]
    for (b, s, h, kv, hd, causal, window), dtype in cells:
        q, k, v = inputs(b, s, h, kv, hd, dtype)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        hold(out, want, f"({b}, {s}, {h}, {kv}, {hd}) causal={causal} "
             f"window={window} {str(dtype).removeprefix('torch.')}",
             dtype == torch.bfloat16)
    b, s, h, kv = FLASH_STRIDED_BATCH
    for hd in (128, 64):
        q, k, v = (t[::2] for t in inputs(2 * b, s, h, kv, hd,
                                          torch.bfloat16))
        check(not q.is_contiguous(), "the strided batch is contiguous")
        out = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        want = flash_attention_ref(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
        hold(out, want, f"({b}, {s}, {h}, {kv}, {hd}) causal bf16, batch "
             f"stride {q.stride(0)} (contiguous {s * h * hd})", True)

    # the prefill length: llama3-8b's heads (the main path's shape), then
    # stablelm-1.6b's, each against the chunked plain path, then timed
    timed = []
    for h, kv, hd in TIMED_HEADS:
        b, s = 1, PREFILL_SEQ
        q, k, v = inputs(b, s, h, kv, hd, torch.bfloat16, q_scale=1.0)
        positions = torch.arange(s, device=dev).expand(b, s)

        def chunked():
            return _chunked_attention(q, _repeat_kv(k, h), _repeat_kv(v, h),
                                      positions, causal=True, window=None,
                                      chunk=PREFILL_CHUNK)

        design = kernel_design(q.dtype, hd)
        label = f"({b}, {s}, {h}, {kv}, {hd}) causal bf16 [{design}]"
        out = flash_attention_cuda(q, k, v, causal=True)
        torch.cuda.synchronize()
        hold(out, chunked(), label + " vs chunked plain", True)
        del out
        torch.cuda.empty_cache()
        # the kernel beside one SDPA call, in turns
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fns = {"K2": lambda: flash_attention_cuda(q, k, v, causal=True),
               "SDPA": lambda: (
                   torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True))}
        with SmClock() as clock:
            turns = time_in_turns(fns)
        med = {name: statistics.median(t) for name, t in turns.items()}
        for name, t in turns.items():
            print(f"[flash]   {name:>12}: median {med[name]:.4f} ms of "
                  f"{len(t)} turns [{' '.join(f'{x:.4f}' for x in t)}]")
        print(f"[flash]   {clock}")
        ms, library_ms = med["K2"], med["SDPA"]
        plain_ms = time_ms(chunked, iters=2, warmup=1)
        n_ops = 4 * hd * b * h * visible_pairs(s, True, None)
        n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = n_ops / PEAK_BF16_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"[flash] flash_attention {label}: kernel {ms:.4f} ms "
              f"({n_ops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the "
              f"bound), plain (chunked, chunk {PREFILL_CHUNK}) "
              f"{plain_ms:.4f} ms, library (SDPA) {library_ms:.4f} ms "
              f"({n_ops / library_ms / 1e9:.1f} TFLOP/s); bound "
              f"{bound_ms:.4f} ms by {bound_by} ({n_ops:.4g} flop at "
              f"{PEAK_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; bytes "
              f"{bytes_ms:.4f} ms for {n_bytes / 1e9:.3f} GB)")
        timed.append({"shape": [[b, s, h, hd], [b, s, kv, hd]],
                      "design": design, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms})
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    main, hd64 = timed
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:69",
            "design": main["design"],
            "max_abs_err": max(max_err.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "hd64": hd64}


def zero_launches():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.residual_xent import residual_xent_cuda
    residual_xent_cuda.launches = 0
    flash_attention_cuda.launches = 0


def read_launches():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.residual_xent import residual_xent_cuda
    return {"residual_xent": residual_xent_cuda.launches,
            "flash_attention": flash_attention_cuda.launches}


def slice_phase(dev):
    """One full-width LM-scale GAL fit; returns each kernel's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core import gal_lm
    from repro_torch.core.losses import CrossEntropyLoss
    from repro_torch.data.tokens import make_token_stream, token_batches
    from repro_torch.utils.pytree import tree_size

    cfg = replace(get_arch("llama3-8b"), n_layers=N_LAYERS)
    rng_np = np.random.default_rng(0)
    stream = make_token_stream(rng_np, cfg.vocab, 20_000)
    toks, labels = next(token_batches(stream, BATCH, SEQ, rng_np))
    toks = torch.from_numpy(toks).to(dev)
    labels = torch.from_numpy(labels).to(dev)
    root = math.isqrt(cfg.vocab)
    views = ((lambda t: (t // root) % cfg.vocab),
             (lambda t: (t % root) % cfg.vocab))

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    orgs = [gal_lm.LMOrganization(i, cfg, views[i]) for i in range(2)]
    for i, org in enumerate(orgs):
        org.init(torch.Generator(device=dev).manual_seed(i), lr=LR,
                 device=dev)
    torch.cuda.synchronize()
    print(f"[slice] {cfg.arch} d_model={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"layers={cfg.n_layers} {cfg.dtype}: 2 orgs x "
          f"{tree_size(orgs[0].params):,} params, init "
          f"{time.perf_counter() - t0:.1f} s")

    zero_launches()
    t0 = time.perf_counter()
    res = gal_lm.fit_lm(orgs, toks, labels, rounds=ROUNDS,
                        local_steps=LOCAL_STEPS, use_kernel=True,
                        generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()

    hist = res.history["train_xent"]
    print(f"[slice] fit_lm engine={res.engine}: train_xent {hist}, "
          f"etas {res.etas}, weights "
          f"{[w.tolist() for w in res.weights]}")
    print(f"[slice] {fit_s:.2f} s for {ROUNDS} rounds = "
          f"{fit_s / ROUNDS:.2f} s/round; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          f"launches {launches}")
    check(all(math.isfinite(v) for v in hist + res.etas),
          f"finite history {hist} {res.etas}")
    check(hist[-1] < hist[0], f"train xent falls: {hist}")
    check(launches["residual_xent"] == ROUNDS,
          f"residual_xent launched {launches['residual_xent']} times in "
          f"{ROUNDS} rounds")

    # outside the counted run: the fit's output, held to the repo's checks
    xent = CrossEntropyLoss()
    n = BATCH * SEQ
    y1 = (labels.reshape(-1, 1).long()
          == torch.arange(cfg.vocab, device=dev)).float()
    for t in range(ROUNDS + 1):
        f_t = res.predict(toks, rounds=t)
        check(f_t.shape == (BATCH, SEQ, cfg.vocab)
              and bool(torch.isfinite(f_t).all()), f"predict(rounds={t})")
        replay = float(xent(y1, f_t.reshape(n, cfg.vocab)))
        print(f"[slice] predict(rounds={t}) xent {replay:.6f} vs history "
              f"{hist[t]:.6f}")
        check(abs(replay - hist[t]) <= 1e-3, f"predict(rounds={t}) replay")
    r = gal_lm.compute_residual(labels, f_t)
    row = float(r.sum(-1).abs().max())
    print(f"[slice] final residual rows sum to 0 within {row:.3g}")
    check(row <= 1e-3, f"residual row sums {row}")
    return launches


def logits_gap(got, want, rows=2048):
    """max |got - want| and ||got - want|| / ||want|| in f32, a block of
    sequence rows at a time (an f32 copy of the whole logits is 17 GB)."""
    err, num, den = 0.0, 0.0, 0.0
    for r0 in range(0, got.shape[1], rows):
        g = got[:, r0:r0 + rows].float()
        w = want[:, r0:r0 + rows].float()
        d = g - w
        err = max(err, float(d.abs().max()))
        num += float(d.square().sum())
        den += float(w.square().sum())
    return err, math.sqrt(num / den)


def logits_atol(logits):
    """Four bf16 ulps at the largest logit. Each step rounds each logit to
    bf16 (half an ulp each), and the two attention outputs feeding the
    layers above differ by up to an ulp of bf16, which moves a logit by
    about one ulp before its rounding: three ulps, and one of margin."""
    top = float(logits.abs().max())
    return 4 * 2.0 ** (math.floor(math.log2(top)) - 7)


def prefill_phase(dev):
    """The reference's prefill step through K2 at full width on 32k
    tokens; returns each kernel's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import make_token_stream, token_batches
    from repro_torch.kernels.flash_attention import kernel_design
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import dtype_of
    from repro_torch.train.steps import make_prefill_step
    from repro_torch.utils.pytree import tree_size

    cfg = replace(get_arch("llama3-8b"), n_layers=N_LAYERS)
    rng_np = np.random.default_rng(0)
    stream = make_token_stream(rng_np, cfg.vocab, PREFILL_SEQ + 4096)
    toks, _ = next(token_batches(stream, 1, PREFILL_SEQ, rng_np))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(3), cfg,
                             device=dev)
    print(f"[prefill] {cfg.arch} d_model={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} hd={cfg.hd} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"rope_theta={cfg.rope_theta:g} layers={cfg.n_layers} {cfg.dtype}: "
          f"{tree_size(params):,} params; tokens {tuple(toks.shape)}")

    def run(step, what):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        zero_launches()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[prefill] {what}: {secs:.4f} s per prefill, "
              f"{PREFILL_SEQ / secs:.0f} tokens/s, peak memory "
              f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above "
              f"the {held / 2**30:.2f} GiB held before the step); launches "
              f"{launches}")
        return logits, launches

    design = kernel_design(dtype_of(cfg), cfg.hd)
    print(f"[prefill] K2 design for {cfg.dtype} at head_dim {cfg.hd}: "
          f"{design}")
    check(design == HOPPER_DESIGN, f"the prefill's K2 design is {design}")
    step = make_prefill_step(cfg, flash=True)
    step(params, batch)                      # warm-up: cuBLAS picks kernels
    logits, launches = run(step, "flash=True (K2)")
    check(launches["flash_attention"] == cfg.n_layers,
          f"K2 launched {launches['flash_attention']} times in a "
          f"{cfg.n_layers}-layer prefill")
    check(logits.shape == (1, PREFILL_SEQ, cfg.vocab)
          and logits.dtype == torch.bfloat16, f"logits {logits.dtype} "
          f"{tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "finite logits")

    # where the step's device time goes, outside the counted run
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"[prefill] device time by kernel (torch.profiler, one step): "
          f"{busy:.3f} ms busy")
    for e in rows[:8]:
        print(f"[prefill]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<3d} {e.key[:90]}")
    k2_rows = [e for e in rows if HOPPER_KERNEL in e.key]
    k2_ms = sum(e.self_device_time_total for e in k2_rows) / 1e3
    print(f"[prefill] K2 ({HOPPER_KERNEL}): {k2_ms:.3f} ms, "
          f"{k2_ms / busy:.1%} of the device time, "
          f"x{sum(e.count for e in k2_rows)}")
    check(sum(e.count for e in k2_rows) == cfg.n_layers,
          f"the profiler shows {HOPPER_KERNEL} "
          f"{sum(e.count for e in k2_rows)} times in a {cfg.n_layers}-layer "
          f"prefill")

    plain_cfg = replace(cfg, attn_chunk=PREFILL_CHUNK)
    plain, plain_launches = run(make_prefill_step(plain_cfg, flash=False),
                                f"flash=False, attn_chunk={PREFILL_CHUNK}")
    check(plain_launches["flash_attention"] == 0, "the plain step ran K2")
    tol = logits_atol(plain)
    err, rel = logits_gap(logits, plain)
    print(f"[prefill] flash=True vs flash=False logits: max |diff| {err:.4g} "
          f"(tol {tol:g} = 4 bf16 ulps at max |logit| "
          f"{float(plain.abs().max()):.4g}), relative RMS {rel:.4g}")
    check(err <= tol, f"prefill logits differ by {err}")
    # control: the same comparison catches a wrong mask in K2
    wrong = make_prefill_step(replace(cfg, window=PREFILL_SEQ // 2),
                              flash=True)(params, batch)
    c_err, c_rel = logits_gap(wrong, plain)
    print(f"[prefill] control, K2 with window {PREFILL_SEQ // 2}: max |diff| "
          f"{c_err:.4g} (must exceed tol {tol:g}), relative RMS {c_rel:.4g}")
    check(c_err > tol, "the logits comparison misses a wrong window")
    del logits, plain, wrong
    torch.cuda.empty_cache()

    # a backward through K2 raises: the kernel has no backward
    q = torch.randn((1, 128, 4, 64), device=dev).bfloat16().requires_grad_()
    k = torch.randn((1, 128, 2, 64), device=dev).bfloat16()
    out = flash_attention(q, k, k, causal=True)
    try:
        out.float().sum().backward()
    except NotImplementedError as exc:
        print(f"[prefill] backward through K2 raises NotImplementedError: "
              f"{exc}")
    else:
        check(False, "a backward through K2 did not raise")
    return launches


def autonomy_fit(n, device, rounds, mlp_org=True):
    """The quickstart's model-autonomy fit at n rows (seed 0 data and
    draws), its last org an MLP((32,)) or a Linear one; returns (result,
    test slices, test y)."""
    from repro_torch.core import gal
    from repro_torch.core.losses import get_loss
    from repro_torch.core.organizations import make_orgs
    from repro_torch.data.partition import split_features
    from repro_torch.data.synthetic import make_regression, train_test_split
    from repro_torch.models.zoo import MLP, KernelRidge, Linear, StumpBoost

    rng = np.random.default_rng(0)
    tr, te = train_test_split(
        make_regression(rng, n=n, d=TAB_AUTONOMY["d"]), rng)
    xs, xs_te = split_features(tr.x, TAB_ORGS), split_features(te.x, TAB_ORGS)
    models = [Linear(), StumpBoost(n_stumps=40), KernelRidge(),
              MLP((32,)) if mlp_org else Linear()]
    res = gal.fit(make_orgs(xs, models), tr.y, get_loss("mse"),
                  gal.GALConfig(rounds=rounds),
                  eval_sets={"test": (xs_te, te.y)}, metrics=("mad",),
                  draws=gal.Draws(0), device=device)
    return res, xs_te, te.y


def k1024_fit(dev, rounds=TAB_K1024["rounds"]):
    """The K = 1024 classification fit; returns (result, train slices,
    train y, loss)."""
    from repro_torch.core import gal
    from repro_torch.core.losses import get_loss
    from repro_torch.core.organizations import make_orgs
    from repro_torch.data.partition import split_features
    from repro_torch.data.synthetic import make_blobs, train_test_split
    from repro_torch.models.zoo import MLP, Linear

    rng = np.random.default_rng(0)
    cfg = TAB_K1024
    tr, te = train_test_split(
        make_blobs(rng, n=cfg["n"], d=cfg["d"], k=cfg["k"]), rng)
    xs, xs_te = split_features(tr.x, TAB_ORGS), split_features(te.x, TAB_ORGS)
    loss = get_loss("xent")
    res = gal.fit(make_orgs(xs, [Linear(), MLP((64,)), Linear(),
                                 MLP((64,))]),
                  tr.y, loss, gal.GALConfig(rounds=rounds),
                  eval_sets={"test": (xs_te, te.y)}, metrics=("accuracy",),
                  draws=gal.Draws(0), device=dev)
    return res, xs, tr.y, loss


def rel_gap(got, want):
    """max |got - want| over the largest |want|: a quantity's gap as a
    share of its scale."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def hold_card_to_cpu(card, cpu, label):
    gaps = {"etas": rel_gap(card.etas, cpu.etas),
            "weights": rel_gap(np.stack([w.cpu().numpy() for w in card.weights]),
                               np.stack([w.numpy() for w in cpu.weights]))}
    for col, vals in cpu.history.items():
        if col.startswith("comm_") or col == "model_memories":
            check(card.history[col] == vals, f"{label} {col} ledger")
        else:
            gaps[col] = rel_gap(card.history[col], vals)
    print(f"[tabular] (c) {label}, card vs CPU, relative gaps "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
          + f" (tol {TAB_CARD_CPU_RTOL:g})")
    check(card.rounds == cpu.rounds, f"{label} rounds")
    for name, gap in gaps.items():
        check(gap <= TAB_CARD_CPU_RTOL, f"{label} card vs CPU {name} {gap}")


def kernel_profile(fn):
    """{kernel name: (launches, device ms)} of fn() by torch.profiler,
    CUDA activity only."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0}


def tabular_phase(dev):
    """The tabular GAL fit on the card; returns K1's figures at the
    K = 1024 fit's shape, with its launches in that fit."""
    from repro_torch.kernels.ops import residual_xent
    from repro_torch.kernels.ref import residual_xent_ref
    from repro_torch.kernels.residual_xent import residual_xent_cuda

    t_phase = time.perf_counter()
    # (c) the card against the CPU, same data and draws. One round of the
    # quickstart's orgs holds every step of a round; the six rounds run
    # with the MLP org swapped for a Linear one, because the MLP's 200 Adam
    # epochs at lr 1e-2 amplify differences of rounding ~1e4-fold
    # (ROADMAP.md C: the same fit at 1 and 8 CPU threads parts by 5.8%)
    for rounds, mlp_org in ((1, True), (TAB_AUTONOMY["rounds"], False)):
        label = (f"autonomy n={TAB_SMALL_N} {rounds} round(s)"
                 + ("" if mlp_org else ", MLP org -> Linear"))
        t0 = time.perf_counter()
        card = autonomy_fit(TAB_SMALL_N, dev, rounds, mlp_org)[0]
        t1 = time.perf_counter()
        cpu = autonomy_fit(TAB_SMALL_N, "cpu", rounds, mlp_org)[0]
        print(f"[tabular] (c) {label}: card {t1 - t0:.2f} s, CPU "
              f"{time.perf_counter() - t1:.2f} s")
        hold_card_to_cpu(card, cpu, label)

    # (a) the quickstart's model-autonomy fit at n 16384
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res, xs_te, y_te = autonomy_fit(TAB_AUTONOMY["n"], dev,
                                    TAB_AUTONOMY["rounds"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tl = res.history["train_loss"]
    print(f"[tabular] (a) autonomy n={TAB_AUTONOMY['n']} d={TAB_AUTONOMY['d']}"
          f" orgs={TAB_ORGS} [Linear, StumpBoost(40), KernelRidge, "
          f"MLP((32,))] mse: {secs:.3f} s for {res.rounds} rounds = "
          f"{secs / res.rounds:.4f} s/round; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; train "
          f"loss {tl[0]:.5f} -> {tl[-1]:.5f}, test MAD "
          f"{res.history['test_mad'][0]:.5f} -> {res.history['test_mad'][-1]:.5f}"
          f"; etas {[round(e, 4) for e in res.etas]}")
    check(res.rounds == TAB_AUTONOMY["rounds"], "autonomy rounds")
    check(all(math.isfinite(v) for v in tl + res.etas), "autonomy finite")
    check(all(tl[i + 1] <= tl[i] + 1e-6 for i in range(len(tl) - 1)),
          f"autonomy train loss falls monotonically: {tl}")
    replay = float(torch.mean(torch.abs(res.predict(xs_te)
                                        - y_te.to(dev))))
    print(f"[tabular] (a) predict(test) MAD {replay:.6f} vs history "
          f"{res.history['test_mad'][-1]:.6f}")
    check(abs(replay - res.history["test_mad"][-1])
          <= 1e-5 * res.history["test_mad"][-1], "predict replays test MAD")
    del res, xs_te
    torch.cuda.empty_cache()

    # (b) K = 1024: the residual through K1, counted and profiled
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    res, xs, y, loss = k1024_fit(dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    tl = res.history["train_loss"]
    acc = res.history["test_accuracy"]
    print(f"[tabular] (b) k1024 n={TAB_K1024['n']} d={TAB_K1024['d']} "
          f"K={TAB_K1024['k']} orgs [Linear, MLP((64,))] x 2, xent: "
          f"{secs:.3f} s for {res.rounds} rounds = {secs / res.rounds:.4f} "
          f"s/round; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; train "
          f"xent {tl[0]:.5f} -> {tl[-1]:.5f}, test accuracy {acc[0]:.2f} -> "
          f"{acc[-1]:.2f}; etas {[round(e, 4) for e in res.etas]}; launches "
          f"{launches}")
    check(all(math.isfinite(e) for e in res.etas), f"k1024 etas {res.etas}")
    check(tl[-1] < tl[0], f"k1024 train xent falls: {tl}")
    check(launches["residual_xent"] == TAB_K1024["rounds"],
          f"K1 launched {launches['residual_xent']} times in "
          f"{TAB_K1024['rounds']} rounds")

    # outside the counted run: the profiler (kernels only: the host-side
    # op events of a whole fit take minutes to aggregate) over a 2-round
    # fit. The kernels of a plain softmax are learnt from calls of it
    # (they must differ from log_softmax's, which the loss runs); each
    # window runs 50 of them, as a window of one short kernel that follows
    # an earlier profiler session can come back empty
    f = res.predict(xs, rounds=2)
    y = y.to(dev)
    softmax_names = set(kernel_profile(
        lambda: [torch.softmax(f, -1) for _ in range(50)]))
    log_names = set(kernel_profile(
        lambda: [torch.log_softmax(f, -1) for _ in range(50)]))
    print(f"[tabular] (b) plain softmax kernels {sorted(softmax_names)}")
    check(softmax_names and not softmax_names & log_names,
          "softmax and log_softmax kernels are told apart")
    kernels = kernel_profile(lambda: k1024_fit(dev, rounds=PROFILED_ROUNDS))
    k1 = sum(c for k, (c, _) in kernels.items()
             if "residual_xent_kernel" in k)
    k1_ms = sum(t for k, (_, t) in kernels.items()
                if "residual_xent_kernel" in k)
    softmax = sum(c for k, (c, _) in kernels.items() if k in softmax_names)
    busy = sum(t for _, t in kernels.values())
    print(f"[tabular] (b) profiler over a {PROFILED_ROUNDS}-round k1024 fit: "
          f"residual_xent_kernel x{k1} ({k1_ms:.4f} ms), plain softmax "
          f"kernels x{softmax}, {busy:.1f} ms of device time in "
          f"{sum(c for c, _ in kernels.values())} kernels")
    for k, (c, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[tabular]   {t:9.3f} ms x{c:<6d} {k[:90]}")
    check(k1 == PROFILED_ROUNDS, f"the profiler shows K1 {k1} times in "
          f"{PROFILED_ROUNDS} rounds")
    check(softmax == 0, f"the profiled fit ran {softmax} plain softmax "
          f"kernels")
    # one round's K1 output against the closed form
    before = residual_xent_cuda.launches
    r_k1 = loss.residual(y, f)
    torch.cuda.synchronize()
    check(residual_xent_cuda.launches == before + 1, "K1 took the residual")
    err = float((r_k1 - (y - torch.softmax(f, -1))).abs().max())
    print(f"[tabular] (b) round 2's residual: max |K1 - closed form| = "
          f"{err:.3g} (tol {F32_ATOL:g})")
    check(err <= F32_ATOL, f"K1 residual error {err}")
    # K1 timed at the tabular path's shape beside its plain version and
    # one library call (int32 labels: the kernel's own input)
    labels = torch.argmax(y, -1).to(torch.int32)
    t, v = f.shape
    ms = time_ms(lambda: residual_xent(f, labels))
    plain_ms = time_ms(lambda: residual_xent_ref(f, labels))
    y64 = labels.long()
    library_ms = time_ms(
        lambda: torch.nn.functional.one_hot(y64, v).float()
        - torch.softmax(f, dim=-1))
    n_bytes = t * v * (4 + 4) + t * 4     # read logits + labels, write r
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = t * v * 9 / PEAK_F32_FLOP_PER_S * 1e3
    print(f"[tabular] residual_xent ({t}, {v}) f32: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (one_hot - softmax) "
          f"{library_ms:.4f} ms; bound {max(bytes_ms, ops_ms):.4f} ms by "
          f"{'bytes' if bytes_ms >= ops_ms else 'operations'} "
          f"({n_bytes / 1e6:.1f} MB; ops {ops_ms:.4f} ms)")
    print(f"[tabular] phase {time.perf_counter() - t_phase:.1f} s")
    return {"shape": [t, v], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "launches": launches["residual_xent"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions
    torch.backends.cudnn.allow_tf32 = False         # stay in full f32

    build_phase()
    k1 = kernel_phase(dev)
    k2 = flash_phase(dev)
    torch.cuda.empty_cache()
    k1["launches"] = slice_phase(dev)[k1["name"]]
    torch.cuda.empty_cache()
    k2["launches"] = prefill_phase(dev)[k2["name"]]
    torch.cuda.empty_cache()
    k1["tabular"] = tabular_phase(dev)
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
