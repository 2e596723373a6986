#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: its main path, once, on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on any failed check (exit code != 0):

  build   compiles every CUDA kernel of the port from
          src/repro_torch/kernels/csrc/ with nvcc for sm_90a, all at once.
  kernel  holds each kernel against its plain PyTorch version on the card
          at the reference's test shapes and every zoo vocab, then times
          the kernel, the plain version and one library call with CUDA
          events at the shape the main path gives it, beside the bytes
          bound (H100 SXM peak rates).
  slice   one LM-scale GAL fit (repro_torch.core.gal_lm.fit_lm) at the
          published llama3-8b width with depth cut to 2 layers: two orgs,
          batch 4 x seq 512, 2 rounds of 4 local AdamW steps, residuals
          through the residual_xent kernel. Launch counters are zeroed
          just before the fit and read just after it: every kernel of
          the path must have launched. Checks: finite history that falls,
          residual rows summing to 0, predict(rounds=t) replaying the fit.

Prints the card's name and power limit, one JSON line of kernel figures,
and as its last line {"ok": true, "device": {...}}. Exits non-zero without
a CUDA device, and when the port's sources are not beside it.
"""
import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks from NVIDIA's data sheet: HBM3 bytes/s, and f32 flop/s
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

ZOO_VOCABS = (32000, 32064, 49152, 51865, 65536, 100352, 128256, 131072,
              151936)
F32_ATOL, BF16_ATOL, ROW_SUM_ATOL = 2e-5, 5e-3, 1e-4

# the slice: llama3-8b at full width, depth cut 32 -> 2. The local AdamW
# lr is the example's 3e-3 (tuned at the smoke width, d_model 256) cut for
# width: Adam moves every weight by ~lr a step, so a logit moves by
# ~lr * d_model, and at d_model 4096 the example's lr leaves the orgs'
# fitted values all noise (etas ~1e-4, train xent flat to 1e-6).
N_LAYERS, BATCH, SEQ, ROUNDS, LOCAL_STEPS, LR = 2, 4, 512, 2, 4, 1e-4


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


def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all()
    secs = time.perf_counter() - t0
    for name, text in reports.items():
        print(f"[build] {name}: nvcc report\n{text.strip()}")
    print(f"[build] kernels {list(build.KERNELS)} ready in {secs:.1f} s")


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


def slice_phase(dev):
    """One full-width LM-scale GAL fit; returns each kernel's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core import gal_lm
    from repro_torch.core.losses import CrossEntropyLoss
    from repro_torch.data.tokens import make_token_stream, token_batches
    from repro_torch.kernels.residual_xent import residual_xent_cuda
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

    residual_xent_cuda.launches = 0
    t0 = time.perf_counter()
    res = gal_lm.fit_lm(orgs, toks, labels, rounds=ROUNDS,
                        local_steps=LOCAL_STEPS, use_kernel=True,
                        generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"residual_xent": residual_xent_cuda.launches}

    hist = res.history["train_xent"]
    print(f"[slice] fit_lm engine={res.engine}: train_xent {hist}, "
          f"etas {res.etas}, weights "
          f"{[w.tolist() for w in res.weights]}")
    print(f"[slice] {fit_s:.2f} s for {ROUNDS} rounds = "
          f"{fit_s / ROUNDS:.2f} s/round; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          f"residual_xent launches {launches['residual_xent']}")
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

    build_phase()
    k1 = kernel_phase(dev)
    launches = slice_phase(dev)
    k1["launches"] = launches[k1["name"]]
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
