"""End-to-end run: GAL over LM organizations on a token task.

The port's twin of ``examples/train_lm_gal.py``. Two orgs hold vertically
split token views (vocab factorization: org 0 sees the high bits, org 1
the low bits); Alice holds next-token labels. Per assistance round each
org runs ``--local-steps`` AdamW steps of its sequence model on the
broadcast pseudo-residual, then Alice fits assistance weights and
line-searches eta. The residual goes through the ``residual_xent`` CUDA
kernel on the card.

Run: PYTHONPATH=src python -m repro_torch.launch.train_lm_gal \
         [--preset smoke|100m] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import math
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import gal_lm
from repro_torch.data.tokens import make_token_stream, token_batches
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_size


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("smoke", "100m"), default="smoke")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = get_arch("llama3-8b", smoke=True)
    if args.preset == "100m":
        cfg = replace(base, n_layers=12, d_model=768, n_heads=12,
                      n_kv_heads=4, d_ff=2048, vocab=8192)
        local_steps = args.local_steps or 200
        batch, seq = args.batch or 16, args.seq or 256
    else:
        cfg = replace(base, vocab=1024)
        local_steps = args.local_steps or 10
        batch, seq = args.batch or 4, args.seq or 64

    rng_np = np.random.default_rng(0)
    stream = make_token_stream(rng_np, cfg.vocab, 200_000)
    toks, labels = next(token_batches(stream, batch, seq, rng_np))
    toks = torch.from_numpy(toks).to(device)
    labels = torch.from_numpy(labels).to(device)

    root = int(math.isqrt(cfg.vocab))
    orgs = [
        gal_lm.LMOrganization(0, cfg, lambda t: (t // root) % cfg.vocab),
        gal_lm.LMOrganization(1, cfg, lambda t: (t % root) % cfg.vocab),
    ]
    for i, org in enumerate(orgs):
        gen = torch.Generator(device=device).manual_seed(i)
        org.init(gen, lr=3e-3, device=device)
        print(f"org {org.index}: arch={org.cfg.arch} "
              f"params={tree_size(org.params):,}")
    print(f"batch={batch} seq={seq} rounds={args.rounds} "
          f"local_steps={local_steps} device={device}")

    res = gal_lm.fit_lm(orgs, toks, labels, rounds=args.rounds,
                        local_steps=local_steps,
                        generator=torch.Generator(device=device).manual_seed(
                            len(orgs)))
    print(f"engine={res.engine} plan: {res.plan.describe()}")
    for t, xent in enumerate(res.history["train_xent"]):
        eta = f" eta={res.etas[t-1]:.2f}" if t else ""
        print(f" round {t}: train xent={xent:.4f}{eta}")
    drop = res.history["train_xent"][0] - res.history["train_xent"][-1]
    print(f"xent improvement over {args.rounds} assistance rounds: {drop:.4f}")
    if not drop > 0:
        raise SystemExit("GAL rounds must decrease the overarching loss")


if __name__ == "__main__":
    main()
