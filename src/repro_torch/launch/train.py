"""Training launcher.

The port of ``repro.launch.train``: the same flags and output (one JSON
line a history record, then ``loss a -> b``), plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path, and without a card nothing
else does).  Reduced configs (``--smoke``) train in seconds; a full
config trains whole on the device, which must hold its params, grads and
moments.

  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
      --smoke --steps 100 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import token_batches
from repro_torch.models.model import init_params
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train import train_loop
from repro_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                      total_steps=args.steps)
    res = train_loop(cfg, params, token_batches(cfg, args.batch, args.seq),
                     opt, steps=args.steps,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every)
    for h in res["history"]:
        print(json.dumps(h))
    first, last = res["history"][0]["loss"], res["history"][-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
