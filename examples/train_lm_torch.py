"""Train a ~100M-parameter dense LM for a few hundred steps on the
synthetic token pipeline, with periodic checkpointing, on the PyTorch
port (on the CUDA card unless ``--device cpu``).  On the CPU this is slow
but real; pass --steps 20 for a quick look.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 300
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.data.tokens import token_batches
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.training import train_loop
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.utils.device import resolve_device

CFG_100M = ModelConfig(
    name="lm-100m", arch_type="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=16384,
    mlp="swiglu", norm="rmsnorm", tie_embeddings=True, dtype="float32",
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        os.path.dirname(__file__), "..", "results", "lm_ckpt_torch"))
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = CFG_100M
    n = cfg.param_count()
    print(f"{cfg.name}: {n/1e6:.1f}M params, {args.steps} steps "
          f"@ batch={args.batch} seq={args.seq} on {dev}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    res = train_loop(
        cfg, params, token_batches(cfg, args.batch, args.seq),
        AdamWConfig(lr=6e-4, warmup_steps=max(10, args.steps // 20),
                    total_steps=args.steps),
        steps=args.steps, log_every=max(1, args.steps // 20),
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=max(50, args.steps // 4))
    for h in res["history"]:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"lr {h['lr']:.2e}  {h['elapsed']:.0f}s")
    print("checkpoints in", args.ckpt_dir)


if __name__ == "__main__":
    main()
