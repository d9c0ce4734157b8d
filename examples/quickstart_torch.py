"""Quickstart on the PyTorch port: the whole stack in one minute.

1. Instantiate a reduced Qwen-2.5-style model.
2. Train it for 30 steps on the synthetic pipeline.
3. Serve 4 requests through DynaServe's two-level scheduler on two real
   engine instances, with micro-request splitting + KV handoff.

It runs on the CUDA card unless asked for the CPU:

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.request import INTERACTIVE
from repro_torch.data.tokens import token_batches
from repro_torch.engine.cluster import ServingCluster
from repro_torch.models.model import init_params
from repro_torch.training import train_loop
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.utils.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_smoke_config("qwen2.5-14b")
    print(f"model: {cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model})")

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    res = train_loop(cfg, params, token_batches(cfg, 8, 64),
                     AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30),
                     steps=30, log_every=10)
    print("train:", [f"step {h['step']}: loss {h['loss']:.3f}"
                     for h in res["history"]])
    params = res["params"]

    cluster = ServingCluster(cfg, params, n_instances=2, max_len=160)
    rng = np.random.default_rng(0)
    # streaming API: generate() returns a handle; iterating it pumps the
    # serving event loop and yields tokens as they are sampled
    handles = [cluster.session.generate(
        rng.integers(0, cfg.vocab_size, int(n)), 12, slo=INTERACTIVE)
        for n in (64, 40, 24, 48)]
    for h in handles:
        toks = list(h)
        print(f"  {h.rid}: P={h.req.P} [{h.state}] generated={toks}")
    print(f"KV handoff between instances: {cluster.kv_bytes_moved} bytes")


if __name__ == "__main__":
    main()
