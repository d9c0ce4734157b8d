"""Online serving on the PyTorch port's engines through the
``ServeSession`` API: streaming token delivery, SLO classes, mid-flight
cancellation — with a correctness check that scheduling never changes
generations (the same batch served in colocation mode is token-identical).

The port of ``examples/serve_cluster.py``: the session is built from its
parts (``EngineBackend`` + policy) on the CUDA card unless asked for the
CPU:

  PYTHONPATH=src python examples/serve_cluster_torch.py [--arch mamba2-780m]
  PYTHONPATH=src python examples/serve_cluster_torch.py --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.request import BATCH, INTERACTIVE, RequestState
from repro_torch.core.session import ServeSession, SessionConfig
from repro_torch.engine.backend import EngineBackend
from repro_torch.models.model import init_params
from repro_torch.sim.policies import ColocationPolicy, DynaServePolicy
from repro_torch.utils.device import resolve_device


def make_session(cfg, params, n_slots, split: bool):
    backend = EngineBackend(cfg, params, n_slots=n_slots, max_len=192)
    policy = (DynaServePolicy(backend.cost, 0.100) if split
              else ColocationPolicy(chunk=64, slo_aware=False))
    session = ServeSession(backend, policy, SessionConfig(n_instances=2))
    return session, backend


def main(argv=None, params=None):
    """Returns the DynaServe run's token streams, in request order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    rng = np.random.default_rng(42)

    # skewed mix: long-prompt/short-output + short-prompt/long-output
    specs = []
    for i in range(args.requests):
        if i % 2 == 0:
            specs.append((int(rng.integers(48, 96)), 6))    # prefill-heavy
        else:
            specs.append((int(rng.integers(8, 20)), 24))    # decode-heavy
    prompts = [np.random.default_rng(7 + i).integers(0, cfg.vocab_size, p)
               for i, (p, _) in enumerate(specs)]

    def serve(split):
        session, backend = make_session(cfg, params, 2 * args.requests,
                                        split)
        t0 = time.time()
        handles = [session.generate(
            prompts[i], d, rid=f"req{i}",
            slo=INTERACTIVE if i % 2 else BATCH)
            for i, (_, d) in enumerate(specs)]
        outs = [list(h) for h in handles]       # stream every request
        return handles, outs, time.time() - t0, backend

    hs_dyn, outs_dyn, dt_dyn, be = serve(split=True)
    hs_col, outs_col, dt_col, _ = serve(split=False)

    toks = sum(len(t) for t in outs_dyn)
    print(f"arch={cfg.name} requests={len(hs_dyn)} output_tokens={toks}")
    print(f"DynaServe (2 unified instances): {dt_dyn:.2f}s wall "
          f"({toks/dt_dyn:.1f} tok/s {dev.type.upper()}), KV handoff "
          f"{be.kv_bytes_moved/1024:.1f} KiB")
    print(f"Colocation  (no splitting):      {dt_col:.2f}s wall")
    same = all(a == b for a, b in zip(outs_dyn, outs_col))
    print("generations identical across scheduling modes:", same)
    assert same
    for h, toks_h in list(zip(hs_dyn, outs_dyn))[:4]:
        print(f"  {h.rid}: P={h.req.P} slo={h.req.slo.name} "
              f"-> {toks_h[:6]}...")

    # mid-flight cancellation frees slots and aborts pending handoffs
    session, _ = make_session(cfg, params, 8, split=True)
    h = session.generate(prompts[0], 24, rid="cancelme")
    for i, _tok in enumerate(h):
        if i == 2:
            h.cancel()
    print(f"cancelled after {len(h.tokens)} tokens: state={h.state}")
    assert h.state == RequestState.CANCELLED
    return outs_dyn


if __name__ == "__main__":
    main()
