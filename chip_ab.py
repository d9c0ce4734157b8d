#!/usr/bin/env python3
"""Time the attention kernels of one checkout at a few fixed rows, so that
two checkouts can be compared in turns on one card:

    python3 chip_ab.py --root .                 # this checkout
    python3 chip_ab.py --root build/parent      # another, e.g. the parent
    for r in build/parent . . build/parent; do python3 chip_ab.py --root $r; done

Each run imports ``chip_smoke.py`` and ``src/`` of ``--root`` (builds its
kernels there), calls that checkout's ``time_kernels`` at the rows below
and prints one JSON line: per row, the decode and prefill kernels' device
time (torch.profiler) and event time, the prefill body, and the card's
name and power limit.  The rows come from the ``chip_smoke.py`` beside
this script: Qwen2.5-14B's heads (hd 128, bf16; the wgmma row), the
phi4-mini smoke layout (hd 40, f32), Nemotron-4-340B's heads (hd 192,
bf16; wgmma) and Phi-4-mini's heads at hd 64 over fp8 and int8 pools,
whose prefill times ``time_kernels`` logs as ``[time] ... fp8 pool``
lines.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def rows(here, get_config) -> dict:
    """label -> ``time_kernels`` keywords, from ``here``'s layouts."""
    nem = get_config(here.NEMOTRON_PATH)
    return {
        "qwen2.5-14b": dict(here.TIMED_PATHS["qwen2.5-14b"], quant=False),
        here.PHI4_SMOKE_PATH: here.TIMED_PATHS[here.PHI4_SMOKE_PATH],
        here.NEMOTRON_PATH: dict(H=nem.n_heads, KV=nem.n_kv_heads,
                                 hd=nem.hd, quant=False),
        f"{here.TRAIN_PATH} at hd 64 codes":
            dict(here.TIMED_PATHS[here.TRAIN_PATH], hd=64),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="the checkout to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    here, smoke = (load_smoke(d / "chip_smoke.py", f"chip_smoke_{i}")
                   for i, d in enumerate((HERE, root)))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {_build.__file__}, not {root}'s")
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for label, kw in rows(here, get_config).items():
        res = smoke.time_kernels(args.seed, label, **kw)
        out[label] = {name: {k: r[k] for k in ("device_ms", "timed_by", "ms",
                                                "body") if k in r}
                      for name, r in res.items()}
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(args.root), "card": smoke.nvidia_smi_line(),
                      "rows": out}), flush=True)
    return 0


def load_smoke(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


if __name__ == "__main__":
    sys.exit(main())
