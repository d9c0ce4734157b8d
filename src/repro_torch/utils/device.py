"""Device and dtype resolution shared by the port's entry points."""
from __future__ import annotations

import os
from typing import List, Optional, Union

import torch

#: Environment setting that repeats the visible devices up to a count, so
#: that a sharded instance's shards can time-share one device: the
#: counterpart of ``--xla_force_host_platform_device_count``.  Read at
#: call time; unset (or not above the device count) it changes nothing.
DEVICE_COUNT_ENV = "REPRO_TORCH_DEVICE_COUNT"


def as_device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device without an index given
    the current one's (so that it compares equal to a tensor's)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices(kind: str = "cuda") -> List[torch.device]:
    """The devices of ``kind`` an engine may shard over, the counterpart
    of ``jax.devices()``: every CUDA device, or the one CPU; repeated
    round-robin up to ``$REPRO_TORCH_DEVICE_COUNT`` when that is larger."""
    if kind == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise ValueError(f"unknown device kind {kind!r}")
    want = int(os.environ.get(DEVICE_COUNT_ENV) or 0)
    if devs and want > len(devs):
        devs = [devs[i % len(devs)] for i in range(want)]
    return devs


def resolve_device(device: Optional[Union[str, torch.device]] = None) \
        -> torch.device:
    """The device an entry point places its tensors on: CUDA unless the
    caller asks for something else.  A missing card raises instead of
    falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def torch_dtype(name) -> torch.dtype:
    """``ModelConfig.dtype`` string ("bfloat16", "float32", ...) -> torch dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt
