"""Flat-npz checkpointing with path-keyed leaves.

The port of ``repro.training.checkpoint``: one ``ckpt_{step:08d}.npz`` a
step with ``__step__``, ``p<path>`` (params) and ``o<path>`` (optimizer
state) keys, written to a ``.tmp`` file and moved into place.  numpy has
no bfloat16 (and the port does not use ``ml_dtypes``), so a leaf numpy
cannot hold is stored as its raw bits in a same-width integer array, and
every leaf's torch dtype is recorded under ``__dtypes__``; loading
restores those leaves bit for bit.  Leaves are copied to the host and
written one at a time, so a model's state never sits in host memory
whole; loading reads them one at a time onto the templates' devices.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_items, tree_unflatten

# torch dtypes numpy has no type for -> the integer type of their bits
_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
         torch.float8_e5m2: torch.uint8}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.cpu().numpy()


def _leaves(params, opt_state):
    yield from ((f"p{k}", v) for k, v in tree_items(params))
    yield from ((f"o{k}", v) for k, v in tree_items(opt_state))


def save_checkpoint(directory: str, params, opt_state, step: int) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp"
    dtypes = {}
    # what np.savez writes (a stored zip of .npy members), a leaf at a time
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, leaf in _leaves(params, opt_state):
            leaf = torch.as_tensor(leaf)
            dtypes[key] = _dtype_name(leaf.dtype)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _to_numpy(leaf),
                                          allow_pickle=False)
        for key, arr in (("__step__", np.asarray(step)),
                         ("__dtypes__", np.asarray(json.dumps(dtypes)))):
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str):
    if not os.path.isdir(directory):
        return None
    cands = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    return os.path.join(directory, cands[-1]) if cands else None


def load_checkpoint(path: str, params_template, opt_template) -> Tuple:
    """Restore into the structure, shapes, dtypes and devices of the given
    templates; a leaf of another shape or dtype raises ValueError."""
    with np.load(path, allow_pickle=False) as blob:
        step = int(blob["__step__"])
        dtypes = json.loads(str(blob["__dtypes__"]))

        def restore(prefix, template):
            out = []
            for key_t, leaf in tree_items(template):
                key = prefix + key_t
                arr = blob[key]
                if arr.shape != tuple(leaf.shape) or \
                        dtypes[key] != _dtype_name(leaf.dtype):
                    raise ValueError(
                        f"{path}: {key} is {dtypes[key]} {arr.shape}, the "
                        f"template {leaf.dtype} {tuple(leaf.shape)}")
                t = torch.from_numpy(arr)
                if leaf.dtype in _BITS:
                    t = t.view(leaf.dtype)
                out.append(t.to(leaf.device))
            return tree_unflatten(template, out)

        return restore("p", params_template), restore("o", opt_template), step
