"""The plain references, one module a kind of architecture, found by the
name that a configuration file gives under ``port.arch_type``:
``reference/<kind>.py``.  A new kind adds its module and edits none.

A kind's module imports nothing of the program and gives what the
benchmark needs of that kind of model:

- ``widths(conf)``: the sizes that the weights, the yardstick and the
  reference read, from the published keys of the file;
- ``port_fields(w)``: the port's ``ModelConfig`` fields that make the
  file what runs, and ``covers(cfg)``, which refuses a port
  configuration whose mathematics the reference does not follow;
- ``layout(w)`` and ``tree(stacks)``: the weights, one seeded draw a
  stacked leaf, and the parameter tree both sides read;
- ``page_bytes(w, page_size)``: a page of the bf16 KV pool, for the pool
  rule;
- ``model_flops(w, items)``: the FLOPs a step's real rows need;
- ``logits_at`` and ``kv_at``: the float32 reference itself.
"""
from __future__ import annotations

import importlib


def of(conf: dict):
    """The module of the configuration's kind."""
    kind = conf["port"]["arch_type"]
    try:
        return importlib.import_module(f"cardbench.reference.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"cardbench.reference.{kind}":
            raise
        raise SystemExit(f"no reference for the architecture kind {kind!r}: "
                         f"add cardbench/reference/{kind}.py") from None
