"""Synthetic token data pipeline for the training examples/tests.

Generates a deterministic, seedable stream of (tokens, labels) batches.
Sequences follow a Zipfian unigram distribution with injected n-gram
structure so the loss actually decreases during the example training runs
(pure-uniform tokens give a flat loss at log(V))."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


def token_batches(cfg: ModelConfig, batch: int, seq_len: int,
                  seed: int = 0) -> Iterator[Dict]:
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    # Zipf-ish unigram distribution
    ranks = np.arange(1, V + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    # deterministic bigram successor table injects learnable structure
    succ = rng.integers(0, V, size=min(V, 4096))
    n_extra = (cfg.num_patches if cfg.arch_type == "vlm" else 0)
    # seq_len is the TOTAL length (patches + text) as in the assigned input
    # shapes; tiny smoke calls may pass seq_len <= num_patches, in which
    # case treat it as the text length so the loss has live targets.
    text_len = seq_len - n_extra if seq_len > n_extra else seq_len
    while True:
        toks = rng.choice(V, size=(batch, text_len), p=probs).astype(np.int32)
        # 50% of positions follow the bigram table -> learnable signal
        follow = rng.random((batch, text_len)) < 0.5
        for t in range(1, text_len):
            prev = toks[:, t - 1] % len(succ)
            toks[:, t] = np.where(follow[:, t], succ[prev], toks[:, t])
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        out = {"tokens": toks, "labels": labels.astype(np.int32)}
        if cfg.arch_type == "vlm":
            out["extra_embeds"] = rng.standard_normal(
                (batch, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.02
            pad = np.full((batch, n_extra), -100, np.int32)
            out["labels"] = np.concatenate([pad, out["labels"]], axis=1)
        if cfg.arch_type == "audio":
            out["frames"] = rng.standard_normal(
                (batch, cfg.encoder_len, cfg.d_model)).astype(np.float32) * 0.02
        yield out
