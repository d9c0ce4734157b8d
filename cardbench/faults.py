"""Faults planted in the timed path, for the checks that ``correct``
must fail: each wraps a method of the program for a while and puts it
back (``probes.Patches``).  The CPU test runs each through a whole run
(``tests/test_cardbench_run.py``); ``calibrate.py --fault`` reads each on
the card at the cell's size.  Not part of a benchmark run."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from cardbench.probes import Patches


def altered_tokens(patch: Patches) -> None:
    """A token altered where it is produced: every third sample is the
    next id after the greedy one."""
    import repro_torch.engine.backend as backend
    n = [0]

    def make(orig):
        def sample(logits, *a, **k):
            n[0] += 1
            tok = int(np.argmax(logits))
            return (tok + 1) % len(logits) if n[0] % 3 == 0 else tok
        return sample
    patch(backend, "sample", make)


def state_unchanged(patch: Patches) -> None:
    """Every step leaves the cache as it found it: the pages its items
    write (those it takes fresh too) are saved before the step and put
    back after it, on the same stream."""
    from repro_torch.engine.runner import InstanceEngine

    def make(orig):
        def dispatch(self, items):
            if not self.paged:
                leaves = [t for c in self.caches for b in c["blocks"]
                          for t in b.values()]
                saved = [t.clone() for t in leaves]
                h = orig(self, items)
                for t, s in zip(leaves, saved):
                    t.copy_(s)
                return h
            pages = set()
            for it in items:
                end = it.pos_offset + len(it.tokens)
                had = self.allocator.pages_of(it.slot)
                pages |= set(had[it.pos_offset // self.page_size:])
                self.allocator.ensure(it.slot, end)
                pages |= set(self.allocator.pages_of(it.slot)[len(had):])
            ids = torch.as_tensor(sorted(pages), dtype=torch.long,
                                  device=self.device)
            leaves = [t for c in self.caches for b in c["blocks"]
                      for t in b.values()]
            saved = [t[:, ids].clone() for t in leaves]
            h = orig(self, items)
            for t, s in zip(leaves, saved):
                t[:, ids] = s
            return h
        return dispatch
    patch(InstanceEngine, "dispatch_batch", make)


def half_the_batch(patch: Patches) -> None:
    """Half of each step's rows left out: the step runs the first half,
    and the rest read what the engine's unfed rows give; their pages are
    taken as the step would take them, and never written."""
    from repro_torch.engine.runner import InstanceEngine

    def make(orig):
        def dispatch(self, items):
            keep = max(1, len(items) // 2)
            for it in list(items)[keep:] if self.paged else ():
                self.allocator.ensure(it.slot,
                                      it.pos_offset + len(it.tokens))
            h = orig(self, list(items)[:keep])
            return None if h is None else dataclasses.replace(h, items=items)
        return dispatch
    patch(InstanceEngine, "dispatch_batch", make)


FAULTS = {f.__name__: f for f in (altered_tokens, state_unchanged,
                                  half_the_batch)}


@contextlib.contextmanager
def planted(name):
    """The fault ``name`` (a key of ``FAULTS``) for the block; None
    plants nothing."""
    patch = Patches()
    if name:
        FAULTS[name](patch)
    try:
        yield
    finally:
        patch.restore()
