"""The whole step's share of the card's bf16 peak: FLOPs that the real
(unpadded) tokens of the steps in the profiler's slice need through the
model, as the kind counts them (``model_flops`` of its
``reference/<kind>.py``: only the routed experts of a mixture), over the
device's busy seconds in that slice times 989e12, in percent."""
from cardbench.yardstick import BF16_FLOPS_PER_S


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    steps = [s for s in run.steps or () if s.traced]
    flops = sum(run.kind.model_flops(run.widths, s.items) for s in steps)
    if not flops:
        return None
    return flops / (run.trace.busy_s * BF16_FLOPS_PER_S) * 100.0
