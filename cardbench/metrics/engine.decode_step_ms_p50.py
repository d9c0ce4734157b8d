"""Median over the window's decode steps (T bucket 1), those collected
before the profiler's slice (``spans.steps_in``), of the step's device
time, from the program's step records (``device_s``: CUDA events
on the engine's stream, just before the inputs' copy and after the
logits' clone), in milliseconds."""
from cardbench import spans
from cardbench.record import percentile

spans.install()


def read(run):
    v = percentile([r["device_s"] for r in spans.steps_in(run)
                    if r["T"] == 1], 50)
    return None if v is None else v * 1e3
