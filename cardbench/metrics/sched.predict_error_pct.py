"""Median over the window's steps collected before the profiler's slice
(``spans.steps_in``) of how far the local scheduler's
prediction (the plan's ``predicted_latency``: the cost model's price of
the real, unpadded tokens) lies from the step's device time,
|predicted - device| / device, from the program's step records, in
percent."""
from cardbench import spans
from cardbench.record import percentile

spans.install()


def read(run):
    v = [abs(r["predicted_s"] - r["device_s"]) / r["device_s"] * 100.0
         for r in spans.steps_in(run)
         if r["predicted_s"] is not None and r["device_s"] > 0]
    return percentile(v, 50)
