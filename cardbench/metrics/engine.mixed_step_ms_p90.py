"""90th percentile over the window's steps with a T bucket above 1
(prefill chunks, alone or with decode rows), those collected before the
profiler's slice (``spans.steps_in``), of the step's device time,
from the program's step records (``device_s``), in milliseconds."""
from cardbench import spans
from cardbench.record import percentile

spans.install()


def read(run):
    v = percentile([r["device_s"] for r in spans.steps_in(run)
                    if r["T"] > 1], 90)
    return None if v is None else v * 1e3
