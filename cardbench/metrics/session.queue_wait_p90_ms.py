"""90th percentile over the requests due in the window of due time to
the first RUNNING_* edge of the request's first micro-request (the
close, for one not running by then), from the harness's observer."""
from cardbench.record import percentile, queue_waits


def read(run):
    v = percentile(queue_waits(run.logs, run.w0, run.w1), 90)
    return None if v is None else v * 1e3
