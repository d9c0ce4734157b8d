"""Share of the profiler's slice in which no operation ran on the
device, in percent."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
