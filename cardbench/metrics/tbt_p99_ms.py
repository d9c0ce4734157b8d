"""99th percentile of every gap between consecutive tokens of a request
whose later token falls in the window, each still-streaming request's
open gap at the close included."""
from cardbench.record import gaps, percentile


def read(run):
    v = percentile(gaps(run.logs, run.w0, run.w1), 99)
    return None if v is None else v * 1e3
