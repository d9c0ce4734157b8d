"""90th percentile over every request due in the window of its first
token's time minus its due time; one with no first token by the close
counts with what it has waited so far."""
from cardbench.record import percentile, ttfts


def read(run):
    v = percentile(ttfts(run.logs, run.w0, run.w1), 90)
    return None if v is None else v * 1e3
