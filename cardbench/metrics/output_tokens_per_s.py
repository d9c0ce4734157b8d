"""Every token emitted in the window, over the window's seconds."""
from cardbench.record import tokens_in


def read(run):
    n, _ = tokens_in(run.logs, run.w0, run.w1)
    return n / run.seconds
