"""Mean over the window's arrivals of ``policy.last_overhead``: the host
seconds of DynaServe's split-point search and placement, as the policy
times it, read after each placement."""
from cardbench.record import due_in


def read(run):
    v = [g.place_s for g in due_in(run.logs, run.w0, run.w1)
         if g.place_s is not None]
    return sum(v) / len(v) * 1e3 if v else None
