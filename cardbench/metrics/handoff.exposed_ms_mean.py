"""Growth of the session's ``transfer_exposed`` (host seconds of KV
handoff while the destination had no batch in flight) over the window,
over the handoffs that began in it."""


def read(run):
    a, b = run.mark("transfer_exposed", 0), run.mark("transfer_exposed", 1)
    n = sum(run.w0 <= t < run.w1 for g in run.logs.values()
            for t in g.handoffs)
    if a is None or b is None or n == 0:
        return None
    return (b - a) / n * 1e3
