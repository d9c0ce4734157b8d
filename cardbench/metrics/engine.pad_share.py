"""Share of the rows that the window's engine steps computed that were
padding: 1 - (tokens of the step's items) / (n_slots x the step's T
bucket, from the engine's own ``buckets``), over every step dispatched
in the window, in percent."""


def read(run):
    steps = [s for s in run.steps or () if run.w0 <= s.t < run.w1]
    rows = sum(s.n_slots * s.T for s in steps)
    if not rows:
        return None
    real = sum(t for s in steps for t, _, _ in s.items)
    return (1.0 - real / rows) * 100.0
