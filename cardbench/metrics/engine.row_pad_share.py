"""Share of the rows that the window's engine steps computed that were
padding, from the program's step records: 1 - (tokens of the steps) /
(rows the steps computed, each record's ``N``), over the steps collected
before the profiler's slice (``spans.steps_in``), in percent.  A paged
engine packs a step's tokens into rows rounded up to a rung of its row
ladder, so ``N`` is what it computed; a program whose records carry no
``N`` gives nothing."""
from cardbench import spans

spans.install()


def read(run):
    steps = [r for r in spans.steps_in(run) if "N" in r]
    rows = sum(r["N"] for r in steps)
    if not rows:
        return None
    return (1.0 - sum(r["rows"] for r in steps) / rows) * 100.0
