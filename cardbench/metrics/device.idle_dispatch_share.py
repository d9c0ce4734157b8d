"""Share of the profiler's slice in which no operation ran on the device
while the innermost open program span was ``engine.dispatch`` or one of
its children (pack, stage, launch, capture), in percent
(``cardbench/spans.py``).  The three idle shares add up to
``device.idle_share``."""
from cardbench import spans

spans.install()


def read(run):
    return spans.idle_share(run, "dispatch")
