"""Process start to window start: the kernels loaded (built, in a
checkout's first run), the weights drawn, the pools sized, every graph
key captured and the pre-roll served."""


def read(run):
    return run.setup_s
