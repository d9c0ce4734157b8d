"""Seconds the engines spent capturing CUDA graphs in set-up (their
``capture_seconds``, summed over the instances)."""


def read(run):
    return run.capture_s
