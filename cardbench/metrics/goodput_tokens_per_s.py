"""Tokens emitted in the window within their request's SLO class (a
first token within the class's TTFT limit, a later one within its TBT
limit of the token before), over the window's seconds."""
from cardbench.record import tokens_in


def read(run):
    _, good = tokens_in(run.logs, run.w0, run.w1)
    return good / run.seconds
