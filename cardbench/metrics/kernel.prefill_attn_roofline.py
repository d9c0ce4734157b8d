"""The chunked-prefill kernel's share of its roofline in the profiler's
slice: the sum over its calls (one a layer of every step with T > 1,
decode rows of mixed steps included) of max(bytes / 3.35e12, FLOPs /
989e12) for the causal attention of the step's real rows over their own
contexts, over the device time of the kernels named
``chunked_prefill``, in percent."""
from cardbench.yardstick import bound_s, prefill_attention_call


def read(run):
    if run.trace is None:
        return None
    dev = run.trace.device_s("chunked_prefill")
    if not dev:
        return None
    w = run.widths
    bound = 0.0
    for s in run.steps or ():
        if s.traced and s.T > 1:
            items = [(t, p) for t, p, _ in s.items]
            bound += w["n_layers"] * bound_s(*prefill_attention_call(
                items, w["n_heads"], w["n_kv_heads"], w["head_dim"]))
    return bound / dev * 100.0 if bound else None
