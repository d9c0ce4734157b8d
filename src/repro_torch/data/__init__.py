from repro_torch.data.workloads import (  # noqa: F401
    SHARED_PREFIX_TRACES, SHIFTING_TRACES, WORKLOADS, WorkloadSpec,
    agentic_trace, burst_trace, diurnal_trace, generate_trace, hybrid_trace,
    multiturn_trace, phase_shift_trace, replay_trace, shared_prefix_trace,
    shifting_trace, system_prompt_trace,
)
