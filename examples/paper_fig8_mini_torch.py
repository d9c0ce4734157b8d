"""Mini reproduction of the paper's Figure 8 comparison on the PyTorch
port's package: goodput of DynaServe vs PD-colocation vs
PD-disaggregation on two A100-modelled instances under the four workload
shapes (calibrated simulator).

The port of ``examples/paper_fig8_mini.py``.  The simulator and the cost
model are the port's verbatim copies, so the table is the same.  The
simulator runs no model: ``--device`` is accepted, as by the port's
other examples, and changes nothing.

  PYTHONPATH=src python examples/paper_fig8_mini_torch.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config
from repro_torch.core.costmodel import A100, BatchCostModel
from repro_torch.data import generate_trace
from repro_torch.sim import (ClusterSim, ColocationPolicy,
                             DisaggregationPolicy, DynaServePolicy,
                             SimConfig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="accepted for a uniform command line; the "
                         "simulator uses no device")
    ap.parse_args(argv)
    cost = BatchCostModel(get_config("qwen2.5-14b"), A100)
    print(f"{'workload':20s} {'qps':>4s} | {'coloc':>8s} {'disagg':>8s} "
          f"{'DynaServe':>9s} | best")
    for w, qps in [("burstgpt", 6), ("azure_code", 2),
                   ("arxiv_summarization", 2), ("mini_reasoning", 3)]:
        reqs = generate_trace(w, qps, 40, seed=1)
        row = {}
        for name, pol in [("coloc", ColocationPolicy(2048)),
                          ("disagg", DisaggregationPolicy()),
                          ("dyna", DynaServePolicy(cost))]:
            sim = ClusterSim(cost, pol, SimConfig(n_instances=2))
            row[name] = sim.run(reqs).goodput
        best = max(row, key=row.get)
        print(f"{w:20s} {qps:4.0f} | {row['coloc']:8.1f} {row['disagg']:8.1f} "
              f"{row['dyna']:9.1f} | {best}")


if __name__ == "__main__":
    main()
