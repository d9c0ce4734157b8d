"""The port's four examples (``examples/*_torch.py``), each run in this
process with ``--device cpu``, against their JAX counterparts where the
two can be compared.

* ``paper_fig8_mini_torch.py`` prints the table ``paper_fig8_mini.py``
  prints (the simulator and cost model are verbatim copies);
* ``multiturn_chat_torch.py`` gives the per-turn reused-prefix counts and
  greedy replies of ``multiturn_chat.py`` on the same weights (the JAX
  example's, carried across with ``params_from_jax``);
* ``serve_cluster_torch.py`` passes its own check that colocation and
  DynaServe generate the same tokens, and cancels a request mid-flight;
* ``serve_http_torch.py`` gets its completions back from the port's
  engine backend and shuts the server down cleanly.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fig8_mini_torch_prints_the_reference_table(capsys):
    load("paper_fig8_mini").main()
    want = capsys.readouterr().out
    load("paper_fig8_mini_torch").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 5


def test_multiturn_chat_torch_matches_the_jax_example(capsys):
    jmod = load("multiturn_chat")
    weights, replies = [], []
    init = jmod.init_params

    def keep_params(*a, **k):
        weights.append(init(*a, **k))
        return weights[-1]

    class Recorded(jmod.ServeSession):
        def generate(self, *a, **k):
            h = super().generate(*a, **k)
            result = h.result

            def recorded():
                out = result()
                replies.append(list(out))
                return out
            h.result = recorded
            return h

    jmod.init_params, jmod.ServeSession = keep_params, Recorded
    jmod.main()
    want = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("turn ")]
    cfg = get_smoke_config("qwen2.5-14b")
    params = params_from_jax(jax.tree.map(np.asarray, weights[0]), cfg,
                             device="cpu")
    turns = load("multiturn_chat_torch").main(["--device", "cpu"],
                                              params=params)
    got = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("turn ")]
    assert got == want
    assert [t["reply"] for t in turns] == replies
    saved = [t["saved"] for t in turns]
    assert saved[0] == 0 and all(b > a for a, b in zip(saved, saved[1:]))


def test_serve_cluster_torch_colocation_equals_dynaserve(capsys):
    outs = load("serve_cluster_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "generations identical across scheduling modes: True" in out
    assert "state=cancelled" in out
    assert [len(o) for o in outs] == [6, 24] * 4


def test_serve_http_torch_engine_on_cpu(capsys):
    load("serve_http_torch").main(["--backend", "engine", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "unary completion:" in out
    assert "dynaserve_requests_total" in out
    assert out.rstrip().endswith("clean shutdown")
