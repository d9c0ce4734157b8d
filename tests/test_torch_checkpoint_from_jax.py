"""A checkpoint the JAX package wrote, read by the port.

The reference trains its smoke Qwen2.5-14B config two steps (jitted
``make_train_step``) and saves params and AdamW state with its own
``save_checkpoint`` (``keystr``-keyed stacked leaves, bf16 leaves as
``ml_dtypes`` arrays).  ``repro_torch.convert.checkpoint_from_jax`` reads
the file without ``ml_dtypes`` and must give, bit for bit, what
``params_from_jax`` / ``opt_state_from_jax`` give from the same state in
memory, for a bf16 and an f32 config.  The f32 weights then serve one
request through ``ServeSession(EngineBackend)`` on the CPU in both
packages, with the same greedy tokens.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.session import ServeSession as JSession  # noqa: E402
from repro.core.session import SessionConfig as JSessionConfig  # noqa: E402
from repro.data.tokens import token_batches  # noqa: E402
from repro.engine.backend import EngineBackend as JBackend  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.sim.policies import ColocationPolicy as JColocation  # noqa: E402
from repro.training.checkpoint import save_checkpoint  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamW  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro.training.train import make_train_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    checkpoint_from_jax, opt_state_from_jax, params_from_jax)
from repro_torch.core.session import ServeSession, SessionConfig  # noqa: E402
from repro_torch.engine.backend import EngineBackend  # noqa: E402
from repro_torch.sim.policies import ColocationPolicy  # noqa: E402
from repro_torch.utils.tree import tree_items  # noqa: E402

ARCH = "qwen2.5-14b"


@functools.lru_cache(maxsize=None)
def _trained(dtype):
    """The reference's smoke state after two train steps (built once a
    dtype: each build compiles the reference's train step)."""
    cfg = jconfigs.get_smoke_config(ARCH).with_(dtype=dtype)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    opt_cfg = JAdamW(lr=1e-3, warmup_steps=1)
    opt = jadamw_init(params, opt_cfg)
    step = jax.jit(make_train_step(cfg, opt_cfg))
    batches = token_batches(cfg, 4, 32)
    for _ in range(2):
        params, opt, _ = step(params, opt, next(batches))
    return cfg, params, opt


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_checkpoint_reads_bit_equal(dtype, tmp_path):
    jcfg, jp, jo = _trained(dtype)
    path = save_checkpoint(str(tmp_path), jp, jo, 2)
    cfg = get_smoke_config(ARCH).with_(dtype=dtype)
    params, opt, step = checkpoint_from_jax(path, cfg, device="cpu")
    assert step == 2
    want_p = dict(tree_items(params_from_jax(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")))
    want_o = dict(tree_items(opt_state_from_jax(
        jax.tree.map(np.asarray, jo), cfg, device="cpu")))
    for got, want in ((params, want_p), (opt, want_o)):
        got = dict(tree_items(got))
        assert set(got) == set(want)
        for key, t in got.items():
            assert t.dtype == want[key].dtype, key
            assert torch.equal(_bits(t), _bits(want[key])), key
    assert params["embed"].dtype == getattr(torch, dtype)
    assert int(opt["step"]) == 2


def test_checkpoint_dtype_mismatch_raises(tmp_path):
    """A bf16 file read against an f32 config fails instead of guessing."""
    _, jp, jo = _trained("bfloat16")
    path = save_checkpoint(str(tmp_path), jp, jo, 2)
    with pytest.raises(ValueError):
        checkpoint_from_jax(path, get_smoke_config(ARCH), device="cpu")


def test_read_weights_serve_the_reference_greedy_tokens(tmp_path):
    jcfg, jp, jo = _trained("float32")
    path = save_checkpoint(str(tmp_path), jp, jo, 2)
    cfg = get_smoke_config(ARCH)
    params, _, _ = checkpoint_from_jax(path, cfg, device="cpu")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 40)

    def serve(session_cls, cfg_cls, backend_cls, policy_cls, c, p):
        backend = backend_cls(c, p, n_slots=2, max_len=96)
        session = session_cls(backend, policy_cls(chunk=64),
                              cfg_cls(n_instances=1))
        return list(session.generate(prompt, 12, rid="r0").result())

    want = serve(JSession, JSessionConfig, JBackend, JColocation, jcfg, jp)
    got = serve(ServeSession, SessionConfig, EngineBackend, ColocationPolicy,
                cfg, params)
    assert len(want) == 12
    assert got == want
