"""The port's training loss and its gradients against the JAX package's,
for every smoke config.

Both packages take the same numpy batch (``token_batches(cfg, 2, 16)``,
from a seed) and the same weights: the JAX ``init_params`` tree with
random biases and norm scales (``init_params`` leaves them at 0 / 1),
converted with ``repro_torch.convert.params_from_jax``; the JAX
gradients convert the same way.  Smoke configs in f32.  Tolerances: the
loss to 1e-5 relative; every gradient leaf within 1e-4 of that leaf's
largest magnitude, and no leaf without a gradient.  Half the configs run
the port with ``remat`` on, against the reference with it off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.tokens import token_batches  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.utils.tree import tree_items  # noqa: E402


GRAD_RTOL = 1e-4
ARCHS = ["qwen2.5-14b", "qwen2.5-32b", "qwen2.5-72b", "qwen1.5-32b",
         "phi4-mini-3.8b", "chatglm3-6b", "nemotron-4-340b",
         "qwen3-moe-30b-a3b", "grok-1-314b", "mamba2-780m",
         "recurrentgemma-9b", "whisper-large-v3", "internvl2-76b"]
BIASES = ("bq", "bk", "bv", "bias", "conv_b", "b_a", "b_x")
SCALES = ("scale", "q_norm", "k_norm", "norm", "D")


def randomize(tree, rng):
    """Random biases (std 0.5) and norm scales (1 +- 0.3), in place."""
    if isinstance(tree, (list, tuple)):
        for t in tree:
            randomize(t, rng)
        return tree
    for key, val in tree.items():
        if isinstance(val, (dict, list, tuple)):
            randomize(val, rng)
        elif key in BIASES:
            tree[key] = (0.5 * rng.standard_normal(val.shape)).astype(val.dtype)
        elif key in SCALES:
            tree[key] = (1 + 0.3 * rng.standard_normal(val.shape)).astype(
                val.dtype)
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    np_params = randomize(jax.tree.map(
        np.asarray, jmodel.init_params(jcfg, jax.random.PRNGKey(0))),
        np.random.default_rng(0))
    batch = next(token_batches(jcfg, 2, 16, seed=1))

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))(
        jax.tree.map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    exp_grads = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                device="cpu")

    params = params_from_jax(np_params, cfg, device="cpu")
    for p in (leaf for _, leaf in tree_items(params)):
        p.requires_grad_()
    remat = ARCHS.index(arch) % 2 == 1
    loss, aux = tmodel.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                             for k, v in batch.items()},
                               remat=remat)
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["nll"].item(), float(jaux["nll"]),
                               rtol=1e-5)
    np.testing.assert_allclose(aux["aux"].item(), float(jaux["aux"]),
                               rtol=1e-5, atol=1e-7)
    got = dict(tree_items(params))
    exp = dict(tree_items(exp_grads))
    assert got.keys() == exp.keys()
    bad = []
    for key, e in exp.items():
        g = got[key].grad
        assert g is not None, f"{key}: no gradient"
        err = float((g - e).abs().max())
        bound = GRAD_RTOL * float(e.abs().max())
        if err > bound:
            bad.append(f"{key}: {err:.3e} > {bound:.3e}")
    assert not bad, bad
