"""The port's training substrate against the JAX package: the schedule,
AdamW, the train step (microbatches and remat), the loop, checkpoints,
the train launcher and the torch quickstart.

Both packages take the same numpy inputs, made from seeds: batches from
``token_batches``, weights from the JAX ``init_params`` converted with
``repro_torch.convert.params_from_jax``, optimizer state with
``opt_state_from_jax``.  Smoke configs in f32 on the CPU.  Tolerances,
each stated where it is used: the schedule to one f32 ulp; a train step's
loss, lr and grad norm to 1e-5 relative, its moments to 1e-4 of each
leaf's largest magnitude, and its params to 3e-3 absolute, the
reference's own microbatch bound (``tests/test_training.py``): Adam's
first step turns tiny gradient differences near ``eps`` into updates of
up to ``lr``.
"""
import importlib.util
import io
import json
import os
import re
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)   # the test workers share the machine's cores
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.tokens import token_batches  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train as jtrain  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train as ttrain  # noqa: E402
from repro_torch.training.checkpoint import (  # noqa: E402
    latest_checkpoint, load_checkpoint, save_checkpoint,
)
from repro_torch.utils.tree import tree_items, tree_map  # noqa: E402


ROOT = Path(__file__).resolve().parents[1]
SCALAR_RTOL = 1e-5
MOMENT_RTOL = 1e-4
PARAM_ATOL = 3e-3
BF16_ULP = 2.0 ** -7            # a bf16 ulp, relative to the largest value


def setup(arch, seed=0, batch=4, seq=32, **overrides):
    """(jax cfg, port cfg, numpy params, numpy batch) for one smoke config."""
    jcfg = jconfigs.get_smoke_config(arch).with_(**overrides)
    cfg = get_smoke_config(arch).with_(**overrides)
    np_params = jax.tree.map(np.asarray, jmodel.init_params(
        jcfg, jax.random.PRNGKey(seed)))
    return jcfg, cfg, np_params, next(token_batches(jcfg, batch, seq,
                                                    seed=seed + 1))


def port(np_tree, cfg):
    return params_from_jax(np_tree, cfg, device="cpu")


def scaled_close(got, exp, rtol, what):
    """Every leaf of two port trees within ``rtol`` of the expected leaf's
    largest magnitude."""
    exp = dict(tree_items(exp))
    bad = []
    for key, g in tree_items(got):
        e = exp[key].float()
        err = float((g.float() - e).abs().max())
        if err > rtol * float(e.abs().max()):
            bad.append(f"{what}{key}: {err:.3e}")
    assert not bad, bad


def abs_close(got, exp, atol, what):
    exp = dict(tree_items(exp))
    worst = max((float((g.float() - exp[k].float()).abs().max()), k)
                for k, g in tree_items(got))
    assert worst[0] <= atol, f"{what}{worst[1]}: {worst[0]:.3e} > {atol}"


@pytest.mark.parametrize("step", [0, 3, 50, 99, 100, 2000, 5050, 9999,
                                  10_000, 12_000])
def test_cosine_lr_matches_reference(step):
    """Warm-up, the cosine middle and past the end, to one f32 ulp."""
    cfg = topt.AdamWConfig()
    got = topt.cosine_lr(cfg, step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jopt.cosine_lr(jopt.AdamWConfig(),
                                               jnp.int32(step))), rtol=1.2e-7)


@pytest.mark.parametrize("moments,param_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("float32", "bfloat16")])
def test_adamw_update_matches_reference(moments, param_dtype):
    """One update from identical grads, moments and params (the smoke
    Qwen2.5 tree, moments from a first update so that both are non-zero),
    with a clip that binds.  lr and grad norm to 1e-5 relative; f32
    moments to 1e-4 of each leaf's scale, bf16 moments to one bf16 ulp at
    that scale (2**-7 of it: f32 values an ulp apart may round to
    neighbouring bf16 values); params to 1e-5 absolute (f32) or one bf16
    ulp at the leaf's scale (bf16), the update being a smooth function of
    the same f32 inputs here."""
    jcfg, cfg, np_params, _ = setup("qwen2.5-14b", dtype=param_dtype)
    rng = np.random.default_rng(3)
    opt_kw = dict(lr=1e-2, warmup_steps=2, grad_clip=0.5,
                  moment_dtype=moments)
    jcfg_o, cfg_o = jopt.AdamWConfig(**opt_kw), topt.AdamWConfig(**opt_kw)
    np_grads = [jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.1).astype(p.dtype),
        np_params) for _ in range(2)]
    jp = jax.tree.map(jnp.asarray, np_params)
    jo = jopt.adamw_init(jp, jcfg_o)
    jp, jo, _ = jopt.adamw_update(np_grads[0], jo, jp, jcfg_o)
    np_p, np_o = jax.tree.map(np.asarray, (jp, jo))
    jp, jo, jm = jopt.adamw_update(np_grads[1], jo, jp, jcfg_o)

    tp, to = port(np_p, cfg), opt_state_from_jax(np_o, cfg, device="cpu")
    tp, to, tm = topt.adamw_update(port(np_grads[1], cfg), to, tp, cfg_o)
    assert int(to["step"]) == int(jo["step"]) == 2
    assert to["step"].dtype == torch.int32
    for k in ("lr", "grad_norm"):
        assert tm[k].dtype == torch.float32
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=SCALAR_RTOL)
    m_tol = MOMENT_RTOL if moments == "float32" else BF16_ULP
    for k in ("m", "v"):
        scaled_close(to[k], port(jax.tree.map(np.asarray, jo[k]), cfg),
                     m_tol, f"{k} ")
        assert all(t.dtype == getattr(torch, moments)
                   for _, t in tree_items(to[k]))
    exp_p = port(jax.tree.map(np.asarray, jp), cfg)
    if param_dtype == "float32":
        abs_close(tp, exp_p, 1e-5, "params ")
    else:
        scaled_close(tp, exp_p, BF16_ULP, "params ")


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen3-moe-30b-a3b",
                                  "mamba2-780m"])
def test_train_step_matches_reference_jit(arch):
    """One step of the port's ``make_train_step`` against the reference's
    jitted one, from the same weights and batch (remat on in both)."""
    jcfg, cfg, np_params, batch = setup(arch)
    opt_kw = dict(lr=1e-3, warmup_steps=1)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt.AdamWConfig(**opt_kw)))
    jp = jax.tree.map(jnp.asarray, np_params)
    jp, jo, jm = jstep(jp, jopt.adamw_init(jp), {k: jnp.asarray(v)
                                                for k, v in batch.items()})
    tp = port(np_params, cfg)
    tstep = ttrain.make_train_step(cfg, topt.AdamWConfig(**opt_kw))
    tp, to, tm = tstep(tp, topt.adamw_init(tp), batch)
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=SCALAR_RTOL, err_msg=k)
    for k in ("m", "v"):
        scaled_close(to[k], port(jax.tree.map(np.asarray, jo[k]), cfg),
                     MOMENT_RTOL, f"{k} ")
    abs_close(tp, port(jax.tree.map(np.asarray, jp), cfg), PARAM_ATOL,
              "params ")


def test_five_steps_track_reference_loop():
    """``train_loop`` in both packages from the same weights and batch
    stream: the loss of every step within 1e-3 relative (each step's
    params differ by Adam's sign-like first updates, so later losses
    drift a little)."""
    jcfg, cfg, np_params, _ = setup("phi4-mini-3.8b")
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jres = jtrain.train_loop(jcfg, jax.tree.map(jnp.asarray, np_params),
                             token_batches(jcfg, 4, 32, seed=5),
                             jopt.AdamWConfig(**opt_kw), steps=5, log_every=1)
    tres = ttrain.train_loop(cfg, port(np_params, cfg),
                             token_batches(cfg, 4, 32, seed=5),
                             topt.AdamWConfig(**opt_kw), steps=5, log_every=1)
    assert [h["step"] for h in tres["history"]] == list(range(5))
    assert all(h.keys() == {"step", "loss", "lr", "elapsed"}
               for h in tres["history"])
    for jh, th in zip(jres["history"], tres["history"]):
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-3)
        np.testing.assert_allclose(th["lr"], jh["lr"], rtol=SCALAR_RTOL)


def test_microbatching_matches_full_batch():
    """4 microbatches with remat against 1 without, on the port, to the
    reference's bound (loss 2e-3; params rtol=atol=3e-3); the
    microbatched grads accumulate in f32.  The port's microbatched loss
    and grad norm also match the reference's microbatched step to 1e-5
    relative."""
    jcfg, cfg, np_params, batch = setup("phi4-mini-3.8b", batch=8, seq=32)
    opt_cfg = topt.AdamWConfig(lr=1e-3)
    s1 = ttrain.make_train_step(cfg, opt_cfg, num_microbatches=1, remat=False)
    s4 = ttrain.make_train_step(cfg, opt_cfg, num_microbatches=4, remat=True)
    p1, _, m1 = s1(port(np_params, cfg), topt.adamw_init(port(np_params, cfg)),
                   batch)
    p4, _, m4 = s4(port(np_params, cfg), topt.adamw_init(port(np_params, cfg)),
                   batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-3
    exp = dict(tree_items(p1))
    for key, a in tree_items(p4):
        np.testing.assert_allclose(a.numpy(), exp[key].numpy(), rtol=3e-3,
                                   atol=3e-3, err_msg=key)
    j4 = jax.jit(jtrain.make_train_step(jcfg, jopt.AdamWConfig(lr=1e-3),
                                        num_microbatches=4, remat=True))
    jp = jax.tree.map(jnp.asarray, np_params)
    _, _, jm4 = j4(jp, jopt.adamw_init(jp), {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m4[k]), float(jm4[k]),
                                   rtol=SCALAR_RTOL, err_msg=k)


def test_one_microbatch_grads_keep_param_dtype():
    """With one microbatch the gradients are in the params' dtype (bf16
    here), as ``jax.value_and_grad`` gives them; with several, f32."""
    cfg = get_smoke_config("qwen2.5-14b").with_(dtype="bfloat16")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    batch = ttrain.batch_to_device(next(token_batches(cfg, 4, 16)), "cpu")
    seen = {}
    real = topt.adamw_update

    def spy(grads, *a, **k):
        seen["dtypes"] = {t.dtype for _, t in tree_items(grads)}
        return real(grads, *a, **k)

    ttrain.adamw_update, saved = spy, ttrain.adamw_update
    try:
        for n, want in ((1, {torch.bfloat16}), (2, {torch.float32})):
            step = ttrain.make_train_step(cfg, num_microbatches=n)
            step(params, topt.adamw_init(params), batch)
            assert seen["dtypes"] == want, (n, seen["dtypes"])
    finally:
        ttrain.adamw_update = saved


def test_remat_with_a_cache_raises():
    cfg = get_smoke_config("qwen2.5-14b")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    cache = tmodel.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        tmodel.forward(params, cfg, torch.zeros(1, 4, dtype=torch.long),
                       cache=cache, remat=True)


def test_abstract_adamw_init_names_the_dryrun_item():
    """The dryrun's abstract AdamW state: meta moments
    shaped like the params at the moment dtype, and a meta step."""
    params = {"w": torch.zeros(2, 3), "b": [torch.zeros(4)]}
    st = topt.adamw_init(params, topt.AdamWConfig(moment_dtype="bfloat16"),
                         abstract=True)
    for key in ("m", "v"):
        assert st[key]["w"].shape == (2, 3) and st[key]["b"][0].shape == (4,)
        assert st[key]["w"].dtype == torch.bfloat16
        assert st[key]["w"].device.type == "meta"
    assert st["step"].dtype == torch.int32 and st["step"].device.type == "meta"


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoint_roundtrip_bit_equal(tmp_path, moments):
    """A bf16 model's params and its moments (f32 or bf16) and step come
    back bit for bit; a template of another shape is refused."""
    cfg = get_smoke_config("mamba2-780m").with_(dtype="bfloat16")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    opt_cfg = topt.AdamWConfig(moment_dtype=moments)
    step_fn = ttrain.make_train_step(cfg, opt_cfg)
    params, opt, _ = step_fn(params, topt.adamw_init(params, opt_cfg),
                             next(token_batches(cfg, 2, 16)))
    path = save_checkpoint(str(tmp_path), params, opt, step=7)
    assert latest_checkpoint(str(tmp_path)) == path
    assert os.path.basename(path) == "ckpt_00000007.npz"
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000007.npz"]
    blank = tree_map(torch.zeros_like, params)
    p2, o2, step = load_checkpoint(path, blank, tree_map(torch.zeros_like,
                                                         opt))
    assert step == 7
    for (ka, a), (kb, b) in zip(tree_items((params, opt)),
                                tree_items((p2, o2))):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), ka
    assert any(t.dtype == torch.bfloat16 for _, t in tree_items(p2))
    with np.load(path) as blob:
        assert "p['embed']" in blob and "o['step']" in blob
    blank["embed"] = torch.zeros(3, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="embed"):
        load_checkpoint(path, blank, opt)
    blank["embed"] = torch.zeros_like(params["embed"], dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        load_checkpoint(path, blank, opt)


def test_loss_decreases():
    """The reference's convergence check on the port."""
    cfg = get_smoke_config("chatglm3-6b")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    res = ttrain.train_loop(cfg, params, token_batches(cfg, 8, 64),
                            topt.AdamWConfig(lr=1e-3, warmup_steps=5,
                                             total_steps=40),
                            steps=40, log_every=39)
    first = res["history"][0]["loss"]
    last = res["history"][-1]["loss"]
    assert last < first - 0.5, (first, last)


def test_launcher_prints_reference_format():
    """``--smoke --device cpu`` prints what the reference launcher prints
    for the same flags: one JSON history record a line with the same keys
    and steps and the same lr to 1e-5 relative (the schedule is shared;
    near the cosine's end ``1 + cos`` cancels, so XLA's and torch's cos
    differ by a few ulp there; the weights come from another generator,
    so the losses differ), then ``loss a -> b``."""
    argv = ["--arch", "chatglm3-6b", "--smoke", "--steps", "12", "--batch",
            "2", "--seq", "16"]
    outs = []
    for main, extra in ((jlaunch.main, []), (tlaunch.main,
                                             ["--device", "cpu"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv + extra) == 0
        outs.append(buf.getvalue().splitlines())
    jlines, tlines = outs
    assert len(tlines) == len(jlines)
    for jl, tl in zip(jlines[:-1], tlines[:-1]):
        jh, th = json.loads(jl), json.loads(tl)
        assert list(th) == list(jh)
        assert th["step"] == jh["step"]
        np.testing.assert_allclose(th["lr"], jh["lr"], rtol=SCALAR_RTOL)
    assert re.fullmatch(r"loss \d+\.\d{3} -> \d+\.\d{3}", tlines[-1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(argv)


def test_quickstart_torch_on_cpu():
    """``examples/quickstart_torch.py --device cpu``, in this process (so
    at this file's torch thread count): 30 training steps with falling
    loss, 4 requests served to 12 tokens, KV moved."""
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main(["--device", "cpu"])
    out = buf.getvalue()
    losses = [float(x) for x in re.findall(r"loss (\d+\.\d+)", out)]
    assert len(losses) == 4 and losses[-1] < losses[0]
    served = re.findall(r"\[done\] generated=\[([\d, ]+)\]", out)
    assert len(served) == 4 and all(len(s.split(",")) == 12 for s in served)
    moved = int(re.search(r"KV handoff between instances: (\d+) bytes",
                          out).group(1))
    assert moved > 0
