"""`--quant-int8` training of the port (models/layers.py `live_int8`,
train/trainer.py, cli/train.py) against the JAX package on the CPU.

JAX trains its int8 models without raising: `jax.grad` through
`ops/quant.py:int8_matmul` reaches x and w only through their scales (the
int8 codes, round and the integer products carry no cotangent), and a
reduce-max splits its cotangent evenly across ties. Each int8 site of the
port is held to that gradient within 1e-4 of each leaf's scale on shared
inputs and weights: QDense (per-channel weights, per-token activations),
the causal conv, self-attention's shared quantization and the conv FF. The
whole NAR model's forward differs from JAX's in float32's summation order,
which moves a few activations across an int8 rounding boundary; its gradients are held to the measured agreement of such flips
(below); the tiny normalizer's match per leaf."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.ddpm_loss import DDPMDiscreteLoss as JDDPMLoss
from diffnorm_tpu.criterions.nar_loss import NARSpeechToUnitLoss as JNARLoss
from diffnorm_tpu.models import layers as jlayers
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
from diffnorm_tpu_torch.models import layers
from diffnorm_tpu_torch.ops import quant as quant_ops
from diffnorm_tpu_torch.train.checkpoint import load_params
from diffnorm_tpu_torch.weights import from_jax_params, to_jax_variables
from tests.test_torch_nar_train import NAR, VOCAB, _batch, _perturb, _port, _torch
from tests.test_torch_train import (
    DIFF,
    _cli_args,
    _micro_batches,
    _port_diffusion,
    _torch_batch,
    _write_corpus,
)
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

# per site: the same float products as JAX's in another order, no code
# differs (measured within 1e-6 of each leaf's scale)
SITE_TOL = 1e-4
# the tiny normalizer as a whole is held per leaf too (measured: the
# gradient vector 5.8e-7 apart relative). The NAR model's forward differs
# from JAX's in float32's summation order (batch statistics, LayerNorms),
# which moves a few activations across an int8 rounding boundary; measured
# on the CPU at these seeds: loss 9.6e-4 apart relative, the gradients as
# one vector at cosine 0.99958 and 0.029 apart relative (L2). The bounds
# hold those with a margin of about 2x.
MODEL_LOSS_RTOL, MODEL_GRAD_COS, MODEL_GRAD_REL = 2e-3, 0.999, 0.06

D, T_SITE, B_SITE = 16, 9, 2


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _grads_tree(model: torch.nn.Module, grads) -> dict:
    """The gradients of `model.parameters()` as a JAX params tree."""
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(torch.zeros_like(p) if g is None else g)
    return to_jax_variables(holder)["params"]


def _site(kind):
    """(JAX module, port module, JAX call kwargs) of one int8 site."""
    if kind == "dense":
        return (jlayers.QDense(24, quant=True), layers.Dense(D, 24, quant=True), {})
    if kind == "conv":
        return (jlayers.CausalConv1d(D, 3, dilation=2, quant=True),
                layers.CausalConv1d(D, D, 3, 2, quant=True), {})
    if kind == "attention":
        return (jlayers.Attention(dim=D, dim_head=8, heads=2, quant=True),
                layers.Attention(D, 8, 2, quant=True), {"mask": True})
    return (jlayers.FeedForward(dim=D, mult=2, causal_conv=True, quant=True),
            layers.FeedForward(D, 2, True, quant=True), {})


@pytest.mark.parametrize("kind", ["dense", "conv", "attention", "feedforward"])
def test_int8_site_gradients_match_jax_grad(kind):
    """Gradients of sum(y * r) w.r.t. the input and every parameter of one
    int8 site, the port's (`live_int8`) against `jax.grad`, within 1e-4 of
    each leaf's scale; and no straight-through estimator: a QDense kernel's
    gradient has at most one non-zero per output channel (at its |w| max)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B_SITE, T_SITE, D)).astype(np.float32)
    x[1, -3:] = 0.0  # an all-zero token: its scale sits at the 1e-12 floor
    jm, tm, kw = _site(kind)
    mask = np.arange(T_SITE)[None] < np.array([[T_SITE], [T_SITE - 3]])
    call = {"mask": mask} if kw.get("mask") else {}
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), x, **call))
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        variables["params"])
    r = rng.normal(size=np.asarray(jm.apply({"params": params}, x, **call)).shape)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, **call) * r)

    ref_p, ref_x = jax.device_get(jax.jit(jax.grad(loss, argnums=(0, 1)))(params,
                                                                          jnp.asarray(x)))
    from_jax_params(tm, params)
    layers.set_live_int8(tm)
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt, mask=torch.from_numpy(mask)) if call else tm(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm.apply({"params": params},
                               x, **call)), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((out * torch.from_numpy(r).float()).sum(),
                                [xt] + list(tm.parameters()), allow_unused=True)
    got = _flat(_grads_tree(tm, grads[1:]))
    want = _flat(ref_p)
    assert set(got) == set(want)
    for k, ref in want.items():
        scale = max(np.abs(ref).max(), 1e-3)
        assert np.abs(got[k] - ref).max() <= SITE_TOL * scale, k
        if k.endswith("kernel") and ref.ndim == 2:  # QDense [in, out]
            assert (np.count_nonzero(got[k], axis=0) <= 1).all(), k
            assert np.count_nonzero(got[k]) > 0, k
    scale = np.abs(ref_x).max()
    assert np.abs(grads[0].numpy() - ref_x).max() <= SITE_TOL * scale


def _compare_model_grads(got_tree, want_tree, loss, ref_loss):
    got, want = _flat(got_tree), _flat(want_tree)
    assert set(got) == set(want)
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([want[k].ravel() for k in sorted(want)])
    assert np.isfinite(a).all()
    assert abs(loss - ref_loss) <= MODEL_LOSS_RTOL * abs(ref_loss)
    assert a @ b / np.linalg.norm(a) / np.linalg.norm(b) >= MODEL_GRAD_COS
    assert np.linalg.norm(a - b) <= MODEL_GRAD_REL * np.linalg.norm(b)


def test_int8_normalizer_gradients_match_jax_grad():
    """The tiny normalizer with `quant_int8` (int8 WaveNet convs and
    transformer, the module route) against `jax.grad` of JAX's criterion
    (deterministic, draws injected), the trainable subtrees alone, within
    1e-4 of each leaf's scale."""
    cfg = Config(arch="diff_discrete", criterion="ddpm_discrete_loss", quant_int8=True, **DIFF)
    task = JTASKS.get("speech_diffusion_discrete").setup_task(cfg)
    jmodel = task.build_model()
    batch = _micro_batches(np.random.default_rng(1), "ddpm", 1)[0]
    variables = task.init_variables(jmodel, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        jax.device_get(variables["params"]))
    jcrit = JDDPMLoss(cfg, task)
    trainable = {k: v for k, v in params.items() if k != "vae"}

    def loss_fn(p):
        return jcrit(jmodel, {"params": {**p, "vae": params["vae"]}}, batch,
                     jax.random.PRNGKey(0), train=False)[0]

    ref_loss, ref = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    model = from_jax_params(_port_diffusion(quant_int8=True, int8_route="module"), params)
    assert not model.denoiser.wavenet.chain_kernel  # the int8 module convs, as JAX's
    layers.set_live_int8(model)
    loss, _ = DDPMDiscreteLoss()(model.eval(), _torch_batch(batch))
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    got = _flat({k: v for k, v in _grads_tree(model, grads).items() if k != "vae"})
    want = _flat(jax.device_get(ref))
    assert set(got) == set(want)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for k, g in want.items():
        assert np.abs(got[k] - g).max() <= SITE_TOL * max(np.abs(g).max(), 1e-3), k
    assert np.count_nonzero(got["denoiser/transformer/ff_0/proj_in/kernel"]) > 0


def test_int8_nar_gradients_track_jax_grad():
    """The tiny NAR model with `quant_int8` in training mode (batch
    statistics) against `jax.grad` of JAX's criterion at dropout 0."""
    jm = JNARS2UTModule(vocab_size=VOCAB, dropout=0.0, quant_int8=True, **NAR)
    b0 = _batch(0)
    variables = jm.init(jax.random.PRNGKey(0), b0["src_tokens"], b0["src_lengths"],
                        b0["prev_target"], tgt_tokens=b0["target"])
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(1))
    batch = _batch(8)
    crit = JNARLoss(Config(label_smoothing=0.2))

    def loss_fn(p):
        return crit(jm, {**variables, "params": p}, batch, jax.random.PRNGKey(0), train=True)[0]

    ref_loss, ref = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    model = _port(variables, quant_int8=True).train()
    layers.set_live_int8(model)
    loss, _ = NARSpeechToUnitLoss(0.2)(model, _torch(batch))
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    _compare_model_grads(_grads_tree(model, grads), jax.device_get(ref), float(loss),
                         float(ref_loss))


def test_bf16_working_copy_quantizes_the_float32_masters():
    """Under a bf16 working copy a live QDense quantizes its float32
    master's values, as JAX quantizes its float32 params, and the gradient
    reaches the bf16 weight, not the master."""
    torch.manual_seed(0)
    master = layers.Dense(D, 24, quant=True)
    work = copy.deepcopy(master).to(torch.bfloat16)
    layers.set_live_int8(work, master)
    x = torch.randn(3, D).to(torch.bfloat16)
    y = work(x)
    wq, ws = quant_ops.quantize_weight(master.weight.detach())
    assert not torch.equal(quant_ops.quantize_weight(work.weight.detach())[0], wq)
    assert torch.equal(y, quant_ops.int8_matmul(x, wq, ws) + work.bias)
    (g,) = torch.autograd.grad(y.float().sum(), [work.weight])
    assert g.dtype == torch.bfloat16 and torch.count_nonzero(g) > 0
    assert master.weight.grad is None


def test_cli_train_quant_int8_two_updates(tmp_path, capsys):
    """cli.train --quant-int8: the VAE (which ignores it, as JAX's builder
    does), then 2 updates of the normalizer over it, finite, checkpointed,
    and the weights moved."""
    feat_dir = _write_corpus(tmp_path)
    vae_dir, diff_dir = tmp_path / "vae", tmp_path / "diff"
    assert train_cli.main(_cli_args(tmp_path, feat_dir, vae_dir, "speech_decoder", 1,
                                    ["--quant-int8"])) == 0
    vae_step = vae_dir / "step_000000001"
    args = _cli_args(tmp_path, feat_dir, diff_dir, "speech_diffusion_discrete", 2,
                     ["--speech-decoder-ckpt", str(vae_step), "--quant-int8",
                      "--save-interval-updates", "1", "--keep-last-epochs", "3"])
    capsys.readouterr()
    assert train_cli.main(args) == 0
    log = capsys.readouterr().err
    assert "epoch 1 | step 2 |" in log and "saved checkpoint at step 2" in log
    losses = [float(line.split(" loss ")[1].split()[0]) for line in log.splitlines()
              if "| step " in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    first, last = (_flat(load_params(str(diff_dir / f"step_00000000{k}"))) for k in (1, 2))
    moved = [k for k in last if not k.startswith("vae/") and not np.array_equal(first[k], last[k])]
    assert any("transformer/ff_0/proj_in" in k for k in moved)
    assert any("wavenet/stack_0/block_0/conv" in k for k in moved)
