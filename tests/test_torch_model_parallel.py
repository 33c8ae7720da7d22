"""The port's tensor parallelism (Megatron's rules over a "model" group of
gloo ranks on the CPU, tests/torch_dist_worker.py), each result held to the
one-process port and to JAX's GSPMD runs on the conftest's virtual devices:

* two float32 sgd updates of the normalizer (also at width 20, whose FF
  inner width splits unevenly), the VAE, the NAR model (conformer + NAT),
  HuBERT and the BASE MoE layer at data 1 x model 2, and Adam for the
  normalizer, against one process (the data-parallel tests' bounds: rtol
  1e-5, atol 1e-6; Adam's atol 5e-5); every replicated parameter and buffer
  equal on both model ranks after the updates; the NAR's and HuBERT's also
  at every dropout rate 0.1 (a sharded region's mask is the rank's block of
  one drawn over the whole tensor, pinned on its own below);
* the normalizer's, the NAR's (conformer + NAT, BatchNorm's batch
  statistics) and the MoE layer's sgd update against the step of JAX's
  gradient under GSPMD on a data 1 x model 2 mesh, from one initialization
  (the normalizer's draws injected);
* at data 2 x model 2: the NAR updates replicated, with --zero-sharding os
  and with --fsdp, the normalizer's with --fsdp; the mask-predict decode's
  tokens equal to JAX's data 4 x model 2 decode and to one process;
* a cli.train checkpoint written at data 2 x model 2 under --fsdp
  --zero-sharding os, validated at 1 and 3 ranks and resumed at 3;
* `shard_model`'s slices (each half of to_kv, proj_in and pointwise_conv1
  by itself) and its refusals.
"""

import json
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from diffnorm_tpu.config import Config
from diffnorm_tpu.criterions.ddpm_loss import DDPMDiscreteLoss as JDDPMLoss
from diffnorm_tpu.criterions.nar_loss import NARSpeechToUnitLoss as JNARLoss
from diffnorm_tpu.generate.mask_predict import mask_predict_decode as jax_mask_predict
from diffnorm_tpu.models.moe import BaseLayer as JBaseLayer
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from diffnorm_tpu.parallel.sharding_rules import shard_params as jax_shard_params
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.cli import validate
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.models.conformer import ConvModule
from diffnorm_tpu_torch.models.layers import Attention, FeedForward
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.models.unit_lm import UnitLMModule
from diffnorm_tpu_torch.ops.attention import apply_dropout, tp_shard
from diffnorm_tpu_torch.parallel.mesh import Axis, Mesh
from diffnorm_tpu_torch.parallel.sharding_rules import TPSpec, shard_model, tp_slice
from diffnorm_tpu_torch.train.checkpoint import load_params
from diffnorm_tpu_torch.weights import (
    flatten_tree,
    from_jax_variables,
    save_npz,
    to_jax_params,
)
from tests import torch_dist_worker as W
from tests.test_torch_distributed import ADAM_ATOL, ATOL, RTOL, _jax_params, run_ranks
from tests.test_torch_s2st import _perturb, _src
from tests.test_torch_train import _flat, _jax_stage, _micro_batches
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

JAX_SGD_LR = 1e-2  # one sgd step of JAX's TP gradient, no momentum, no clip


def _jax_tp_reference(root):
    """JAX's TP update of the normalizer: the loss and gradient of its
    criterion (draws injected) under jit on a data 1 x model 2 mesh with
    the params placed by JAX's shard_params, and one sgd step; its params
    and micro-batch written for the worker."""
    cfg, task, jmodel = _jax_stage("ddpm")
    _, params = _jax_params()  # seeded, in the init's shapes (no compiled init)
    micro = _micro_batches(np.random.default_rng(7), "ddpm", 1)[0]
    save_npz(str(root / "jax_tp_init.npz"), params)
    np.savez(root / "jax_tp_batches.npz", n=1, update_freq=1,
             **{f"0/{k}": v for k, v in micro.items()})
    (root / "jax_tp_cfg.json").write_text(json.dumps(dict(
        optimizer="sgd", lr=JAX_SGD_LR, lr_scheduler="fixed", clip_norm=0.0,
        options={"momentum": 0.0}, seed=1)))
    crit = JDDPMLoss(cfg, task)
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    trainable = {k: v for k, v in params.items() if k != "vae"}

    def loss_fn(p, batch):
        loss, mets, _ = crit(jmodel, {"params": {**p, "vae": params["vae"]}}, batch,
                             jax.random.PRNGKey(0), train=False)
        return loss, mets["sample_size"]

    (loss, sample_size), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax_shard_params(trainable, mesh), micro)
    # a "mean_loss" criterion's gradient over its sample_size (JAX
    # trainer.py:264-265, as the port's trainer divides it)
    step = JAX_SGD_LR / max(float(sample_size), 1.0)
    stepped = jax.tree_util.tree_map(lambda p, g: np.asarray(p) - step * np.asarray(g),
                                     trainable, jax.device_get(grads))
    return float(loss), _flat(stepped)


def _jax_nar_variables(vocab_size):
    """Seeded, perturbed variables of JAX's NAR at the worker's widths (in
    its init's shapes, no compiled init)."""
    widths = {k: v for k, v in W.NAR.items() if k not in ("vocab_size", "in_channels")}
    jm = JNARS2UTModule(vocab_size=vocab_size, **widths)
    src, lengths = _src(6, b=4, t=32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(src[:2]), jnp.asarray(lengths[:2]),
        jnp.full((2, 8), 4, jnp.int32)))
    rng = np.random.default_rng(0)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("scale", "var"):
            return np.ones(a.shape, np.float32)
        if name in ("bias", "mean"):
            return np.zeros(a.shape, np.float32)
        fan_in = max(int(np.prod(a.shape[:-1])), 1)
        return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
    return jm, _perturb(variables, np.random.default_rng(1))


def _jax_tp_stages(root):
    """JAX's TP updates of the NAR (its criterion at label smoothing 0.2,
    train=True: BatchNorm on the batch's statistics) and of the MoE layer
    (the worker's MSE): the loss and gradient under jit on a data 1 x model
    2 mesh, params placed by JAX's shard_params, and one sgd step as the
    port's trainer takes it (both criterions' gradients over a sample size
    of 1: the NAR's is a "sum_loss" one, the MoE's counts 1); each initial
    state and micro-batch written for the worker."""
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    jm, variables = _jax_nar_variables(W.NAR["vocab_size"])
    nar_batch = W.nar_batches()[0]
    crit = JNARLoss(Config(label_smoothing=0.2))

    def nar_loss(p, batch):
        return crit(jm, {**variables, "params": p}, batch, jax.random.PRNGKey(0),
                    train=True)[0]

    moe = JBaseLayer(**W.MOE)
    rng = np.random.default_rng(17)
    moe_params = {"expert_centroids": rng.normal(size=(4, 8)),
                  "experts_w1": rng.normal(size=(4, 8, 16)) / np.sqrt(8),
                  "experts_w2": rng.normal(size=(4, 16, 8)) / np.sqrt(16)}
    moe_params = {k: v.astype(np.float32) for k, v in moe_params.items()}
    moe_batch = W.moe_batches()[0]

    def moe_loss(p, batch):
        x = batch["src_tokens"].reshape(-1, W.MOE["dim"])
        return jnp.mean(jnp.square(moe.apply({"params": p}, x)
                                   - batch["target"].reshape(x.shape)))

    out = {}
    for stage, fn, init, batch in (("nar", nar_loss, variables, nar_batch),
                                   ("moe", moe_loss, {"params": moe_params}, moe_batch)):
        save_npz(str(root / f"jax_tp_{stage}.npz"), init)
        np.savez(root / f"jax_tp_{stage}_batch.npz", **batch)
        loss, grads = jax.jit(jax.value_and_grad(fn))(
            jax_shard_params(init["params"], mesh), {k: jnp.asarray(v) for k, v in batch.items()})
        stepped = jax.tree_util.tree_map(lambda p, g: np.asarray(p) - JAX_SGD_LR * np.asarray(g),
                                         init["params"], jax.device_get(grads))
        out[stage] = float(loss), _flat(stepped)
    return out


def _jax_decode_reference(root):
    """JAX's NAR (perturbed weights, varied units) decoding 4 rows on a data
    4 x model 2 mesh, its weights and inputs written for the worker."""
    jm, variables = _jax_nar_variables(W.DECODE_VOCAB)
    src, lengths = _src(6, b=4, t=32)
    save_npz(str(root / "decode_nar.npz"), variables)
    np.savez(root / "decode_in.npz", src=src, lengths=lengths.astype(np.int64))
    mesh = jax_make_mesh(data=4, model=2)

    def put(x):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))

    sharded = dict(variables, params=jax_shard_params(variables["params"], mesh))
    tokens, scores, _ = jax.jit(lambda v, s, n: jax_mask_predict(
        types.SimpleNamespace(module=jm), v, s, n, **W.DECODE))(sharded, put(src), put(lengths))
    return variables, np.asarray(tokens), np.asarray(scores)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tp, dptp and tp_three jobs' results under one root, and JAX's
    references."""
    root = tmp_path_factory.mktemp("tp")
    jax_ref = _jax_tp_reference(root)
    jax_stages = _jax_tp_stages(root)
    decode_ref = _jax_decode_reference(root)
    run_ranks(2, "tp", root)
    run_ranks(4, "dptp", root)
    run_ranks(3, "tp_three", root)
    return types.SimpleNamespace(root=root, jax=jax_ref, jax_stages=jax_stages,
                                 decode=decode_ref)


def _held(got, ref, adam: bool = False) -> None:
    losses, gnorms, params, _ = ref
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["gnorms"], gnorms, rtol=RTOL, atol=ATOL)
    assert sorted(k[2:] for k in got.files if k.startswith("p/")) == sorted(params)
    for name, value in params.items():
        np.testing.assert_allclose(got[f"p/{name}"], value, rtol=RTOL,
                                   atol=ADAM_ATOL if adam else ATOL, err_msg=name)


@pytest.mark.parametrize("stage, optimizer", [(s, "sgd") for s in W.TP_STAGES]
                         + [("normalizer", "adam")])
def test_tp_update_matches_one_process(runs, stage, optimizer):
    """Two float32 updates at data 1 x model 2 are the one process's, and
    every replicated parameter and buffer is equal on both model ranks."""
    suffix = "_adam" if optimizer == "adam" else ""
    got = np.load(runs.root / f"tp_{stage}{suffix}.npz")
    _held(got, W.run_updates(stage, "replicated", optimizer, Mesh()), optimizer == "adam")
    assert float(got["drift"]) == 0.0


def test_tp_normalizer_update_matches_jax_tp(runs):
    """One sgd update of the normalizer at model 2 (float32, draws injected)
    against JAX's: its loss, and the masters against the step of JAX's
    gradient under GSPMD on a data 1 x model 2 mesh."""
    ref_loss, ref_params = runs.jax
    got = np.load(runs.root / "tp_jax.npz")
    np.testing.assert_allclose(got["losses"][0], ref_loss, rtol=RTOL)
    assert float(got["drift"]) == 0.0
    model = W.normalizer()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(got[f"p/{name}"]))
    flat = {k: v for k, v in _flat(to_jax_params(model)).items() if not k.startswith("vae/")}
    assert set(flat) == set(ref_params)
    for key, ref in ref_params.items():
        np.testing.assert_allclose(flat[key], ref, rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("stage", W.JAX_TP_STAGES)
def test_tp_update_matches_jax_tp(runs, stage):
    """One sgd update of the NAR (the conformer's split_in parameters:
    pos_bias, the depthwise kernel, BatchNorm's scale and bias) or of the
    MoE layer (experts over "model") at model 2, float32, against the step
    of JAX's gradient under GSPMD on a data 1 x model 2 mesh from the same
    state: the loss, and every master."""
    ref_loss, ref_params = runs.jax_stages[stage]
    got = np.load(runs.root / f"tp_jax_{stage}.npz")
    np.testing.assert_allclose(got["losses"][0], ref_loss, rtol=RTOL)
    assert float(got["drift"]) == 0.0
    if stage == "nar":
        model = W.nar_model()
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(torch.from_numpy(got[f"p/{name}"]))
        flat = _flat(to_jax_params(model))
    else:
        flat = {k[len("p/moe."):]: got[k] for k in got.files if k.startswith("p/moe.")}
    assert set(flat) == set(ref_params)
    for key, ref in ref_params.items():
        np.testing.assert_allclose(flat[key], ref, rtol=RTOL, atol=ATOL, err_msg=key)


def test_sharded_dropout_masks_are_blocks_of_the_whole_mask():
    """A tensor-parallel rank's dropout mask in a sharded region (heads on
    axis 1, an FF inner width of 5 split 3 + 2 on the last axis) is its
    block of the mask one process draws over the whole tensor from the same
    generator state: the model ranks' blocks differ, and each rank's
    generator ends where one process's does."""
    for dim, shape in ((1, (2, 4, 3, 3)), (-1, (2, 3, 5))):
        g = torch.Generator().manual_seed(3)
        whole = apply_dropout(torch.ones(shape), 0.5, g)
        blocks = []
        for index in (0, 1):
            axis = Axis(size=2, index=index, backend="gloo")
            lo, hi = axis.block(shape[dim])
            rank_g = torch.Generator().manual_seed(3)
            got = apply_dropout(torch.ones(shape).narrow(dim, lo, hi - lo), 0.5, rank_g,
                                tp_shard(axis, dim, shape[dim]))
            np.testing.assert_array_equal(got, whole.narrow(dim, lo, hi - lo))
            assert torch.equal(rank_g.get_state(), g.get_state())
            blocks.append(got)
        n = min(b.shape[dim] for b in blocks)
        assert not torch.equal(blocks[0].narrow(dim, 0, n), blocks[1].narrow(dim, 0, n))


@pytest.mark.parametrize("stage, mode", [("nar", m) for m in W.MODES]
                         + [("normalizer", "fsdp")])
def test_dptp_update_matches_one_process(runs, stage, mode):
    """Data 2 x model 2 (--zero-sharding os and --fsdp split over the data
    group on top of the model shards): the one process's update."""
    got = np.load(runs.root / f"dptp_{stage}_{mode}.npz")
    _held(got, W.run_updates(stage, "replicated", "sgd", Mesh()))
    assert float(got["drift"]) == 0.0


def test_dptp_decode_matches_jax_and_one_process(runs):
    variables, ref_tokens, ref_scores = runs.decode
    got = np.load(runs.root / "dptp_decode.npz")
    data = np.load(runs.root / "decode_in.npz")
    model = from_jax_variables(NARS2UTModule(**{**W.NAR, "vocab_size": W.DECODE_VOCAB}),
                               variables).eval()
    with torch.no_grad():
        one = mask_predict_decode(model, torch.from_numpy(data["src"]),
                                  torch.from_numpy(data["lengths"]), **W.DECODE)
    assert (ref_tokens >= 4).sum() >= 6  # a varied unit stream
    np.testing.assert_array_equal(got["tokens"], ref_tokens)
    np.testing.assert_array_equal(got["tokens"], one[0].numpy())
    np.testing.assert_array_equal(got["steps"], one[2].numpy())
    np.testing.assert_allclose(got["scores"], ref_scores, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["scores"], one[1].numpy(), rtol=RTOL, atol=ATOL)


def test_tp_checkpoint_restores_at_one_and_three_ranks(runs):
    """The --fsdp --zero-sharding os checkpoint of data 2 x model 2 holds
    the whole state: its validation loss at 1 and 3 ranks, and by
    cli.validate at data 2 x model 2, is the run's own, and one more update
    at 3 ranks is one more update in one process."""
    root = runs.root
    loss1 = validate.validate(validate.parse_args(W.validate_argv(root, "tpckpt")))["loss"]
    loss3 = float((root / "tp_valid3.txt").read_text())
    loss_tp = float((root / "tp_valid_dptp.txt").read_text())
    manifest = json.loads((root / "tpckpt" / "manifest.json").read_text())
    loss2 = next(e["metric"] for e in manifest["checkpoints"] if e["step"] == 2)
    for loss in (loss2, loss3, loss_tp):
        assert abs(loss - loss1) <= 1e-6 * max(1.0, abs(loss1)), (loss1, loss2, loss3)
    shutil.copytree(root / "tpckpt", root / "tpckpt1")
    assert train_cli.main(W.CLI_TRAIN + ["--max-update", "3", "--save-dir",
                                         str(root / "tpckpt1")]) == 0
    one = flatten_tree(load_params(str(root / "tpckpt1" / "step_000000003")))
    three = flatten_tree(load_params(str(root / "tpckpt3" / "step_000000003")))
    assert sorted(one) == sorted(three)
    for key in one:
        np.testing.assert_allclose(three[key], one[key], rtol=RTOL, atol=ATOL, err_msg=str(key))


HALF = Axis(size=2, index=1, backend="gloo")  # rank 1 of 2 (slicing only)


def test_shard_model_splits_each_half_of_a_paired_kernel():
    torch.manual_seed(0)
    attn, ff, conv = Attention(8, dim_head=2, heads=4), FeedForward(6, causal_conv=True), \
        ConvModule(8, kernel_size=3)
    whole = {id(m): {n: p.detach().clone() for n, p in m.named_parameters()}
             for m in (attn, ff, conv)}
    specs = {id(m): shard_model(m, HALF) for m in (attn, ff, conv)}
    kv = whole[id(attn)]["to_kv.weight"]  # [k (8 rows); v (8 rows)], heads of 2 rows
    np.testing.assert_array_equal(attn.to_kv.weight.detach(), torch.cat([kv[4:8], kv[12:16]]))
    np.testing.assert_array_equal(attn.to_q.weight.detach(), whole[id(attn)]["to_q.weight"][4:])
    np.testing.assert_array_equal(attn.to_out.weight.detach(),
                                  whole[id(attn)]["to_out.weight"][:, 4:])
    assert attn.heads == 2 and specs[id(attn)]["to_kv.weight"] == TPSpec(0, 2, 16)
    inner = ff.inner  # 16: an even split (the uneven one below)
    w_in, b_in = whole[id(ff)]["proj_in.weight"], whole[id(ff)]["proj_in.bias"]
    half = inner // 2
    np.testing.assert_array_equal(ff.proj_in.weight.detach(),
                                  torch.cat([w_in[half:inner], w_in[inner + half:]]))
    np.testing.assert_array_equal(ff.proj_in.bias.detach(),
                                  torch.cat([b_in[half:inner], b_in[inner + half:]]))
    assert ff.conv.weight.shape == whole[id(ff)]["conv.weight"].shape  # replicated
    pw1 = whole[id(conv)]["pointwise_conv1.weight"]  # [a (8); b (8)]
    np.testing.assert_array_equal(conv.pointwise_conv1.weight.detach(),
                                  torch.cat([pw1[4:8], pw1[12:16]]))
    np.testing.assert_array_equal(conv.pointwise_conv2.weight.detach(),
                                  whole[id(conv)]["pointwise_conv2.weight"][:, 4:])
    assert conv.pointwise_conv1.tp_kind == "column" and conv.pointwise_conv2.tp_kind == "row"
    assert specs[id(conv)]["pointwise_conv2.weight"] == TPSpec(1, 1, 8)


def test_tp_slice_is_rank_blocks_of_each_part():
    """Each part's contiguous blocks, the first ranks one more where the
    degree does not divide a part (GSPMD's uneven split: the released FF's
    inner width 1365 over 2 is 683 + 682)."""
    t = torch.arange(24.0).reshape(12, 2)
    for index in range(3):
        got = tp_slice(t, TPSpec(0, 2, 12), index, 3)
        np.testing.assert_array_equal(got, torch.cat([t[2 * index:2 * index + 2],
                                                      t[6 + 2 * index:8 + 2 * index]]))
    blocks = [(0, 2), (2, 4), (4, 5), (5, 6)]  # 6 over 4 ranks: 2, 2, 1, 1
    for index, (lo, hi) in enumerate(blocks):
        got = tp_slice(t, TPSpec(0, 2, 12), index, 4)
        np.testing.assert_array_equal(got, torch.cat([t[lo:hi], t[6 + lo:6 + hi]]))
    w = torch.zeros(2730, 4)
    assert [tp_slice(w, TPSpec(0, 2, 2730), i, 2).shape[0] for i in (0, 1)] == [1366, 1364]
    with pytest.raises(ValueError, match="does not split"):
        tp_slice(t, TPSpec(0, 2, 12), 0, 7)


def test_shard_model_refuses_int8_and_models_without_a_tp_forward():
    torch.manual_seed(0)
    with pytest.raises(NotImplementedError, match="int8"):
        shard_model(Attention(8, dim_head=2, heads=4, quant=True), HALF)
    with pytest.raises(NotImplementedError, match="no tensor-parallel forward"):
        shard_model(UnitLMModule(20, dim=8, ffn_dim=16, layers=1, heads=2), HALF)
