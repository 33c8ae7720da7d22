"""The port's serialized export (diffnorm_tpu_torch/utils/export.py) against
its own eager forwards and against JAX's exported artifact, on the CPU.

The model is tests/test_export.py's dummy_nar NAR S2UT (2 + 2 layers, width
32), its JAX variables carried into the port by `weights.from_jax_variables`.
Each of JAX's four cases (the baked round trip, params as argument, the
batch-polymorphic artifact at B=2 and B=5, magic validation) runs on the
port, each output held to the port's eager forward within 1e-5 and to the
output of JAX's own exported artifact within 1e-4 (tests/test_torch_s2st.py's
NAR bound). One JAX artifact, batch-polymorphic, is exported and run once
for the whole file. The kernels are torch.library custom ops: each passes
`torch.library.opcheck` on CPU inputs and stays one node of an exported
program."""

import os
import subprocess
import sys
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.registry import TASKS
from diffnorm_tpu.utils import export as jexport
from diffnorm_tpu_torch.models.diffusion import Denoiser
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.ops import ffpipe as ffpipe_ops
from diffnorm_tpu_torch.ops import flash_attention as flash_ops
from diffnorm_tpu_torch.ops import fused_layer as fused_ops
from diffnorm_tpu_torch.ops import norm as norm_ops
from diffnorm_tpu_torch.ops import wavenet_chain as chain_ops
from diffnorm_tpu_torch.utils.export import (
    deserialize,
    export_fn,
    export_program,
    load_exported,
    module_fn,
    program_ops,
    save_exported,
)
from diffnorm_tpu_torch.weights import from_jax_variables
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
EAGER_TOL = 1e-5  # the program against the port's eager forward
JAX_TOL = 1e-4  # against JAX's exported artifact (test_torch_s2st.py's NAR bound)
NAR_PORT = dict(vocab_size=24, encoder_dim=32, encoder_ffn_dim=64, encoder_layers=2,
                encoder_heads=2, decoder_dim=32, decoder_ffn_dim=64, decoder_layers=2,
                decoder_heads=2, depthwise_kernel_size=7, conv_channels=32)
TINY_DENOISER = dict(dim=32, latent_dim=8, depth=2, wavenet_layers=2, wavenet_stacks=2,
                     heads=2, dim_head=16)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """tests/test_export.py's model and batch, JAX's batch-polymorphic artifact
    (written once and run once, at B=5), and the port's model on the same
    variables."""
    cfg = Config(
        arch="nar_s2ut_conformer", criterion="nar_speech_to_unit",
        encoder_layers=2, decoder_layers=2, encoder_embed_dim=32,
        encoder_ffn_embed_dim=64, encoder_attention_heads=2,
        decoder_attention_heads=2, decoder_embed_dim=32,
        decoder_ffn_embed_dim=64, conv_channels=32,
        depthwise_conv_kernel_size=7, target_code_size=20,
        label_smoothing=0.2, lr=5e-4,
    )
    task = TASKS.get("dummy_nar").setup_task(cfg)
    model = task.build_model()
    batch = task.dummy_batch(2, 48)
    variables = task.init_variables(model, jax.random.PRNGKey(0), batch)

    def fwd(variables, src, src_lengths, prev_target):
        return model.apply(variables, src, src_lengths, prev_target,
                           tgt_tokens=prev_target, deterministic=True)["logits"]

    args = tuple(np.asarray(batch[k]) for k in ("src_tokens", "src_lengths", "prev_target"))
    args5 = tuple(np.concatenate([a] * 3, axis=0)[:5] for a in args)
    jax_path = tmp_path_factory.mktemp("jax") / "nar_poly.dnx"
    jexport.save_exported(jax_path, fwd, args, params=variables, batch_poly=True)
    jax_out5 = np.asarray(jexport.load_exported(jax_path)(*map(jnp.asarray, args5)))
    port = from_jax_variables(NARS2UTModule(**NAR_PORT), variables).eval()
    return port, args, args5, jax_out5, jax_path


def _torch_args(args):
    src, lengths, prev = args
    return (torch.from_numpy(src), torch.from_numpy(lengths),
            torch.from_numpy(prev.astype(np.int64)))


class Logits(torch.nn.Module):
    """JAX's `fwd`: the forward's logits, the canvas as its own target."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, src, src_lengths, prev_target):
        return self.model(src, src_lengths, prev_target, prev_target)["logits"]


def _logits(model):
    return Logits(model)


def _eager(model, args):
    with torch.no_grad():
        return _logits(model)(*args).numpy()


def _check(got, eager, jax_out):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, eager, rtol=EAGER_TOL, atol=EAGER_TOL)
    np.testing.assert_allclose(got, jax_out, rtol=JAX_TOL, atol=JAX_TOL)


def test_baked_params_round_trip(tmp_path, built):
    port, args, _, jax_out5, _ = built
    targs = _torch_args(args)
    path = tmp_path / "nar.dnx"
    logits = _logits(port)
    nbytes = save_exported(path, module_fn(logits), targs, params=logits.state_dict())
    assert nbytes > 0 and path.exists()
    _check(load_exported(path)(*targs), _eager(port, targs), jax_out5[:2])


def test_params_as_argument(built):
    port, args, _, jax_out5, _ = built
    targs = _torch_args(args)
    logits = _logits(port)
    params = logits.state_dict()
    blob = export_fn(module_fn(logits), targs, params=params, bake_params=False)
    _check(deserialize(blob)(params, *targs), _eager(port, targs), jax_out5[:2])


def test_batch_polymorphic(tmp_path, built):
    port, args, args5, jax_out5, _ = built
    path = tmp_path / "nar_poly.dnx"
    save_exported(path, _logits(port), _torch_args(args), batch_poly=True)
    call = load_exported(path)
    # traced at B=2; runs at B=2 and B=5 from the same artifact
    _check(call(*_torch_args(args)), _eager(port, _torch_args(args)), jax_out5[:2])
    got5 = call(*_torch_args(args5))
    assert got5.shape[0] == 5
    _check(got5, _eager(port, _torch_args(args5)), jax_out5)


def test_magic_validation(tmp_path):
    bad = tmp_path / "bad.dnx"
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr("MAGIC", "something-else")
        z.writestr("program.pt2", b"")
    with pytest.raises(ValueError, match="not a diffnorm export artifact"):
        load_exported(bad)


def test_refuses_a_jax_artifact(built):
    with pytest.raises(ValueError, match="not a diffnorm export artifact"):
        load_exported(built[4])


def test_refuses_an_artifact_whose_op_is_not_registered(tmp_path, built):
    port, args, *_ = built
    path = tmp_path / "nar.dnx"
    save_exported(path, _logits(port), _torch_args(args))
    forged = tmp_path / "forged.dnx"
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(forged, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            dst.writestr(name, b'["diffnorm::no_such_kernel"]' if name == "OPS" else data)
    with pytest.raises(RuntimeError, match="not registered"):
        load_exported(forged)


def test_loads_and_runs_in_a_process_without_model_code(tmp_path, built):
    """A subprocess imports `utils.export` alone (no model module, no JAX),
    loads a baked artifact and runs it; the parent compares."""
    port, args, *_ = built
    targs = _torch_args(args)
    path = tmp_path / "nar.dnx"
    save_exported(path, _logits(port), targs)
    torch.save(targs, tmp_path / "args.pt")
    prog = f"""
import sys, torch
from diffnorm_tpu_torch.utils.export import load_exported
call = load_exported({str(path)!r})
out = call(*torch.load({str(tmp_path / "args.pt")!r}))
torch.save(out, {str(tmp_path / "out.pt")!r})
bad = sorted(m for m in sys.modules if m.startswith(("diffnorm_tpu_torch.models", "jax"))
             or m == "diffnorm_tpu" or m.startswith("diffnorm_tpu."))
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    done = subprocess.run([sys.executable, "-c", prog], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    got = torch.load(tmp_path / "out.pt")
    np.testing.assert_allclose(got.numpy(), _eager(port, targs), rtol=EAGER_TOL,
                               atol=EAGER_TOL)


def _denoiser_inputs(b, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 7, TINY_DENOISER["latent_dim"], generator=g)
    times = torch.randint(1, 50, (b,), generator=g).to(torch.int32)
    mask = torch.ones(b, 7, dtype=torch.bool)
    mask[-1, 5:] = False
    return x, times, mask


def test_params_as_input_builds_the_packs_from_the_parameters_given():
    """bake_params=False: the FeedForward and WaveNet packs come from the
    state dict the program is handed, so perturbed parameters give the
    perturbed model's eager output, not the example's."""
    torch.manual_seed(0)
    model = Denoiser(**TINY_DENOISER).eval()
    inputs = _denoiser_inputs(3)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    call = deserialize(export_fn(module_fn(model), inputs, params=params, bake_params=False))
    g = torch.Generator().manual_seed(1)
    moved = {k: v + 0.05 * torch.randn(v.shape, generator=g) if v.is_floating_point() else v
             for k, v in params.items()}
    other = Denoiser(**TINY_DENOISER).eval()
    other.load_state_dict(moved)
    with torch.no_grad():
        want, want_moved = model(*inputs), other(*inputs)
    assert (want_moved - want).abs().max() > 0.1  # the perturbation shows
    np.testing.assert_allclose(call(params, *inputs).numpy(), want.numpy(),
                               rtol=EAGER_TOL, atol=EAGER_TOL)
    np.testing.assert_allclose(call(moved, *inputs).numpy(), want_moved.numpy(),
                               rtol=EAGER_TOL, atol=EAGER_TOL)


def _int8_denoiser(route):
    torch.manual_seed(0)
    return Denoiser(quant_int8=True, int8_route=route, **TINY_DENOISER).to(
        torch.bfloat16).eval()


def _step_call(model):
    def call(x, times, mask, step_cond, pos):
        return model(x, times, mask, step_cond=step_cond, pos=pos)

    return call


def _step_inputs(model, b, seed=0):
    from diffnorm_tpu_torch.models.layers import sinusoidal_positions

    x, times, mask = _denoiser_inputs(b, seed)
    with torch.no_grad():
        conds = model.precompute_step_conds(times.float()[None])
    step_cond = torch.utils._pytree.tree_map(lambda t: t[0], conds)
    return (x.to(torch.bfloat16), times, mask, step_cond,
            sinusoidal_positions(mask, TINY_DENOISER["dim"]))


@pytest.mark.parametrize("route", ["fused_layer", "ffpipe2"])
def test_int8_kernel_routes_export_batch_polymorphic(route):
    """The int8 kernel routes (their plain versions on the CPU, as a bf16
    model takes them) export with a symbolic batch, ffpipe2 included: the
    op decides rows at each call. The program equals eager at B=2 (traced)
    and B=5, and holds the route's op."""
    model = _int8_denoiser(route)
    call = _step_call(model)
    ep = export_program(call, _step_inputs(model, 2), batch_poly=True)
    op = "fused_layer" if route == "fused_layer" else "ffpipe_layer"
    assert f"diffnorm::{op}" in program_ops(ep)
    run = ep.module()
    for b in (2, 5):
        inputs = _step_inputs(model, b, seed=b)
        with torch.no_grad():
            got, want = run(*inputs), call(*inputs)
        np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


def test_int8_packs_refuse_params_as_input():
    """An int8 pack is built from float32 masters a bf16 state dict does not
    hold: bake_params=False raises rather than serve the example's packs."""
    model = _int8_denoiser("fused_layer")
    with pytest.raises(RuntimeError, match="bake_params=True"):
        export_fn(module_fn(model, "forward"), _step_inputs(model, 2)[:3],
                  params=model.state_dict(), bake_params=False)


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    b, t, c, s, k = 2, 6, 16, 2, 3
    chain = (rnd(b, t, c), rnd(s, k, c, c) * 0.2, rnd(s, c, c) * 0.2, rnd(c, c) * 0.2,
             rnd(s, c), rnd(c), rnd(b, s, c), rnd(b, s, c), 2)
    ff = ffpipe_ops.pack_ff_weights(rnd(2 * 43, 64) * 0.1, rnd(2 * 43), rnd(43, 43, 3) * 0.1,
                                    rnd(43), rnd(64, 43) * 0.1, rnd(64))
    layer = fused_ops.pack_layer_weights(rnd(64, 64) * 0.1, rnd(128, 64) * 0.1,
                                         rnd(64, 64) * 0.1, ff)
    x8 = rnd(2, 5, 64, dtype=torch.bfloat16)
    mask = torch.tensor([[True] * 5, [True, True, True, False, False]])
    film = rnd(2, 128)
    q, kv = rnd(2, 2, 4, 8), rnd(2, 2, 9, 8)
    kmask = torch.ones(2, 9, dtype=torch.bool)
    kmask[1, 6:] = False
    return {
        "rms_norm_film": (norm_ops.rms_norm_film_op, (rnd(b, t, c), rnd(b, 2 * c), 1e-12)),
        "wavenet_chain": (chain_ops.wavenet_chain_op, chain),
        "fused_layer": (fused_ops.fused_layer_op,
                        (x8, mask, film, film, [layer[n] for n in fused_ops.LAYER_KEYS], 1, 64)),
        "ffpipe_layer": (ffpipe_ops.ffpipe_layer_op,
                         (x8, film, [ff[n] for n in ffpipe_ops.FF_KEYS], 2)),
        "flash_attention": (flash_ops.flash_attention_op, (q, kv, kv.flip(2), kmask)),
    }


@pytest.mark.parametrize("name", ["rms_norm_film", "wavenet_chain", "fused_layer",
                                  "ffpipe_layer", "flash_attention"])
def test_kernel_op_passes_opcheck_and_exports_as_one_node(name):
    op, args = _op_cases()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    ep = export_program(lambda *a: op(*a), args)
    assert program_ops(ep) == [f"diffnorm::{name}"]
    assert f"diffnorm.{name}" in str(ep.graph)
    with torch.no_grad():
        np.testing.assert_array_equal(ep.module()(*args).float().numpy(),
                                      op(*args).float().numpy())
