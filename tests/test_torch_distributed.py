"""The port's data parallelism on gloo ranks spawned on the CPU (2 and 3
ranks, one torch thread each, tests/torch_dist_worker.py), each result held
to the one-process run on the same global batch:

* two updates of the normalizer (a "mean_loss" criterion, 5 rows split 3 +
  2) and of the NAR model ("sum_loss", BatchNorm's statistics over every
  rank), replicated, with --zero-sharding os and with --fsdp: losses and
  masters (float32, rtol 1e-5, atol 1e-6); SEDD's and FastSpeech2's
  "mean_loss" updates replicated;
* the data-parallel ddim_sample (and against JAX's ddim_sample on the same
  weights and noises), cli.diff_norm_synthesis --data-parallel 2 (its output
  file byte for byte), the mask-predict decode and s2st_generate;
* a cli.train checkpoint written at 2 ranks under --fsdp --zero-sharding os
  (with an EMA, and BMUF synced at update 2), validated at 1 and 3 ranks,
  and resumed for one update at 1 and 3 ranks.

Every rank has its own timeout of RANK_TIMEOUT_S, and a rank that fails
takes the others down with it."""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffnorm_tpu.config import Config
from diffnorm_tpu.models.diffusion import LatentDiffusionModel
from diffnorm_tpu.models.diffusion import ddim_sample as jax_ddim_sample
from diffnorm_tpu_torch.cli import diff_norm_synthesis
from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.cli import validate
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.parallel.mesh import Mesh
from diffnorm_tpu_torch.train.checkpoint import load_params
from diffnorm_tpu_torch.weights import flatten_tree, save_npz
from tests import torch_dist_worker as W
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 120
RTOL, ATOL = 1e-5, 1e-6
# Adam's masters and second gradient norm: see torch_dist_worker.OPTIMIZERS
# (measured on the CPU: 1.2e-5 absolute on the keys' biases after 2 updates
# at lr 1e-3)
ADAM_ATOL, ADAM_GNORM_RTOL = 5e-5, 1e-4
JAX_TINY = dict(hidden_dim=16, latent_dim=W.LATENT, feature_dim=W.FEAT, chan_mults=[4],
                vae_decoder_depth=1, vae_decoder_dim_head=8, vae_decoder_heads=2,
                denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1, timesteps=50,
                vocab_size=W.CODES + 4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, job: str, root: Path) -> list:
    """`world` ranks of the worker's `job`; each rank's output. Kills every
    rank when one fails or outlives RANK_TIMEOUT_S."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        log = open(root / f"{job}_rank{rank}.log", "w")
        worker = [sys.executable, str(REPO / "tests" / "torch_dist_worker.py"), job, str(root)]
        procs.append((subprocess.Popen(worker, env=env, stdout=log, stderr=subprocess.STDOUT,
                                       cwd=REPO), log))
    start, failed = time.time(), None
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = next((r for r, (p, _) in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None or time.time() - start > RANK_TIMEOUT_S:
                break
            time.sleep(0.1)
        failed = next((r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)),
                      failed)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    outs = [(root / f"{job}_rank{r}.log").read_text() for r in range(world)]
    if failed is not None or any(f"RANK_OK {r}" not in out for r, out in enumerate(outs)):
        which = failed if failed is not None else 0
        raise AssertionError(f"{job} at {world} ranks: rank {which} failed or timed out "
                             f"after {time.time() - start:.0f} s:\n{outs[which][-4000:]}")
    return outs


def _jax_params():
    """A JAX normalizer at the worker's widths and seeded params in its
    init's shapes (`jax.eval_shape`: no compiled init): kernels normal over
    sqrt(fan-in), scales 1 and biases 0 perturbed by 0.05."""
    jmodel = LatentDiffusionModel.build_model(Config(**JAX_TINY))
    feat = jnp.zeros((2, 10, W.FEAT))
    shapes = jax.eval_shape(lambda: jmodel.module.init(
        {"params": jax.random.PRNGKey(0)}, feat, jnp.ones((2, 10), bool),
        jax.random.PRNGKey(0)))["params"]
    rng = np.random.default_rng(0)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1.0 + 0.05 * rng.normal(size=a.shape)).astype(np.float32)
        if len(a.shape) <= 1:
            return (0.05 * rng.normal(size=a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1]))
        return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jmodel, jax.tree_util.tree_map_with_path(leaf, shapes)


def _write_synthesis_corpus(root: Path) -> list:
    """test.tsv over 7 utterances of ragged length with repeated units, and
    their feature dumps; returns the CLI's arguments (batches of 3: rows 3,
    3, 1, padded to 4, 4, 2 at 2 ranks)."""
    rng = np.random.default_rng(21)
    feat_dir = root / "feat"
    feat_dir.mkdir()
    rows, lines = [], [str(feat_dir)]
    for i in range(7):
        n = int(rng.integers(6, 14))
        units = rng.integers(0, W.CODES, size=n)
        np.save(feat_dir / f"u{i}.npy", rng.normal(size=(n, W.FEAT)).astype(np.float32))
        lines.append(f"u{i}.npy\t{n}")
        rows.append({"id": f"u{i}", "src_audio": f"u{i}.wav", "src_n_frames": n,
                     "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": n})
    (feat_dir / "test.manifest.tsv").write_text("\n".join(lines) + "\n")
    write_translation_manifest(str(root / "test.tsv"), rows)
    widths = ["--hidden-dim", "16", "--latent-dim", str(W.LATENT), "--feature-dim", str(W.FEAT),
              "--vocab-size", str(W.CODES + 4), "--timesteps", "50", "--denoiser-depth", "1",
              "--wavenet-layers", "2", "--wavenet-stacks", "1", "--vae-decoder-depth", "1",
              "--vae-decoder-dim-head", "8", "--vae-decoder-heads", "2", "--chan-mults", "[4]"]
    return [str(root), "--params-npz", str(root / "ddim_params.npz"), "--tgt-feat-dir",
            str(feat_dir), "--splits", "test", "--start-step", "6", "--batch-size", "3",
            "--cpu", *widths]


@pytest.fixture(scope="module")
def jax_model():
    return _jax_params()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, jax_model):
    """The 2-rank job's results under its root."""
    root = tmp_path_factory.mktemp("dp2")
    _, params = jax_model
    save_npz(str(root / "ddim_params.npz"), {"params": params})
    rng = np.random.default_rng(22)
    b, t = 5, 12
    mask = np.ones((b, t), bool)
    mask[1, 9:] = False
    mask[4, 5:] = False
    np.savez(root / "ddim_in.npz", feature=rng.normal(size=(b, t, W.FEAT)).astype(np.float32),
             mask=mask, enc_noise=rng.normal(size=(b, t, W.LATENT)).astype(np.float32),
             init_noise=rng.normal(size=(b, t, W.LATENT)).astype(np.float32), start_step=6)
    (root / "synth_args.txt").write_text(" ".join(_write_synthesis_corpus(root)))
    run_ranks(2, "two", root)
    return root


@pytest.fixture(scope="module")
def three_ranks(two_ranks):
    run_ranks(3, "three", two_ranks)
    return two_ranks


@pytest.fixture(scope="module")
def one_process_updates():
    return {(stage, opt): W.run_updates(stage, "replicated", opt, Mesh())[:3]
            for stage in W.FULL_STAGES for opt in W.OPTIMIZERS}


@pytest.mark.parametrize("optimizer", list(W.OPTIMIZERS))
@pytest.mark.parametrize("mode", list(W.MODES))
@pytest.mark.parametrize("stage", ["normalizer", "nar"])
def test_update_matches_one_process(two_ranks, one_process_updates, stage, mode, optimizer):
    losses, gnorms, params = one_process_updates[stage, optimizer]
    got = np.load(two_ranks / f"{stage}_{mode}_{optimizer}.npz")
    adam = optimizer == "adam"
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["gnorms"][:1], gnorms[:1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["gnorms"], gnorms, rtol=ADAM_GNORM_RTOL if adam else RTOL,
                               atol=ATOL)
    assert sorted(k[2:] for k in got.files if k.startswith("p/")) == sorted(params)
    for name, value in params.items():
        np.testing.assert_allclose(got[f"p/{name}"], value, rtol=RTOL,
                                   atol=ADAM_ATOL if adam else ATOL, err_msg=name)


def test_ddim_sample_matches_one_process_and_jax(two_ranks, jax_model):
    jmodel, params = jax_model
    data = np.load(two_ranks / "ddim_in.npz")
    got = np.load(two_ranks / "ddim.npz")
    one = W.run_ddim(two_ranks, Mesh())
    np.testing.assert_array_equal(got["units"], one["units"])
    np.testing.assert_allclose(got["recon"], one["recon"], rtol=RTOL, atol=ATOL)
    ref_units, _ = jax_ddim_sample(
        jmodel, {"params": params}, jnp.asarray(data["feature"]), jnp.asarray(data["mask"]),
        jax.random.PRNGKey(0), start_step=6, enc_noise=jnp.asarray(data["enc_noise"]),
        init_noise=jnp.asarray(data["init_noise"]))
    np.testing.assert_array_equal(got["units"], np.asarray(ref_units))


def test_synthesis_cli_output_equals_one_process(two_ranks):
    args = (two_ranks / "synth_args.txt").read_text().split()
    assert diff_norm_synthesis.main(args + ["--output-dir", str(two_ranks / "synth_one")]) == 0
    one = (two_ranks / "synth_one" / "test.tsv").read_bytes()
    assert len(one.splitlines()) == 8  # the header and 7 rows
    assert (two_ranks / "synth_dp" / "test.tsv").read_bytes() == one


def test_mask_predict_and_s2st_match_one_process(two_ranks):
    got = np.load(two_ranks / "decode.npz")
    one = W.run_decodes(Mesh())
    for key in ("tokens", "steps", "units", "counts", "wav_lengths"):
        np.testing.assert_array_equal(got[key], one[key], err_msg=key)
    np.testing.assert_allclose(got["scores"], one["scores"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["wav"], one["wav"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("stage", W.EXTRA_STAGES)
def test_other_mean_loss_criterions_match_one_process(two_ranks, stage):
    """SEDD's and FastSpeech2's means divide by the global batch's counts
    (5 rows split 3 + 2): two sgd updates at 2 ranks are the one process's."""
    losses, gnorms, params, _ = W.run_updates(stage, "replicated", "sgd", Mesh())
    got = np.load(two_ranks / f"{stage}_replicated_sgd.npz")
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["gnorms"], gnorms, rtol=RTOL, atol=ATOL)
    for name, value in params.items():
        np.testing.assert_allclose(got[f"p/{name}"], value, rtol=RTOL, atol=ATOL, err_msg=name)


def _step_params(path: Path) -> dict:
    return flatten_tree(load_params(str(path)))


def test_checkpoint_restores_at_one_and_three_ranks(three_ranks):
    root = three_ranks
    loss1 = validate.validate(validate.parse_args(W.validate_argv(root)))["loss"]
    loss3 = float((root / "valid3.txt").read_text())
    manifest = json.loads((root / "ckpt" / "manifest.json").read_text())
    loss2 = next(e["metric"] for e in manifest["checkpoints"] if e["step"] == 2)
    for loss in (loss2, loss3):  # the 2-rank run's own, and at 3 ranks
        assert abs(loss - loss1) <= 1e-6 * max(1.0, abs(loss1)), (loss1, loss2, loss3)
    # the whole optimizer state restored at 3 ranks: one more update there
    # equals one more update in one process
    shutil.copytree(root / "ckpt", root / "ckpt1")
    assert train_cli.main(W.CLI_TRAIN + ["--max-update", "3", "--save-dir",
                                         str(root / "ckpt1")]) == 0
    one = _step_params(root / "ckpt1" / "step_000000003")
    three = _step_params(root / "ckpt3" / "step_000000003")
    two = _step_params(root / "ckpt" / "step_000000002")
    assert sorted(one) == sorted(three)
    assert any(not np.array_equal(one[k], two[k]) for k in one)  # the update moved them
    for key in one:
        np.testing.assert_allclose(three[key], one[key], rtol=RTOL, atol=ATOL, err_msg=str(key))
