"""The port's normalization CLI (--cpu) on a synthetic manifest against a
manifest assembled from the JAX ddim_sample and reduce_units, with the same
noise injected into both, chunk by chunk; in float32 and with --quant-int8."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffnorm_tpu.config import Config
from diffnorm_tpu.data.batching import bucket_length
from diffnorm_tpu.data.manifest import (
    read_translation_manifest,
    write_feature_manifest,
    write_translation_manifest,
)
from diffnorm_tpu.models.diffusion import LatentDiffusionModel, ddim_sample
from diffnorm_tpu.models.wavenet import Wavenet as JWavenet
from diffnorm_tpu.ops.unit_reduce import reduce_units
from diffnorm_tpu_torch.cli import diff_norm_synthesis
from diffnorm_tpu_torch.weights import save_npz
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

TINY = dict(hidden_dim=16, latent_dim=3, feature_dim=24, chan_mults=[4],
            vae_decoder_depth=1, vae_decoder_dim_head=8, vae_decoder_heads=2,
            denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1,
            timesteps=20, vocab_size=20)


def test_cli_writes_the_jax_assembled_manifest(tmp_path, monkeypatch):
    _check_cli(tmp_path, monkeypatch, quant_int8=False)


def test_cli_quant_int8_writes_the_jax_assembled_manifest(tmp_path, monkeypatch):
    """--quant-int8 --cpu runs float32, so the transformer takes the int8
    module route; the reference is JAX's ddim_sample with quant_int8 and
    DIFFNORM_PALLAS_WAVENET=1 (the WaveNet ignores int8 there, as the port's
    does), its Pallas chains in interpret mode."""
    chains = JWavenet._chains_pallas
    monkeypatch.setattr(JWavenet, "_chains_pallas",
                        lambda self, x, t=None, film=None, interpret=False:
                        chains(self, x, t, film, interpret=True))
    monkeypatch.setenv("DIFFNORM_PALLAS_WAVENET", "1")
    _check_cli(tmp_path, monkeypatch, quant_int8=True)


def _check_cli(tmp_path, monkeypatch, quant_int8):
    jmodel = LatentDiffusionModel.build_model(Config(**TINY, quant_int8=quant_int8))
    v = jmodel.module.init({"params": jax.random.PRNGKey(1)},
                           jnp.zeros((2, 10, 24)), jnp.ones((2, 10), bool),
                           jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    save_npz(str(tmp_path / "params.npz"), params)

    rng = np.random.default_rng(0)
    feat_dir = tmp_path / "feat"
    feat_dir.mkdir()
    rows, frows = [], []
    for i in range(3):  # 2 chunks at batch size 2
        t = int(rng.integers(8, 12))
        units = np.repeat(rng.integers(0, 16, size=t // 2 + 1), 2)[:t]
        np.save(feat_dir / f"u{i}.feat.npy",
                rng.normal(size=(t, 24)).astype(np.float32))
        frows.append((f"u{i}.feat.npy", t))
        rows.append({"id": f"u{i}", "src_audio": f"u{i}", "src_n_frames": t,
                     "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": t})
    write_feature_manifest(str(feat_dir / "test.manifest.tsv"), str(feat_dir), frows)
    write_translation_manifest(str(tmp_path / "test.tsv"), rows)

    drawn = []
    noise_rng = np.random.default_rng(7)

    def numpy_noise(generator, shape, device):
        pair = tuple(torch.from_numpy(noise_rng.normal(size=shape).astype(np.float32))
                     for _ in range(2))
        drawn.append(pair)
        return pair

    monkeypatch.setattr(diff_norm_synthesis, "draw_noise", numpy_noise)
    out_dir = tmp_path / "out"
    rc = diff_norm_synthesis.main([
        str(tmp_path), "--cpu", "--params-npz", str(tmp_path / "params.npz"),
        "--tgt-feat-dir", str(feat_dir), "--output-dir", str(out_dir),
        "--start-step", "4", "--batch-size", "2", "--splits", "test",
        "--hidden-dim", "16", "--latent-dim", "3", "--feature-dim", "24",
        "--vocab-size", "20", "--timesteps", "20", "--denoiser-depth", "1",
        "--wavenet-layers", "2", "--wavenet-stacks", "1",
        "--vae-decoder-depth", "1", "--vae-decoder-dim-head", "8",
        "--vae-decoder-heads", "2", "--chan-mults", "[4]"]
        + (["--quant-int8"] if quant_int8 else []))
    assert rc == 0

    # the JAX flow: sort by reduced length, bucket, sample each chunk
    items = []
    for row in rows:
        dedup, _, keep = reduce_units(np.asarray(row["tgt_audio"].split(), np.int64))
        items.append((row, dedup, keep))
    items.sort(key=lambda it: len(it[1]))
    expected = []
    for n, start in enumerate(range(0, len(items), 2)):
        chunk = items[start:start + 2]
        max_len = bucket_length(max(len(c[1]) for c in chunk))
        feat = np.zeros((len(chunk), max_len, 24), np.float32)
        mask = np.zeros((len(chunk), max_len), bool)
        for j, (row, dedup, keep) in enumerate(chunk):
            feat[j, :len(dedup)] = np.load(feat_dir / f"{row['id']}.feat.npy")[keep]
            mask[j, :len(dedup)] = True
        enc, init = (a.numpy() for a in drawn[n])
        assert enc.shape == (len(chunk), max_len, 3)
        units, _ = ddim_sample(jmodel, {"params": params}, jnp.asarray(feat),
                               jnp.asarray(mask), jax.random.PRNGKey(0),
                               start_step=4, enc_noise=jnp.asarray(enc),
                               init_noise=jnp.asarray(init))
        for j, (row, dedup, _) in enumerate(chunk):
            norm, _, _ = reduce_units(np.asarray(units)[j, :len(dedup)])
            expected.append(dict(row, tgt_audio=" ".join(map(str, norm)),
                                 tgt_n_frames=str(len(norm))))
    assert len(drawn) == 2

    got = read_translation_manifest(os.path.join(out_dir, "test.tsv"))
    assert got == [{k: str(v) for k, v in r.items()} for r in expected]
