"""The port's checkpoints in (diffnorm_tpu_torch/utils/convert_weights.py,
cli/{convert_checkpoint,average_checkpoints,validate}.py, cli.train
--restore-file, scripts/orbax_to_npz.py) against the JAX package on the CPU.

Seeded fairseq-layout state dicts come from chip_smoke.py's builders at tiny
widths: two heads where the architecture has heads, non-zero biases,
BatchNorm statistics away from (0, 1), weight-norm and spectral-norm triplets,
and the tied output projection. The port's converter tree equals JAX's bit
for bit, and the port's models loaded from it compute what JAX's models
compute from JAX's tree within 1e-5 of scale."""

import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from diffnorm_tpu.models import hifigan_disc as jdisc
from diffnorm_tpu.models.diffusion import LatentDiffusionModule as JLatentDiffusionModule
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu.models.vae import SpeechVAEModule as JSpeechVAEModule
from diffnorm_tpu.utils import convert_weights as jcw
from diffnorm_tpu_torch.cli import convert_checkpoint
from diffnorm_tpu_torch.models import hifigan_disc as disc
from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.models.vae import SpeechVAEModule
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.utils import convert_weights as cw
from diffnorm_tpu_torch.weights import flatten_tree, from_jax_variables, save_npz
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
VAE_W = dict(feature_dim=24, latent_dim=3, vocab_size=20, decoder_depth=1,
             decoder_dim_head=8, decoder_heads=2, chan_mults=[4])
DIFF_W = dict(dim=16, latent_dim=3, feature_dim=24, vocab_size=20, denoiser_depth=1,
              wavenet_layers=2, wavenet_stacks=1, vae_decoder_depth=1,
              vae_decoder_dim_head=8, vae_decoder_heads=2, chan_mults=[4])
NAR_W = dict(vocab_size=24, dim=32, ffn_dim=64, encoder_layers=2, encoder_heads=2,
             decoder_layers=2, decoder_heads=2, depthwise_kernel_size=7, conv_channels=32)
NAR_PORT = dict(vocab_size=24, encoder_dim=32, encoder_ffn_dim=64, encoder_layers=2,
                encoder_heads=2, decoder_dim=32, decoder_ffn_dim=64, decoder_layers=2,
                decoder_heads=2, depthwise_kernel_size=7, conv_channels=32)
DISC_WIDTH = 0.0625
# the port's float32 forwards against JAX's on the same converted weights:
# the same products summed in other orders
REL = 1e-5


def _state(family, seed=0):
    if family == "vae":
        return chip_smoke.fairseq_vae_state(torch, seed, **VAE_W)
    if family == "diffusion":
        return chip_smoke.fairseq_diffusion_state(torch, seed, **DIFF_W)
    if family == "nar":
        return chip_smoke.fairseq_nar_state(torch, seed, **NAR_W)
    return chip_smoke.fairseq_discriminator_states(torch, seed, width=DISC_WIDTH)


def _convert(module, family, sd):
    if family == "vae":
        return {"params": module.convert_vae_state(sd)}
    if family == "diffusion":
        return {"params": module.convert_diffusion_state(sd)}
    if family == "nar":
        return module.convert_nar_state(sd)
    return module.convert_gan_discriminators(*sd)


def _flat(tree):
    return {"/".join(k): v for k, v in flatten_tree(tree).items()}


def _apply(module, variables, *args, method=None):
    """module.apply under jax.jit: one compile instead of one per op."""
    return jax.jit(lambda v, *a: module.apply(v, *a, method=method))(variables, *args)


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("family", ["vae", "diffusion", "nar", "gan_discriminators"])
def test_converter_tree_equals_jax_bit_for_bit(family):
    sd = _state(family)
    got, want = _flat(_convert(cw, family, sd)), _flat(_convert(jcw, family, sd))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if family == "nar":  # the tied projection is mapped once
        assert "params/decoder/output_proj/kernel" not in got
        assert "batch_stats/encoder/layer_1/conv_module/batch_norm/var" in got


def _vae_models(tree):
    jm = JSpeechVAEModule(dim=24, latent_dim=3, vocab_size=20, decoder_depth=1,
                          decoder_dim_head=8, decoder_heads=2, chan_mults=(4,))
    tm = SpeechVAEModule(24, 3, 20, 1, 8, 2, [4])
    return jm, from_jax_variables(tm, tree).eval()


def _diffusion_models(tree):
    jm = JLatentDiffusionModule(**dict(DIFF_W, chan_mults=(4,)))
    tm = LatentDiffusionModule(**DIFF_W)
    return jm, from_jax_variables(tm, tree).eval()


def test_converted_models_compute_what_jax_computes():
    """The VAE's LM-head logits, the denoiser's output (with its frozen VAE's
    decode), the NAR's logits and length logits, and the discriminators'
    scores and feature maps."""
    rng = np.random.default_rng(3)
    b, t = 2, 9
    mask = np.arange(t)[None, :] < np.asarray([t, t - 3])[:, None]
    latent = rng.normal(size=(b, t, 3)).astype(np.float32)

    tree = {"params": cw.convert_vae_state(_state("vae"))}
    jm, tm = _vae_models(tree)
    _, want = _apply(jm, tree, jnp.asarray(latent), jnp.asarray(mask), method="decode")
    with torch.no_grad():
        _, got = tm.decode(torch.from_numpy(latent), torch.from_numpy(mask))
    assert _rel(got, want) <= REL

    tree = {"params": cw.convert_diffusion_state(_state("diffusion"))}
    jm, tm = _diffusion_models(tree)
    times = np.asarray([3, 17], np.int32)
    want = _apply(jm, tree, jnp.asarray(latent), jnp.asarray(times), jnp.asarray(mask),
                  method="denoise")
    want_feat, _ = _apply(jm, tree, jnp.asarray(latent), jnp.asarray(mask), method="decode")
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(latent), torch.from_numpy(times),
                         torch.from_numpy(mask))
        got_feat, _ = tm.decode(torch.from_numpy(latent), torch.from_numpy(mask))
    assert _rel(got, want) <= REL and _rel(got_feat, want_feat) <= REL

    variables = cw.convert_nar_state(_state("nar"))
    jm = JNARS2UTModule(vocab_size=24, encoder_dim=32, encoder_ffn_dim=64, encoder_layers=2,
                        encoder_heads=2, decoder_dim=32, decoder_ffn_dim=64, decoder_layers=2,
                        decoder_heads=2, depthwise_kernel_size=7, conv_channels=32)
    tm = from_jax_variables(NARS2UTModule(**NAR_PORT), variables).eval()
    src = rng.normal(size=(b, 40, 80)).astype(np.float32)
    lengths = np.asarray([40, 29], np.int32)
    tokens = rng.integers(4, 24, size=(b, 7)).astype(np.int64)
    tokens[1, 5:] = 1
    enc, emask = _apply(jm, variables, jnp.asarray(src), jnp.asarray(lengths), method="encode")
    want = _apply(jm, variables, jnp.asarray(tokens), enc, emask, method="decode")
    want_len = _apply(jm, variables, enc, emask, method="forward_length")
    with torch.no_grad():
        t_enc, t_mask = tm.encode(torch.from_numpy(src), torch.from_numpy(lengths))
        got = tm.decode(torch.from_numpy(tokens), t_enc, t_mask)
        got_len = tm.forward_length(t_enc, t_mask)
    assert _rel(got, want) <= REL and _rel(got_len, want_len) <= REL

    variables = cw.convert_gan_discriminators(*_state("gan_discriminators"))
    real = (rng.normal(size=(2, 301)) * 0.3).astype(np.float32)
    fake = (0.5 * real + rng.normal(size=real.shape) * 0.1).astype(np.float32)
    for name, jd, td in (
            ("mpd", jdisc.MultiPeriodDiscriminator(width=DISC_WIDTH),
             disc.MultiPeriodDiscriminator(width=DISC_WIDTH)),
            ("msd", jdisc.MultiScaleDiscriminator(width=DISC_WIDTH),
             disc.MultiScaleDiscriminator(width=DISC_WIDTH))):
        want = _apply(jd, variables[name], jnp.asarray(real), jnp.asarray(fake))
        from_jax_variables(td, variables[name])
        with torch.no_grad():
            got = td(torch.from_numpy(real), torch.from_numpy(fake))
        assert len(got) == len(want)
        for g_pair, w_pair in zip(got, want):
            for (g_score, g_maps), (w_score, w_maps) in zip(g_pair, w_pair):
                assert _rel(g_score, w_score) <= REL, name
                for g, w in zip(g_maps, w_maps):
                    assert _rel(g.permute(0, *range(2, g.dim()), 1), w) <= REL, name


def _save_pt(tmp_path, family, seed=0):
    sd = _state(family, seed)
    if family == "gan_discriminators":
        env = chip_smoke.discriminator_envelope(torch, *sd)
    else:
        env = chip_smoke.fairseq_envelope(torch, sd)
    path = tmp_path / f"{family}{seed}.pt"
    torch.save(env, path)
    return str(path), sd


@pytest.mark.parametrize("family", ["vae", "diffusion", "nar", "gan_discriminators"])
def test_cli_convert_audits_the_envelope(tmp_path, family, capsys):
    """cli.convert_checkpoint on the released envelope: the inventory
    balances (JAX's audit on JAX's tree agrees), the step directory holds
    JAX's tree, and an existing output is not overwritten; a foreign key
    raises, named."""
    path, sd = _save_pt(tmp_path, family)
    out = tmp_path / "out"
    assert convert_checkpoint.main(["--type", family, "--input", path,
                                    "--output", str(out)]) == 0
    assert "key inventory balanced" in capsys.readouterr().err
    want = _flat(_convert(jcw, family, sd))
    got = _flat(load_variables(str(out))["params"] if family == "gan_discriminators"
                else load_variables(str(out)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        convert_checkpoint.main(["--type", family, "--input", path, "--output", str(out)])

    sds = list(sd) if family == "gan_discriminators" else [sd]
    trees = ([_convert(jcw, family, sd)[k] for k in ("mpd", "msd")]
             if family == "gan_discriminators" else [_convert(jcw, family, sd)])
    for one, tree in zip(sds, trees):
        assert cw.conversion_inventory(one, tree) == jcw.conversion_inventory(one, tree)
        foreign = dict(one)
        foreign["decoder_adapter.weight"] = torch.zeros(7, 9)
        with pytest.raises(ValueError, match="decoder_adapter"):
            cw.conversion_inventory(foreign, tree)
    env = torch.load(path, weights_only=False)
    if family == "gan_discriminators":
        env["msd"]["discriminators.0.convs.0.extra"] = torch.zeros(5, 3)
    else:
        env["model"]["encoder.extra_head.weight"] = torch.zeros(5, 3)
    torch.save(env, path)
    with pytest.raises(ValueError, match="extra"):
        convert_checkpoint.main(["--type", family, "--input", path,
                                 "--output", str(tmp_path / "out2")])
    assert not (tmp_path / "out2").exists()


@pytest.mark.parametrize("family", ["hifigan", "hubert"])
def test_cli_convert_hifigan_and_hubert(tmp_path, family, capsys):
    """The two families of earlier slices through cli.convert_checkpoint:
    the code-HiFi-GAN's `generator` entry (weight-norm pairs) and a HuBERT
    pretraining state dict in the released envelope, whose
    label_embs_concat, final_proj and mask_emb are the documented
    pretraining heads; the step directory holds JAX's tree, and reads as
    cli.generate_waveform's --vocoder and as HubertEncoder's weights."""
    from tests.test_torch_eval import VOC_CFG, fairseq_hifigan_state
    from tests.test_torch_prepare import SMALL, fairseq_state_dict

    out = tmp_path / "out"
    if family == "hifigan":
        sd = fairseq_hifigan_state(VOC_CFG, 3)
        (tmp_path / "cfg.json").write_text(json.dumps(VOC_CFG))
        torch.save({"generator": sd, "steps": 500000}, tmp_path / "g_00500000")
        argv = ["--input", str(tmp_path / "g_00500000"), "--vocoder-cfg",
                str(tmp_path / "cfg.json")]
        want = jcw.convert_hifigan_state(sd, VOC_CFG)
    else:
        sd = dict(fairseq_state_dict(3))
        sd["label_embs_concat"] = torch.zeros(12, 16)
        sd["final_proj.weight"], sd["final_proj.bias"] = torch.zeros(16, 64), torch.zeros(16)
        sd["mask_emb"] = torch.zeros(32)
        torch.save(chip_smoke.fairseq_envelope(torch, sd), tmp_path / "hubert.pt")
        argv = ["--input", str(tmp_path / "hubert.pt")]
        want = jcw.convert_hubert_state(sd, layers=2)
    assert convert_checkpoint.main(["--type", family, "--output", str(out), *argv]) == 0
    assert f"key inventory balanced ({family})" in capsys.readouterr().err
    got, want = _flat(load_variables(str(out))), _flat(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if family == "hifigan":
        from diffnorm_tpu_torch.cli.generate_waveform import load_vocoder

        load_vocoder(str(out), str(tmp_path / "cfg.json"), device="cpu")
    else:
        from diffnorm_tpu_torch.models.hubert import HubertEncoder
        from diffnorm_tpu_torch.weights import from_jax_params

        from_jax_params(HubertEncoder(**SMALL), load_variables(str(out))["params"])


@pytest.mark.parametrize("case", ["prompt_conditioned", "stacked_units", "hubert_ctc"])
def test_unported_layouts_raise_naming_their_roadmap_item(tmp_path, case):
    if case == "hubert_ctc":
        # ported since: the CLI's tree equals JAX's converter's bit for bit,
        # passes the audit (the pretraining heads left behind) and loads
        # into HubertCTCModule
        from diffnorm_tpu_torch.models.hubert import HubertCTCModule
        from diffnorm_tpu_torch.weights import from_jax_variables as load_into
        from tests.test_torch_prepare import SMALL as PREP_SMALL
        from tests.test_torch_prepare import fairseq_state_dict as hubert_state

        sd = {f"w2v_encoder.w2v_model.{k}": v for k, v in hubert_state(3).items()}
        sd["w2v_encoder.w2v_model.label_embs_concat"] = torch.zeros(12, 16)
        sd["w2v_encoder.proj.weight"] = torch.randn(9, 64,
                                                   generator=torch.Generator().manual_seed(0))
        sd["w2v_encoder.proj.bias"] = torch.zeros(9)
        torch.save(chip_smoke.fairseq_envelope(torch, sd), tmp_path / "ctc.pt")
        out = tmp_path / "out"
        assert convert_checkpoint.main(["--type", "hubert_ctc", "--input",
                                        str(tmp_path / "ctc.pt"), "--output", str(out)]) == 0
        got = _flat(load_variables(str(out)))
        want = _flat(jcw.convert_hubert_ctc_checkpoint(str(tmp_path / "ctc.pt"), layers=2))
        assert sorted(got) == sorted(want) and "proj/kernel" in "".join(got)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        load_into(HubertCTCModule(9, **PREP_SMALL), load_variables(str(out)))
        return
    if case == "prompt_conditioned":
        # ported since: the map equals JAX's bit for bit and passes the audit
        from tests.test_torch_prompt_cond import _fairseq_conditioned_state

        sd, _ = _fairseq_conditioned_state(3)
        got, want = _flat(cw.convert_diffusion_state(sd)), _flat(jcw.convert_diffusion_state(sd))
        assert sorted(got) == sorted(want) and "denoiser/null_prompt_cond" in got
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        cw.conversion_inventory(sd, cw.convert_diffusion_state(sd))
        return
    sd = dict(_state("nar"))
    # stacked units are ported: the map equals JAX's bit for bit and loads
    # into a stacked model; as JAX's, the audit counts the shared output
    # projection once and the tree holds it twice (table and subframe_out)
    gen = torch.Generator().manual_seed(3)
    sd["decoder.embed_tokens.project_in_dim.weight"] = torch.randn(32, 64, generator=gen)
    sd["decoder.out_proj_n_frames.weight"] = torch.randn(64, 32, generator=gen)
    got, want = _flat(cw.convert_nar_state(sd)), _flat(jcw.convert_nar_state(sd))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert "params/decoder/embed_tokens/project_in_dim/kernel" in got
    from_jax_variables(NARS2UTModule(n_frames_per_step=2, **NAR_PORT),
                       cw.convert_nar_state(sd))
    for module in (cw, jcw):
        with pytest.raises(ValueError, match="inventory mismatch"):
            module.conversion_inventory(sd, module.convert_nar_state(sd))


# ---- the converted step directory feeds the port's CLIs ----

NAR_FLAGS = ["--target-code-size", "20", "--encoder-embed-dim", "32",
             "--encoder-ffn-embed-dim", "64", "--encoder-layers", "2",
             "--encoder-attention-heads", "2", "--decoder-layers", "2",
             "--decoder-attention-heads", "2", "--conv-channels", "32",
             "--depthwise-conv-kernel-size", "7"]
JAX_NAR_CFG = dict(task="speech_to_speech_fasttranslate", arch="nar_s2ut_conformer",
                   criterion="nar_speech_to_unit", encoder_layers=2, decoder_layers=2,
                   encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_attention_heads=2,
                   decoder_attention_heads=2, decoder_embed_dim=32, decoder_ffn_embed_dim=64,
                   conv_channels=32, depthwise_conv_kernel_size=7, target_code_size=20,
                   label_smoothing=0.2)
DIFF_FLAGS = ["--hidden-dim", "16", "--latent-dim", "3", "--feature-dim", "24",
              "--timesteps", "20", "--denoiser-depth", "1", "--wavenet-layers", "2",
              "--wavenet-stacks", "1", "--vae-decoder-depth", "1", "--vae-decoder-dim-head",
              "8", "--vae-decoder-heads", "2", "--chan-mults", "[4]"]


def _npy_corpus(root: Path, splits=("test",), n=5, seed=0):
    """.npy fbank sources with 3-11 unit targets of the 20-unit vocabulary,
    and a config.yaml with utterance CMVN."""
    from diffnorm_tpu_torch.data.manifest import write_translation_manifest

    rng = np.random.default_rng(seed)
    for split in splits:
        rows = []
        for i in range(n):
            t = int(rng.integers(36, 60))
            np.save(root / f"{split}{i}.npy", rng.normal(size=(t, 80)).astype(np.float32))
            units = rng.integers(0, 20, size=t // 6 + 2)
            rows.append({"id": f"{split}{i}", "src_audio": f"{split}{i}.npy", "src_n_frames": t,
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    (root / "config.yaml").write_text(yaml.safe_dump({
        "input_feat_per_channel": 80, "transforms": {"*": ["utterance_cmvn"]}}))


def _feature_corpus(root: Path, n=6, seed=0, codes=16, feat_dim=24):
    """{split}.tsv unit manifests and feat/{split}.manifest.tsv + .npy
    features (the VAE, normalizer and synthesis layout)."""
    from diffnorm_tpu_torch.data.manifest import write_translation_manifest

    rng = np.random.default_rng(seed)
    feat_dir = root / "feat"
    feat_dir.mkdir(parents=True, exist_ok=True)
    for split in ("train", "dev", "test"):
        rows, lines = [], [str(feat_dir)]
        for i in range(n):
            t = int(rng.integers(6, 12))
            units = np.repeat(rng.integers(0, codes, size=t), rng.integers(1, 3, size=t))
            name = f"{split}{i}"
            np.save(feat_dir / f"{name}.feat.npy",
                    rng.normal(size=(len(units), feat_dim)).astype(np.float32))
            lines.append(f"{name}.feat.npy\t{len(units)}")
            rows.append({"id": name, "src_audio": f"{name}.wav", "src_n_frames": len(units),
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
        (feat_dir / f"{split}.manifest.tsv").write_text("\n".join(lines) + "\n")
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
    return feat_dir


def test_converted_directories_feed_generate_and_synthesis(tmp_path):
    """cli.generate --path and cli.diff_norm_synthesis --ckpt on
    cli.convert_checkpoint's step directories write what they write from a
    save_npz file of JAX's converter tree."""
    from diffnorm_tpu_torch.cli import diff_norm_synthesis, generate

    _npy_corpus(tmp_path)
    feat_dir = _feature_corpus(tmp_path / "feat_corpus")
    for family in ("nar", "diffusion"):
        path, sd = _save_pt(tmp_path, family)
        assert convert_checkpoint.main(["--type", family, "--input", path, "--output",
                                        str(tmp_path / f"{family}_dir")]) == 0
        save_npz(str(tmp_path / f"{family}.npz"), _convert(jcw, family, sd))
    outs = []
    for weights in ("nar_dir", "nar.npz"):
        out = tmp_path / f"gen_{weights}"
        assert generate.main([str(tmp_path), "--cpu", "--path", str(tmp_path / weights),
                              "--gen-subset", "test", "--max-tokens", "120",
                              "--max-target-positions", "16", "--iter-decode-max-iter", "3",
                              "--results-path", str(out), *NAR_FLAGS]) == 0
        outs.append((out / "generate-test.txt").read_text())
    assert outs[0] == outs[1] and outs[0].count("H-") == 5
    outs = []
    for flag, weights in (("--ckpt", "diffusion_dir"), ("--params-npz", "diffusion.npz")):
        out = tmp_path / f"norm_{weights}"
        assert diff_norm_synthesis.main([
            str(tmp_path / "feat_corpus"), flag, str(tmp_path / weights), "--tgt-feat-dir",
            str(feat_dir), "--output-dir", str(out), "--splits", "test", "--cpu",
            "--start-step", "6", "--vocab-size", "20", *DIFF_FLAGS]) == 0
        outs.append((out / "test.tsv").read_text())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 7


def test_average_checkpoints_matches_jax(tmp_path, capsys):
    """cli.average_checkpoints over three step directories against JAX's
    average_checkpoints over the same trees as orbax checkpoints, leaf for
    leaf, batch statistics included."""
    import orbax.checkpoint as ocp

    from diffnorm_tpu.cli.average_checkpoints import average_checkpoints as jax_average
    from diffnorm_tpu_torch.cli import average_checkpoints

    ckptr = ocp.StandardCheckpointer()
    paths, jpaths = [], []
    for seed in range(3):
        tree = cw.convert_nar_state(_state("nar", seed))
        paths.append(str(tmp_path / f"step{seed}"))
        os.makedirs(paths[-1])
        save_npz(os.path.join(paths[-1], "params.npz"), tree)
        jpaths.append(str(tmp_path / f"orbax{seed}"))
        ckptr.save(jpaths[-1], tree)
    ckptr.wait_until_finished()
    want = _flat(jax.device_get(jax_average(jpaths)))
    assert average_checkpoints.main(["--inputs", *paths, "--output",
                                     str(tmp_path / "avg")]) == 0
    assert "averaged 3 checkpoints" in capsys.readouterr().out
    got = _flat(load_variables(str(tmp_path / "avg")))
    assert sorted(got) == sorted(want) and len(got) > 50
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    with pytest.raises(ValueError, match="does not hold the tree"):
        save_npz(str(tmp_path / "vae.npz"), {"params": cw.convert_vae_state(_state("vae"))})
        average_checkpoints.average_checkpoints([paths[0], str(tmp_path / "vae.npz")])


def _bridge_module():
    spec = importlib.util.spec_from_file_location("orbax_to_npz",
                                                  REPO / "scripts" / "orbax_to_npz.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("layout", ["train_state", "variables"])
def test_orbax_bridge(tmp_path, layout, capsys):
    """scripts/orbax_to_npz.py on a TrainState saved by JAX's
    CheckpointManager (its frozen subtree folded back) and on a bare
    StandardCheckpointer variables tree (a bf16 leaf widened): load_variables
    equals restored_to_variables(load_checkpoint_params(...)) leaf for leaf.
    On the TrainState, the port's cli.generate on the bridged directory
    writes JAX's generate-test.txt from the orbax one."""
    import optax
    import orbax.checkpoint as ocp

    from diffnorm_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
    from diffnorm_tpu.train.checkpoint import load_checkpoint_params, restored_to_variables
    from diffnorm_tpu.train.trainer import TrainState

    variables = cw.convert_nar_state(_state("nar", 4))
    if layout == "train_state":
        params = variables["params"]
        state = TrainState(step=jnp.asarray(7, jnp.int32), params={"decoder": params["decoder"]},
                           frozen_params={"encoder": params["encoder"]},
                           model_state={"batch_stats": variables["batch_stats"]},
                           opt_state=optax.adam(1e-3).init({"decoder": params["decoder"]}))
        manager = JCheckpointManager(str(tmp_path / "jax_ckpt"))
        manager.save(7, state, blocking=True)
        ckpt = str(tmp_path / "jax_ckpt" / "step_000000007")
    else:
        tree = jax.tree_util.tree_map(jnp.asarray, variables)
        tree["params"]["encoder"]["linear"]["bias"] = tree["params"]["encoder"]["linear"][
            "bias"].astype(jnp.bfloat16)
        ckpt = str(tmp_path / "orbax_vars")
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(ckpt, tree)
        ckptr.wait_until_finished()
    bridge = _bridge_module()
    out = tmp_path / "bridged"
    assert bridge.main([ckpt, str(out)]) == 0
    assert "wrote" in capsys.readouterr().out
    want = _flat(jax.device_get(restored_to_variables(load_checkpoint_params(ckpt))))
    got = _flat(load_variables(str(out)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)
    if layout == "variables":
        bias = got["params/encoder/linear/bias"]
        np.testing.assert_array_equal(
            bias, np.asarray(variables["params"]["encoder"]["linear"]["bias"]).astype(
                jnp.bfloat16).astype(np.float32))
        return

    from diffnorm_tpu.cli import generate as jax_generate
    from diffnorm_tpu.config import Config
    from diffnorm_tpu_torch.cli import generate
    from tests.test_torch_eval import _assert_generate_files_agree, _generate_lines

    _npy_corpus(tmp_path)
    assert jax_generate.main(Config(
        data=str(tmp_path), path=ckpt, cpu=True, gen_subset="test", max_tokens=120,
        max_target_positions=16, iter_decode_max_iter=3, results_path=str(tmp_path / "jax"),
        **JAX_NAR_CFG)) == 0
    assert generate.main([str(tmp_path), "--cpu", "--path", str(out), "--gen-subset", "test",
                          "--max-tokens", "120", "--max-target-positions", "16",
                          "--iter-decode-max-iter", "3", "--results-path",
                          str(tmp_path / "port"), *NAR_FLAGS]) == 0
    _assert_generate_files_agree(_generate_lines(tmp_path / "port" / "generate-test.txt"),
                                 _generate_lines(tmp_path / "jax" / "generate-test.txt"))


# ---- cli.validate against JAX's, one test per task ----

VAE_CFG = dict(feature_dim=24, latent_dim=3, chan_mults=[4], vae_decoder_depth=1,
               vae_decoder_dim_head=8, vae_decoder_heads=2, target_code_size=16)
VALID = {  # task: (JAX config, the port's flags)
    "speech_decoder": (dict(arch="speech_vae_decoder", criterion="speech_vae_decoder_loss",
                            **VAE_CFG),
                       ["--feature-dim", "24", "--latent-dim", "3", "--chan-mults", "[4]",
                        "--vae-decoder-depth", "1", "--vae-decoder-dim-head", "8",
                        "--vae-decoder-heads", "2", "--target-code-size", "16"]),
    "speech_diffusion_discrete": (
        dict(arch="diff_discrete", criterion="ddpm_discrete_loss", hidden_dim=16, timesteps=20,
             denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1, **VAE_CFG),
        ["--target-code-size", "16", *[f for f in DIFF_FLAGS]]),
    "speech_to_speech_fasttranslate": (
        dict({k: v for k, v in JAX_NAR_CFG.items() if k != "task"}, config_yaml="config.yaml"),
        ["--config-yaml", "config.yaml", *NAR_FLAGS]),
}


def _with_draws(inner, diffusion: bool):
    """`inner` (a task's prepare_batch) with the criterion's draws injected,
    seeded by the batch's ids, so JAX's valid step and the port's see the
    same draws: the VAE's posterior eps, or the normalizer's times and
    noises."""
    def prepare_batch(self, batch, rng):
        batch = dict(inner(self, batch, rng))
        draws = np.random.default_rng(int(np.asarray(batch["id"]).astype(np.int64).sum()))
        b, t = np.asarray(batch["reduce_target"]).shape[:2]
        if diffusion:
            batch["inject_times"] = draws.integers(1, 20, size=b).astype(np.int32)
            for key in ("enc_noise", "x1_noise", "q_noise"):
                batch[f"inject_{key}"] = draws.normal(size=(b, t, 3)).astype(np.float32)
        else:
            batch["posterior_noise"] = draws.normal(size=(b, t, 3)).astype(np.float32)
        return batch
    return prepare_batch


@pytest.mark.parametrize("task", sorted(VALID))
def test_cli_validate_matches_jax(tmp_path, task, monkeypatch, capsys):
    """JAX's cli.validate on a TrainState checkpoint its Trainer made (biases
    and scales perturbed) and the port's on the same checkpoint through
    scripts/orbax_to_npz.py, over the dev split: the same metrics within
    1e-5 relative (float32, the same functions summed in other orders)."""
    from diffnorm_tpu.cli import validate as jax_validate
    from diffnorm_tpu.config import Config, make_trainer_config
    from diffnorm_tpu.registry import TASKS as JTASKS
    from diffnorm_tpu.train import metrics as jmetrics
    from diffnorm_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
    from diffnorm_tpu.train.trainer import Trainer as JTrainer
    from diffnorm_tpu_torch.cli import validate
    from diffnorm_tpu_torch.tasks import TASKS

    jax_cfg, flags = VALID[task]
    if task == "speech_to_speech_fasttranslate":
        _npy_corpus(tmp_path, splits=("dev",), n=6)
        data = dict(data=str(tmp_path))
        port_data = [str(tmp_path)]
    else:
        feat_dir = _feature_corpus(tmp_path)
        data = dict(data=str(tmp_path), tgt_feat_dir=str(feat_dir))
        port_data = [str(tmp_path), "--tgt-feat-dir", str(feat_dir)]
        for cls in (JTASKS.get(task), TASKS[task]):
            monkeypatch.setattr(cls, "prepare_batch", _with_draws(
                cls.prepare_batch, task == "speech_diffusion_discrete"))
    cfg = Config(task=task, cpu=True, valid_subset="dev", max_tokens=60, seed=1, **data,
                 **jax_cfg)
    jtask = JTASKS.get(task).setup_task(cfg)
    jtrainer = JTrainer(make_trainer_config(cfg), jtask, jtask.build_model(),
                        jtask.build_criterion())
    ds = jtask.dataset("dev")
    example = jtask.prepare_batch(ds.collater([ds[0]]), np.random.default_rng(1))
    state = jax.device_get(jtrainer.init_state(jax.random.PRNGKey(1), example))
    rng = np.random.default_rng(2)
    state = state.replace(**{
        key: jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32)
            * (a.ndim == 1), getattr(state, key))
        for key in ("params", "frozen_params")})
    JCheckpointManager(str(tmp_path / "jax_ckpt")).save(1, state, blocking=True)
    ckpt = str(tmp_path / "jax_ckpt" / "step_000000001")

    seen = []
    smoothed = jmetrics.MetricsAggregator.get_smoothed_values
    monkeypatch.setattr(jmetrics.MetricsAggregator, "get_smoothed_values",
                        lambda self: seen.append(smoothed(self)) or seen[-1])
    assert jax_validate.main(Config(path=ckpt, **dict(cfg))) == 0
    want = seen[-1]
    _bridge_module().main([ckpt, str(tmp_path / "bridged")])
    args = validate.parse_args([*port_data, "--task", task, "--cpu", "--valid-subset", "dev",
                                "--max-tokens", "60", "--seed", "1", "--path",
                                str(tmp_path / "bridged"), *flags])
    got = validate.validate(args)
    assert set(got) == set(want) and want["nsentences"] == 6
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert validate.main([*port_data, "--task", task, "--cpu", "--valid-subset", "dev",
                          "--max-tokens", "60", "--path", str(tmp_path / "bridged"),
                          *flags]) == 0
    assert "dev | " in capsys.readouterr().err


# ---- cli.train --restore-file ----

def _train_args(data, feat_dir, save_dir, task, max_update, extra=()):
    sizes = ["--feature-dim", "24", "--latent-dim", "3", "--chan-mults", "[4]",
             "--vae-decoder-depth", "1", "--vae-decoder-dim-head", "8",
             "--vae-decoder-heads", "2"]
    if task == "speech_diffusion_discrete":
        sizes = [*DIFF_FLAGS, "--multitask", "true"]
    return [str(data), "--tgt-feat-dir", str(feat_dir), "--task", task, "--cpu",
            "--target-code-size", "16", "--dropout", "0.1", "--save-dir", str(save_dir),
            "--keep-last-epochs", "5", "--lr", "5e-4", "--warmup-updates", "2",
            "--max-update", str(max_update), "--max-tokens", "40", "--seed", "42",
            "--log-interval", "1", *sizes, *extra]


def _record_first_update(monkeypatch):
    """Record the master variables, update count and Adam count the first
    train_step of each trainer starts from."""
    from diffnorm_tpu_torch.train.trainer import Trainer
    from diffnorm_tpu_torch.weights import to_jax_variables

    seen = []
    step = Trainer.train_step

    def train_step(self, batches):
        if not getattr(self, "_recorded", False):
            self._recorded = True
            # copies: on the CPU the arrays share the parameters' memory
            seen.append(({k: v.copy() for k, v in _flat(to_jax_variables(self.master)).items()},
                         self.num_updates, self.optimizer.count))
        return step(self, batches)

    monkeypatch.setattr(Trainer, "train_step", train_step)
    return seen


def test_restore_file_reset_optimizer_takes_the_files_weights(tmp_path, monkeypatch, capsys):
    """--restore-file D --reset-optimizer with D a cli.convert_checkpoint
    directory: the first update starts from exactly D's weights (the
    normalizer's frozen VAE too, over --speech-decoder-ckpt's), the
    optimizer at step 0; a file without a trainable subtree raises, and so
    does D without --reset-optimizer (it holds no trainer state)."""
    from diffnorm_tpu_torch.cli import train as train_cli

    feat_dir = _feature_corpus(tmp_path)
    seen = _record_first_update(monkeypatch)
    for family, task in (("vae", "speech_decoder"),
                         ("diffusion", "speech_diffusion_discrete")):
        path, _ = _save_pt(tmp_path, family, seed=5)
        conv = tmp_path / f"{family}_dir"
        assert convert_checkpoint.main(["--type", family, "--input", path,
                                        "--output", str(conv)]) == 0
        extra = ["--restore-file", str(conv), "--reset-optimizer"]
        if family == "diffusion":
            extra += ["--speech-decoder-ckpt", str(tmp_path / "vae_dir")]
        assert train_cli.main(_train_args(tmp_path, feat_dir, tmp_path / f"run_{family}",
                                          task, 1, extra)) == 0
        assert f"warm-started params from {conv} (optimizer reset)" in capsys.readouterr().err
        variables, updates, adam = seen[-1]
        assert updates == 0 and adam == 0
        want, got = _flat(load_variables(str(conv))), variables
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(ValueError, match="lacks param subtrees"):
        train_cli.main(_train_args(tmp_path, feat_dir, tmp_path / "run_bad",
                                   "speech_diffusion_discrete", 1,
                                   ["--restore-file", str(tmp_path / "vae_dir"),
                                    "--reset-optimizer"]))
    with pytest.raises(ValueError, match="no trainer state"):
        train_cli.main(_train_args(tmp_path, feat_dir, tmp_path / "run_bad2", "speech_decoder",
                                   1, ["--restore-file", str(tmp_path / "vae_dir")]))


def test_restore_file_carries_the_trainer_state(tmp_path, monkeypatch, capsys):
    """--restore-file with a step directory of this CLI (no reset): the step,
    the moments, the epoch and the iterator position carry over, and the
    run's updates are bit-equal to the original run resumed from its own
    directory. A run that has its own checkpoint ignores --restore-file;
    --reset-dataloader starts the epoch over."""
    from diffnorm_tpu_torch.cli import train as train_cli

    feat_dir = _feature_corpus(tmp_path)
    seen = _record_first_update(monkeypatch)
    run = tmp_path / "run"
    assert train_cli.main(_train_args(tmp_path, feat_dir, run, "speech_decoder", 2)) == 0
    step2 = run / "step_000000002"
    sidecar = json.loads((run / "step_000000002.json").read_text())
    capsys.readouterr()
    assert train_cli.main(_train_args(tmp_path, feat_dir, tmp_path / "warm", "speech_decoder",
                                      4, ["--restore-file", str(step2)])) == 0
    log = capsys.readouterr().err
    assert f"restored {step2} at step 2" in log
    assert f"epoch {sidecar['epoch']} | step 3 |" in log
    _, updates, adam = seen[-1]
    assert updates == 2 and adam == 2
    assert train_cli.main(_train_args(tmp_path, feat_dir, run, "speech_decoder", 4,
                                      ["--restore-file", str(tmp_path / "absent")])) == 0
    assert "resumed from step 2" in capsys.readouterr().err
    want = _flat(load_variables(str(run / "step_000000004")))
    got = _flat(load_variables(str(tmp_path / "warm" / "step_000000004")))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert train_cli.main(_train_args(tmp_path, feat_dir, tmp_path / "reset", "speech_decoder",
                                      3, ["--restore-file", str(step2),
                                          "--reset-dataloader"])) == 0
    assert "epoch 1 | step 3 |" in capsys.readouterr().err
