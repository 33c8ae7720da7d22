"""--target-speaker-embed and the multi-speaker code-HiFi-GAN in the port
against the JAX package on the CPU, float32, at tiny widths (the sizes of
tests/test_torch_s2st.py; speaker embeddings of 16): the dataset's speaker
join, the speaker-conditioned encoder, a training update and the decode,
the multi-speaker generator and `s2st_generate(spkr=, tgt_speaker=)`, then
cli.train -> cli.generate with --target-speaker-embed and
--n-frames-per-step 2 against JAX's cli.generate on the trained weights. It
mirrors tests/test_tgt_speaker_regressions.py:77,232. Shared weights go
through `weights.from_jax_variables`; inputs come from numpy seeds."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffnorm_tpu.config import Config, make_trainer_config
from diffnorm_tpu.criterions.nar_loss import NARSpeechToUnitLoss as JNARLoss
from diffnorm_tpu.data import encoders as jencoders
from diffnorm_tpu.data.dictionary import Dictionary as JDictionary
from diffnorm_tpu.data.s2s_dataset import SpeechToUnitDataset as JSpeechToUnitDataset
from diffnorm_tpu.generate.mask_predict import mask_predict_decode as jax_mask_predict
from diffnorm_tpu.generate.s2st import s2st_generate as jax_s2st_generate
from diffnorm_tpu.models.hifigan import CodeGenerator as JCodeGenerator
from diffnorm_tpu.models.nar_transformer import NARS2UTModule as JNARS2UTModule
from diffnorm_tpu.parallel.mesh import make_mesh
from diffnorm_tpu.registry import TASKS as JTASKS
from diffnorm_tpu.train.trainer import Trainer as JTrainer
from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
from diffnorm_tpu_torch.data.dictionary import Dictionary
from diffnorm_tpu_torch.data.manifest import write_translation_manifest
from diffnorm_tpu_torch.data.s2s_dataset import SpeechToUnitDataset
from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
from diffnorm_tpu_torch.generate.s2st import s2st_generate
from diffnorm_tpu_torch.models.hifigan import CodeGenerator, CodeHiFiGANVocoder
from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.train.trainer import Trainer
from diffnorm_tpu_torch.weights import from_jax_variables
from tests.test_torch_eval import _assert_generate_files_agree, _generate_lines
from tests.test_torch_nar_train import TRAJ_RTOL, _trainer_cfg
from tests.test_torch_s2st import NAR, VOC, VOCAB, _perturb, _src
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

SPK_DIM = 16
FWD_TOL = 1e-5  # float32, the same sums in other orders
NAR1 = dict(NAR, encoder_layers=1, decoder_layers=1)


def write_speaker_corpus(root, seed=0, splits=(("train", 6), ("dev", 2), ("test", 4))):
    """.npy fbank sources of 36-80 frames with 4-15 units of 16 codes, a
    speaker directory (one 16-d embedding .npy per utterance, joined by id
    from its {split}.tsv, the paths relative to it) and a config.yaml that
    names it."""
    rng = np.random.default_rng(seed)
    (root / "spk").mkdir()
    for split, n in splits:
        rows, spk = [], ["id\tspeaker_embed"]
        for i in range(n):
            uid = f"{split}{i}"
            t = int(rng.integers(36, 81))
            np.save(root / f"{uid}.npy", rng.normal(size=(t, 80)).astype(np.float32))
            units = rng.integers(0, 16, size=int(rng.integers(4, 16)))
            rows.append({"id": uid, "src_audio": f"{uid}.npy", "src_n_frames": t,
                         "tgt_audio": " ".join(map(str, units)), "tgt_n_frames": len(units)})
            np.save(root / "spk" / f"{uid}.npy",
                    rng.normal(size=(SPK_DIM,)).astype(np.float32))
            spk.append(f"{uid}\t{uid}.npy")
        write_translation_manifest(str(root / f"{split}.tsv"), rows)
        (root / "spk" / f"{split}.tsv").write_text("\n".join(spk) + "\n")
    (root / "config.yaml").write_text(yaml.safe_dump({
        "input_feat_per_channel": 80, "target_speaker_embed": "spk"}))


def test_dataset_speaker_join_matches_jax(tmp_path):
    """Items and the collated batch (tgt_speaker [B, 16] in the batch's
    order) equal JAX's; the embedding of each row is its utterance's file."""
    write_speaker_corpus(tmp_path)
    ours = SpeechToUnitDataset.from_tsv(str(tmp_path), "train", Dictionary(16))
    theirs = JSpeechToUnitDataset.from_tsv(str(tmp_path), "train",
                                           JDictionary.unit_dictionary(16))
    got = ours.collater([ours[i] for i in range(4)])
    want = theirs.collater([theirs[i] for i in range(4)])
    for key in ("id", "src_tokens", "src_lengths", "target", "tgt_speaker"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["tgt_speaker"].shape == (4, SPK_DIM) and got["tgt_speaker"].dtype == np.float32
    for row, index in enumerate(got["id"]):
        np.testing.assert_array_equal(
            got["tgt_speaker"][row], np.load(tmp_path / "spk" / f"train{index}.npy"))


@pytest.fixture(scope="module")
def speaker_nar():
    """A speaker-conditioned JAX NAR model (perturbed variables, embeddings
    of 16) and the port's on them."""
    kw = dict(vocab_size=VOCAB, target_speaker_embed=True, speaker_embed_dim=SPK_DIM, **NAR1)
    jm = JNARS2UTModule(**kw)
    src, lengths = _src(0)
    spk = np.random.default_rng(5).normal(size=(2, SPK_DIM)).astype(np.float32)
    variables = jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a, tgt_speaker=spk))(
        src, lengths, np.full((2, 12), 4, np.int32))
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(1))
    assert "spk_emb_proj" in variables["params"]
    return jm, variables, from_jax_variables(NARS2UTModule(**kw), variables).eval()


def test_speaker_conditioned_encoder_and_decode_match_jax(speaker_nar):
    """encode(tgt_speaker=) within 1e-5 of JAX's and different from the
    unconditioned output; mask_predict_decode (length beam 3) with per-row
    embeddings: tokens and n_steps equal, scores within 1e-4."""
    jm, variables, tm = speaker_nar
    src, lengths = _src(3, b=3)
    spk = np.random.default_rng(6).normal(size=(3, SPK_DIM)).astype(np.float32)
    ref, _ = jax.jit(lambda v, s, n, k: jm.apply(v, s, n, method="encode", tgt_speaker=k))(
        variables, src, lengths, spk)
    with torch.no_grad():
        enc, _ = tm.encode(torch.from_numpy(src), torch.from_numpy(lengths),
                           tgt_speaker=torch.from_numpy(spk))
        plain, _ = tm.encode(torch.from_numpy(src), torch.from_numpy(lengths))
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref), rtol=FWD_TOL, atol=FWD_TOL)
    assert enc.shape == plain.shape and not torch.allclose(enc, plain)
    kw = dict(max_iter=4, max_len=16, length_beam=3)
    want = jax.jit(lambda v, s, n, k: jax_mask_predict(
        types.SimpleNamespace(module=jm), v, s, n, tgt_speaker=k, **kw))(
            variables, src, lengths, spk)
    got = mask_predict_decode(tm, torch.from_numpy(src), torch.from_numpy(lengths),
                              tgt_speaker=torch.from_numpy(spk), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    assert (np.asarray(want[0]) >= 4).sum() >= 6


def test_speaker_training_update_matches_jax(tmp_path):
    """One float32 update of JAX's Trainer with its task (target_speaker_embed,
    the dataset's tgt_speaker) and of the port's from one initialization:
    loss and gradient norm within 1e-4 relative, and spk_emb_proj moved."""
    write_speaker_corpus(tmp_path)
    cfg = Config(arch="nar_s2ut_conformer", criterion="nar_speech_to_unit", data=str(tmp_path),
                 dropout=0.0, label_smoothing=0.2, lr=5e-4, warmup_updates=4, clip_norm=10.0,
                 target_code_size=16, target_speaker_embed=True, speaker_embed_dim=SPK_DIM,
                 encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
                 encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
                 conv_channels=32, depthwise_conv_kernel_size=7)
    jtask = JTASKS.get("speech_to_speech_fasttranslate").setup_task(cfg)
    ds = jtask.dataset("train")
    batch = jtask.prepare_batch(ds.collater([ds[i] for i in range(4)]),
                                np.random.default_rng(0))
    jtrainer = JTrainer(make_trainer_config(cfg), jtask, jtask.build_model(),
                        JNARLoss(cfg, jtask), mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    state = jtrainer.init_state(jax.random.PRNGKey(0), batch)
    init = {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.model_state["batch_stats"])}
    state, ref = jtrainer.train_step(state, [batch], jax.random.PRNGKey(1))
    model = from_jax_variables(NARS2UTModule(
        vocab_size=20, dropout=0.0, target_speaker_embed=True, speaker_embed_dim=SPK_DIM,
        encoder_dim=32, encoder_ffn_dim=64, encoder_layers=1, encoder_heads=2, decoder_dim=32,
        decoder_ffn_dim=64, decoder_layers=1, decoder_heads=2, depthwise_kernel_size=7,
        conv_channels=32), init)
    before = model.spk_emb_proj.weight.detach().clone()
    got = Trainer(_trainer_cfg(), model, NARSpeechToUnitLoss(0.2)).train_step([batch])
    for key in ("loss", "gnorm", "nll_loss"):
        np.testing.assert_allclose(got[key], ref[key], rtol=TRAJ_RTOL, err_msg=key)
    np.testing.assert_allclose(model.spk_emb_proj.weight.detach().numpy(),
                               np.asarray(state.params["spk_emb_proj"]["kernel"]).T,
                               atol=1e-6)
    assert not torch.equal(model.spk_emb_proj.weight, before)


VOC_SPK = dict(VOC, num_speakers=3)


@pytest.fixture(scope="module")
def speaker_vocoder():
    jv = JCodeGenerator(**VOC_SPK)

    def init_all(m, c, s):
        out = m(c, s)
        m.predict_durations(c)
        return out

    variables = jv.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
                        jnp.zeros((1,), jnp.int32), method=init_all)
    variables = _perturb(jax.device_get(dict(variables)), np.random.default_rng(2))
    assert variables["params"]["spkr"]["embedding"].shape == (3, VOC["embedding_dim"])
    return jv, variables, from_jax_variables(CodeGenerator(**VOC_SPK), variables).eval()


def test_multi_speaker_generator_matches_jax(speaker_vocoder):
    """The speaker's row concatenated to every unit embedding: the waveform
    within JAX's vocoder tolerance (tests/test_torch_s2st.py), different per
    speaker; from_config builds it from a multispkr config; without speaker
    ids it raises."""
    jv, variables, tv = speaker_vocoder
    code = np.random.default_rng(7).integers(0, 20, size=(3, 13)).astype(np.int32)
    spkr = np.asarray([0, 2, 1], np.int32)
    want = np.asarray(jv.apply(variables, jnp.asarray(code), jnp.asarray(spkr)))
    with torch.no_grad():
        got = tv(torch.from_numpy(code).long(), torch.from_numpy(spkr).long())
        other = tv(torch.from_numpy(code).long(), torch.from_numpy(spkr[::-1].copy()).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    assert not torch.allclose(got[0], other[0])
    with pytest.raises(ValueError, match="speaker"):
        tv(torch.from_numpy(code).long())
    cfg = dict(num_embeddings=20, embedding_dim=8, upsample_rates=[2, 2],
               upsample_kernel_sizes=[4, 4], upsample_initial_channel=16,
               resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
               dur_predictor_params={"var_pred_hidden_dim": 8}, multispkr=True, num_speakers=3)
    voc = CodeHiFiGANVocoder.from_config(cfg, variables=variables, device="cpu")
    with torch.no_grad():
        np.testing.assert_array_equal(voc.module(torch.from_numpy(code).long(),
                                                 torch.from_numpy(spkr).long()).numpy(),
                                      got.numpy())


def test_s2st_generate_with_speakers_matches_jax(speaker_nar, speaker_vocoder):
    """s2st_generate(spkr=, tgt_speaker=) over 3 rows in vocoder chunks of 2
    (a partial last chunk): lengths, reduced units, counts and iterations
    equal, the waveform within the vocoder tolerance."""
    jm, nar_vars, tm = speaker_nar
    jv, voc_vars, tv = speaker_vocoder
    src, lengths = _src(9, b=3)
    spk = np.random.default_rng(8).normal(size=(3, SPK_DIM)).astype(np.float32)
    spkr = np.asarray([2, 0, 1], np.int32)
    kw = dict(max_iter=4, max_len=16, max_duration=3, vocoder_chunk=2, return_steps=True)
    want = jax.jit(lambda v, vv, s, n, k, r: jax_s2st_generate(
        types.SimpleNamespace(module=jm), v, jv, vv, s, n, tgt_speaker=k, spkr=r, **kw))(
            nar_vars, voc_vars, src, lengths, spk, spkr)
    got = s2st_generate(tm, tv, torch.from_numpy(src), torch.from_numpy(lengths),
                        tgt_speaker=torch.from_numpy(spk), spkr=torch.from_numpy(spkr).long(),
                        **kw)
    wav, wav_lengths, units, counts, steps = (np.asarray(w) for w in want)
    assert counts.max() >= 2
    for g, w in zip(got[1:], (wav_lengths, units, counts, steps)):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_allclose(got[0].numpy(), wav, atol=1e-5, rtol=1e-4)


# ---- cli.train -> cli.generate, stacked and speaker-conditioned ----

WIDTHS = dict(encoder_embed_dim=32, encoder_ffn_embed_dim=64, encoder_layers=1,
              encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
              conv_channels=32, depthwise_conv_kernel_size=7)
OPTIONS = dict(target_code_size=16, n_frames_per_step=2, target_speaker_embed=True,
               speaker_embed_dim=SPK_DIM)


def _flags(values):
    out = []
    for k, v in values.items():
        out += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return out


def test_cli_train_generate_with_speaker_and_stacked_units_match_jax(tmp_path):
    """cli.train with --target-speaker-embed --n-frames-per-step 2 (2
    updates and a checkpoint); cli.generate on the step directory and JAX's
    cli.generate on the same weights (an orbax checkpoint): generate-test.txt
    equal line for line (tokens equal, scores within 2e-4), full-rate H-
    units; the checkpoint holds spk_emb_proj and the stacked decoder's
    projections. A third run with --post-process letter writes JAX's
    post_process of the references and hypotheses in its T- and D- lines."""
    import orbax.checkpoint as ocp

    from diffnorm_tpu.cli import generate as jax_generate
    from diffnorm_tpu_torch.cli import generate, train

    write_speaker_corpus(tmp_path)
    save_dir = tmp_path / "ckpt"
    assert train.main([str(tmp_path), "--cpu", "--task", "speech_to_speech_fasttranslate",
                       "--arch", "nar_s2ut_conformer", "--criterion", "nar_speech_to_unit",
                       "--save-dir", str(save_dir), "--max-update", "2", "--max-tokens", "240",
                       "--lr", "1e-3", "--warmup-updates", "2", "--log-interval", "1",
                       "--seed", "3", "--validate-interval", "5",
                       *_flags(WIDTHS), *_flags(OPTIONS)]) == 0
    step = save_dir / "step_000000002"
    variables = load_variables(str(step))
    params = variables["params"]
    assert "spk_emb_proj" in params and "out_proj_n_frames" in params["decoder"]
    assert "project_in_dim" in params["decoder"]["embed_tokens"]
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "jax_ck"), variables)
    ckptr.wait_until_finished()

    out = tmp_path / "gen"
    assert jax_generate.main(Config(
        task="speech_to_speech_fasttranslate", arch="nar_s2ut_conformer",
        data=str(tmp_path), path=str(tmp_path / "jax_ck"), cpu=True, gen_subset="test",
        max_tokens=240, max_target_positions=12, iter_decode_max_iter=3,
        results_path=str(out / "jax"), **WIDTHS, **OPTIONS)) == 0
    assert generate.main([str(tmp_path), "--cpu", "--path", str(step), "--gen-subset", "test",
                          "--max-tokens", "240", "--max-target-positions", "12",
                          "--iter-decode-max-iter", "3", "--results-path", str(out / "port"),
                          *_flags(WIDTHS), *_flags(OPTIONS)]) == 0
    want = _generate_lines(out / "jax" / "generate-test.txt")
    got = _generate_lines(out / "port" / "generate-test.txt")
    _assert_generate_files_agree(got, want)
    hyps = [line.split("\t")[2].split() for line in got if line.startswith("H-")]
    assert len(hyps) == 4 and sum(len(h) for h in hyps) >= 4
    # --post-process reaches the D- lines and the references, the H- lines stay
    assert generate.main([str(tmp_path), "--cpu", "--path", str(step), "--gen-subset", "test",
                          "--max-tokens", "240", "--max-target-positions", "12",
                          "--iter-decode-max-iter", "3", "--results-path", str(out / "pp"),
                          "--post-process", "letter", *_flags(WIDTHS), *_flags(OPTIONS)]) == 0
    pp = _generate_lines(out / "pp" / "generate-test.txt")
    for line, raw in zip(pp[:-1], got[:-1]):
        tag, fields, raw_fields = line[0], line.split("\t"), raw.split("\t")
        want_last = raw_fields[-1] if tag == "H" else jencoders.post_process(raw_fields[-1],
                                                                             "letter")
        assert fields[0] == raw_fields[0] and fields[-1] == want_last, (line, raw)
