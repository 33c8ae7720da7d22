"""The port's wav2vec2-CTC recognizer and ASR-BLEU on the CPU: logits
against `transformers.Wav2Vec2ForCTC` on two configurations and both weight
formats, `ctc_decode` against the processor's `batch_decode`, and
`run_asr_bleu` against the JAX package's on the same wavs and checkpoint
(tests/helpers.py:make_tiny_ctc_checkpoint)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from diffnorm_tpu_torch.eval import asr_bleu
from diffnorm_tpu_torch.models.wav2vec2_ctc import (
    ctc_decode,
    load_ctc_checkpoint,
    normalize_waveform,
    read_safetensors,
)
from tests.helpers import CTC_VOCAB, make_tiny_ctc_checkpoint, write_wav16
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

transformers = pytest.importorskip("transformers")


def _perturb(model, seed):
    """Non-zero biases, LayerNorm / GroupNorm scales != 1, every weight moved."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05 * (p.std() if p.numel() > 1 else 1))
    return model


def _relative_err(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.fixture(scope="module")
def tiny_ctc(tmp_path_factory):
    """make_tiny_ctc_checkpoint's model (group norm, post-norm) with perturbed
    weights, saved as model.safetensors beside its processor files."""
    src = make_tiny_ctc_checkpoint(tmp_path_factory.mktemp("tiny_ctc"))
    model = _perturb(transformers.Wav2Vec2ForCTC.from_pretrained(src).eval(), 0)
    d = str(tmp_path_factory.mktemp("tiny_ctc_perturbed"))
    model.save_pretrained(d)
    for name in os.listdir(src):
        if not name.startswith(("model.", "config")):
            shutil.copy(os.path.join(src, name), d)
    assert os.path.exists(os.path.join(d, "model.safetensors"))
    return d, model


def _stable_ctc(d):
    """A tiny "layer" extractor (conv bias) + stable-layer-norm config,
    saved as pytorch_model.bin with the positional conv's weight norm as
    weight_g / weight_v (the released checkpoints' form)."""
    config = transformers.Wav2Vec2Config(
        vocab_size=len(CTC_VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=48, conv_dim=(16, 24, 24), conv_kernel=(10, 3, 2),
        conv_stride=(5, 2, 2), num_feat_extract_layers=3, num_conv_pos_embeddings=8,
        num_conv_pos_embedding_groups=2, feat_extract_norm="layer", conv_bias=True,
        do_stable_layer_norm=True, layer_norm_eps=1e-5)
    torch.manual_seed(1)
    model = _perturb(transformers.Wav2Vec2ForCTC(config).eval(), 1)
    os.makedirs(d, exist_ok=True)
    config.save_pretrained(d)
    sd = model.state_dict()
    prefix = "wav2vec2.encoder.pos_conv_embed.conv."
    sd[prefix + "weight_g"] = sd.pop(prefix + "parametrizations.weight.original0")
    sd[prefix + "weight_v"] = sd.pop(prefix + "parametrizations.weight.original1")
    torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump({c: i for i, c in enumerate(CTC_VOCAB)}, f)
    return model


def test_read_safetensors_matches_the_package(tiny_ctc):
    safetensors = pytest.importorskip("safetensors.torch")
    path = os.path.join(tiny_ctc[0], "model.safetensors")
    want, got = safetensors.load_file(path), read_safetensors(path)
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype
        torch.testing.assert_close(got[name], value, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["group_postnorm_safetensors", "layer_stable_bin_weight_g"])
def test_wav2vec2_ctc_logits_match_transformers(tiny_ctc, tmp_path, case):
    if case == "group_postnorm_safetensors":
        d, hf = tiny_ctc
    else:
        d = str(tmp_path / "stable")
        hf = _stable_ctc(d)
    ckpt = load_ctc_checkpoint(d)
    assert ckpt.model.encoder.layer_norm_first == (case != "group_postnorm_safetensors")
    rng = np.random.default_rng(3)
    for n in (8000, 12345):
        wav = (rng.normal(size=n) * 0.1).astype(np.float32)
        x = torch.from_numpy(normalize_waveform(wav))[None]
        with torch.no_grad():
            want = hf(x).logits
            got = ckpt.model(x)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _relative_err(got, want) <= 1e-5, case
    # a name left over or missing raises
    sd = read_safetensors(os.path.join(d, "model.safetensors")) if case.endswith(
        "safetensors") else torch.load(os.path.join(d, "pytorch_model.bin"), weights_only=True)
    from diffnorm_tpu_torch.models.wav2vec2_ctc import Wav2Vec2CTC, hf_to_port_state

    model = Wav2Vec2CTC(json.load(open(os.path.join(d, "config.json"))))
    for edit in ("extra", "missing"):
        bad = dict(sd)
        if edit == "extra":
            bad["wav2vec2.adapter.proj.weight"] = torch.zeros(1)
        else:
            del bad["lm_head.bias"]
        with pytest.raises(KeyError, match="lm_head.bias" if edit == "missing" else "adapter"):
            hf_to_port_state(bad, model)


def test_normalize_waveform_matches_the_feature_extractor(tiny_ctc):
    proc = transformers.Wav2Vec2Processor.from_pretrained(tiny_ctc[0])
    rng = np.random.default_rng(4)
    for n in (640, 16000, 33333):
        wav = (rng.normal(size=n) * rng.uniform(0.01, 0.5) + 0.01).astype(np.float32)
        want = proc(wav, sampling_rate=16000, return_tensors="np").input_values[0]
        np.testing.assert_array_equal(normalize_waveform(wav), want)


def test_ctc_decode_matches_batch_decode(tiny_ctc):
    proc = transformers.Wav2Vec2Processor.from_pretrained(tiny_ctc[0])
    ckpt = load_ctc_checkpoint(tiny_ctc[0])
    rng = np.random.default_rng(5)
    # ids weighted towards the pad (CTC blank) and the delimiter, with runs
    probs = np.full(len(CTC_VOCAB) + 1, 1.0)
    probs[0], probs[4] = 8.0, 4.0
    probs /= probs.sum()
    rows = []
    for _ in range(200):
        ids = rng.choice(len(probs), size=int(rng.integers(0, 40)), p=probs)
        rows.append(np.repeat(ids, rng.integers(1, 4, size=len(ids))))  # repeats
    for ids in rows:
        want = proc.batch_decode(torch.from_numpy(ids)[None])[0]
        assert ctc_decode(ids.tolist(), ckpt.vocab, ckpt.tokenizer) == want, ids
    assert any("</s>" in ctc_decode(r.tolist(), ckpt.vocab, ckpt.tokenizer) for r in rows)
    lower = {**ckpt.tokenizer, "do_lower_case": True, "clean_up_tokenization_spaces": True}
    assert ctc_decode([7, 7, 0, 4, 5], {"a": 5, "|": 4, "<pad>": 0, "B": 7}, lower) == "b a"


def test_run_asr_bleu_matches_jax(tiny_ctc, tmp_path):
    """Transcripts and BLEU equal JAX's run_asr_bleu on the same wavs and
    checkpoint; references hold the JAX recognizer's own transcripts for
    two of the four wavs, so the BLEU is not zero. A wav under 640
    samples scores empty."""
    from diffnorm_tpu.eval.asr_bleu import ASRGenerator as JASRGenerator
    from diffnorm_tpu.eval.asr_bleu import run_asr_bleu as jax_run_asr_bleu

    d = tiny_ctc[0]
    rng = np.random.default_rng(6)
    audio = tmp_path / "wav"
    audio.mkdir()
    for i, n in enumerate((9000, 16000, 400, 12000)):
        write_wav16(audio / f"{i}_pred.wav", rng.normal(size=n) * 0.2)
    jax_asr = JASRGenerator(model_name=d)
    refs = [jax_asr.transcribe_file(str(audio / f"{i}_pred.wav")) for i in (0, 1)]
    (tmp_path / "refs.txt").write_text(f"{refs[0]}\n{refs[1]}\nhello world\nthe cat\n")
    want = jax_run_asr_bleu(str(audio), str(tmp_path / "refs.txt"), model_name=d)
    got = asr_bleu.run_asr_bleu(str(audio), str(tmp_path / "refs.txt"), model_name=d,
                                device="cpu")
    assert got[1] == want[1] and got[2] == want[2]
    assert got[0] == want[0] > 0.0
    assert got[1][2] == ""


def test_asr_bleu_refuses_guesses_and_downloads(tmp_path, monkeypatch):
    audio = tmp_path / "audio"
    audio.mkdir()
    (audio / "utt2_pred.wav").write_bytes(b"")
    (tmp_path / "refs.txt").write_text("hello\nworld\n")
    with pytest.raises(FileNotFoundError, match="joinable by id"):
        asr_bleu.run_asr_bleu(str(audio), str(tmp_path / "refs.txt"), model_name="unused",
                              device="cpu")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    with pytest.raises(FileNotFoundError, match="models--facebook--wav2vec2-large-960h"):
        asr_bleu.resolve_asr_model("en")
    snap = tmp_path / "hf" / "hub" / "models--org--name" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (snap / "config.json").write_text("{}")
    assert asr_bleu.resolve_asr_model("en", "org/name") == str(snap)
    assert asr_bleu.resolve_asr_model("en", str(tmp_path)) == str(tmp_path)


def _hubert_ctc(d, processor_dir, extractor, stable, feat_proj_layer_norm, weight_g=False,
                **extra):
    """A tiny seeded `HubertForCTC` directory as `save_pretrained` writes it
    (model.safetensors, or pytorch_model.bin with the positional conv's
    weight norm as weight_g / weight_v), with tiny_ctc's processor files."""
    config = transformers.HubertConfig(
        vocab_size=len(CTC_VOCAB), hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=48, conv_dim=(16, 24, 24), conv_kernel=(10, 3, 2),
        conv_stride=(5, 2, 2), num_feat_extract_layers=3, num_conv_pos_embeddings=8,
        num_conv_pos_embedding_groups=2, feat_extract_norm=extractor,
        conv_bias=extractor == "layer", do_stable_layer_norm=stable,
        feat_proj_layer_norm=feat_proj_layer_norm, layer_norm_eps=1e-5, **extra)
    torch.manual_seed(2)
    model = _perturb(transformers.HubertForCTC(config).eval(), 2)
    os.makedirs(d, exist_ok=True)
    if weight_g:
        config.save_pretrained(d)
        sd = model.state_dict()
        prefix = "hubert.encoder.pos_conv_embed.conv."
        sd[prefix + "weight_g"] = sd.pop(prefix + "parametrizations.weight.original0")
        sd[prefix + "weight_v"] = sd.pop(prefix + "parametrizations.weight.original1")
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    else:
        model.save_pretrained(d)
    for name in os.listdir(processor_dir):
        if not name.startswith(("model.", "config")):
            shutil.copy(os.path.join(processor_dir, name), d)
    return model


HUBERT_CASES = {  # (extractor norm, stable layer norm, feat_proj_layer_norm, weight_g)
    "group_postnorm_featln": ("group", False, True, False),
    "group_postnorm_no_featln": ("group", False, False, True),
    "layer_stable_featln_weight_g": ("layer", True, True, True),
    "layer_stable_no_featln": ("layer", True, False, False),
}


@pytest.mark.parametrize("case", sorted(HUBERT_CASES))
def test_hubert_ctc_logits_match_transformers(tiny_ctc, tmp_path, case):
    extractor, stable, featln, weight_g = HUBERT_CASES[case]
    d = str(tmp_path / case)
    hf = _hubert_ctc(d, tiny_ctc[0], extractor, stable, featln, weight_g)
    ckpt = load_ctc_checkpoint(asr_bleu.resolve_asr_model("en", d))
    assert ckpt.model.prefix == "hubert"
    assert isinstance(ckpt.model.encoder.layer_norm, torch.nn.LayerNorm) == featln
    assert ckpt.model.encoder.layer_norm_first == stable
    rng = np.random.default_rng(7)
    for n in (8000, 12345):
        wav = (rng.normal(size=n) * 0.1).astype(np.float32)
        x = torch.from_numpy(normalize_waveform(wav))[None]
        with torch.no_grad():
            want = hf(x).logits
            got = ckpt.model(x)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _relative_err(got, want) <= 1e-5, case


def test_hubert_ctc_refuses_what_is_not_ported(tiny_ctc, tmp_path):
    from diffnorm_tpu_torch.models.wav2vec2_ctc import Wav2Vec2CTC

    d = str(tmp_path / "bn")
    _hubert_ctc(d, tiny_ctc[0], "group", False, True, conv_pos_batch_norm=True)
    with pytest.raises(NotImplementedError, match="conv_pos_batch_norm"):
        load_ctc_checkpoint(d)
    with pytest.raises(NotImplementedError, match="only wav2vec2-CTC and HuBERT-CTC"):
        Wav2Vec2CTC({"model_type": "data2vec-audio"})
    config = json.load(open(os.path.join(d, "config.json")))
    with pytest.raises(NotImplementedError, match="use_weighted_layer_sum"):
        Wav2Vec2CTC({**config, "conv_pos_batch_norm": False, "use_weighted_layer_sum": True})


def test_run_asr_bleu_on_a_hubert_ctc_checkpoint_matches_jax(tiny_ctc, tmp_path):
    """JAX's run_asr_bleu loads the directory through AutoModelForCTC
    (HubertForCTC); the port's transcripts and BLEU equal its."""
    from diffnorm_tpu.eval.asr_bleu import ASRGenerator as JASRGenerator
    from diffnorm_tpu.eval.asr_bleu import run_asr_bleu as jax_run_asr_bleu

    d = str(tmp_path / "hubert")
    _hubert_ctc(d, tiny_ctc[0], "layer", True, False)
    rng = np.random.default_rng(8)
    audio = tmp_path / "wav"
    audio.mkdir()
    for i, n in enumerate((9000, 16000, 12000)):
        write_wav16(audio / f"{i}_pred.wav", rng.normal(size=n) * 0.2)
    jax_asr = JASRGenerator(model_name=d)
    assert type(jax_asr.model).__name__ == "HubertForCTC"
    refs = [jax_asr.transcribe_file(str(audio / f"{i}_pred.wav")) for i in (0, 1)]
    (tmp_path / "refs.txt").write_text(f"{refs[0]}\n{refs[1]}\nthe cat\n")
    want = jax_run_asr_bleu(str(audio), str(tmp_path / "refs.txt"), model_name=d)
    got = asr_bleu.run_asr_bleu(str(audio), str(tmp_path / "refs.txt"), model_name=d,
                                device="cpu")
    assert got[1] == want[1] and got[2] == want[2]
    assert got[0] == want[0]
