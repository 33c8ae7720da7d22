"""The port's prep stage on the CPU against the JAX package: the HuBERT
encoder, the fairseq name map, k-means, and the `cli.prepare` /
`cli.get_manifest` entry points. Shared weights go through
`weights.from_jax_params` with non-zero biases and LayerNorm scales != 1;
inputs come from numpy seeds.

Tolerances: float32 within 1e-5 of JAX (measured ~4e-6 of an output scale ~5
at the small size: sums in another order); bf16 each feature row's direction
within row-cos 0.999 and the worst element within 3e-2 of the output's scale
(measured 0.99966 and 1.6e-2: the two frameworks round to bf16 at other
places, a few bf16 ulps at the top of the range); the CLI's 768-d features
within 1e-4 (512-channel convs, 3072-wide FFNs); k-means within 1e-6."""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.models import kmeans as jax_kmeans
from diffnorm_tpu.models.hubert import HubertEncoder as JHubertEncoder
from diffnorm_tpu.models.hubert import frame_lengths as jax_frame_lengths
from diffnorm_tpu.models.hubert import frames_for_samples as jax_frames_for_samples
from diffnorm_tpu.utils.convert_weights import convert_hubert_state as jax_convert_hubert_state
from diffnorm_tpu_torch.models import kmeans
from diffnorm_tpu_torch.models.hubert import (
    CONV_LAYERS,
    HubertEncoder,
    frame_lengths,
    frames_for_samples,
)
from diffnorm_tpu_torch.utils.convert_weights import convert_hubert_state
from diffnorm_tpu_torch.weights import from_jax_params, to_jax_params
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

SPEC = ((32, 10, 5), (32, 3, 2), (32, 2, 2))
SMALL = dict(dim=64, layers=2, heads=2, ffn_dim=128, conv_feature_layers=SPEC)
N_SAMPLES, LENGTHS = 4000, (4000, 2500)


def _perturb(tree, rng):
    """Biases moved off 0 and norm scales off 1, so every leaf matters."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _perturb(value, rng)
        else:
            value = np.asarray(value, np.float32)
            if key in ("bias", "scale"):
                value = value + rng.normal(scale=0.1, size=value.shape).astype(np.float32)
            out[key] = value
    return out


def _small_models(mode, layer_norm_first, seed=0):
    kw = dict(SMALL, extractor_mode=mode, conv_bias=mode == "layer_norm",
              layer_norm_first=layer_norm_first)
    wav = np.zeros((1, N_SAMPLES), np.float32)
    variables = JHubertEncoder(**kw).init(jax.random.PRNGKey(seed), jnp.asarray(wav))
    params = _perturb(jax.device_get(variables["params"]), np.random.default_rng(seed))
    return kw, params, from_jax_params(HubertEncoder(**kw), params).eval()


def _wav_and_mask():
    wav = (np.random.default_rng(1).normal(size=(2, N_SAMPLES)) * 0.1).astype(np.float32)
    frames = frame_lengths(torch.tensor(LENGTHS), SPEC)
    n = frames_for_samples(N_SAMPLES, SPEC)
    return wav, torch.arange(n)[None, :] < frames[:, None]


def _row_cos(a, b):
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("layer_norm_first", [False, True], ids=["post_norm", "pre_norm"])
@pytest.mark.parametrize("mode", ["default", "layer_norm"])
def test_encoder_matches_jax(mode, layer_norm_first, masked):
    kw, params, model = _small_models(mode, layer_norm_first)
    wav, mask = _wav_and_mask()
    mask = mask if masked else None
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    bf16 = from_jax_params(HubertEncoder(**kw), params).to(torch.bfloat16).eval()
    for output_layer in (None, 1):
        ref = np.asarray(JHubertEncoder(**kw).apply(
            {"params": params}, jnp.asarray(wav), output_layer=output_layer, mask=jmask))
        ref_bf16 = np.asarray(JHubertEncoder(**kw, dtype=jnp.bfloat16).apply(
            {"params": params}, jnp.asarray(wav), output_layer=output_layer,
            mask=jmask)).astype(np.float32)
        with torch.no_grad():
            got = model(torch.from_numpy(wav), output_layer=output_layer, mask=mask).numpy()
            got_bf16 = bf16(torch.from_numpy(wav), output_layer=output_layer,
                            mask=mask).float().numpy()
        assert got.shape == ref.shape == (2, frames_for_samples(N_SAMPLES, SPEC), 64)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        assert _row_cos(got_bf16, ref_bf16).min() >= 0.999
        assert np.abs(got_bf16 - ref_bf16).max() <= 3e-2 * np.abs(ref_bf16).max()


def test_encoder_returns_features_as_jax():
    kw, params, model = _small_models("default", False)
    wav, mask = _wav_and_mask()
    ref = JHubertEncoder(**kw).apply({"params": params}, jnp.asarray(wav),
                                     mask=jnp.asarray(mask.numpy()), return_normed=True)
    with torch.no_grad():
        got = model(torch.from_numpy(wav), mask=mask, return_normed=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    with torch.no_grad():
        x, raw = model(torch.from_numpy(wav), return_features=True)
    np.testing.assert_array_equal(raw.numpy(), got[1].numpy())


def test_frame_counts_match_jax():
    lengths = np.array([0, 5, 399, 400, 401, 16000, 32000, 1_600_000, 1_120_000])
    for spec in (None, SPEC):
        want = [jax_frames_for_samples(int(n), spec) for n in lengths]
        assert [frames_for_samples(int(n), spec) for n in lengths] == want
        np.testing.assert_array_equal(
            frame_lengths(torch.from_numpy(lengths), spec).numpy(),
            np.asarray(jax_frame_lengths(jnp.asarray(lengths), spec)))
    assert frames_for_samples(1_120_000) == 3499  # the 70 s long form


def test_pretraining_hooks_raise():
    """Ported since: the training knobs build and leave the eval forward as
    it was (LayerDrop and feature_grad_mult act in training alone), and the
    hooks (mask_indices with mask_emb, channel_mask) give JAX's output
    within 1e-5; tests/test_torch_hubert_pretrain.py holds the training
    path to JAX."""
    kw, params, model = _small_models("default", False)
    knobs = from_jax_params(HubertEncoder(**kw, layerdrop=0.05, feature_grad_mult=0.1),
                            params).eval()
    wav, mask = _wav_and_mask()
    frames = mask.shape[1]
    spans = torch.zeros(2, frames, dtype=torch.bool)
    spans[0, 10:20], spans[1, 3:9] = True, True
    channels = torch.zeros(2, 64, dtype=torch.bool)
    channels[1, 5:12] = True
    emb = torch.from_numpy(np.random.default_rng(2).uniform(size=64).astype(np.float32))
    ref = np.asarray(JHubertEncoder(**kw).apply(
        {"params": params}, jnp.asarray(wav), mask=jnp.asarray(mask.numpy()),
        mask_indices=jnp.asarray(spans.numpy()), mask_emb=jnp.asarray(emb.numpy()),
        channel_mask=jnp.asarray(channels.numpy())))
    with torch.no_grad():
        assert torch.equal(knobs(torch.from_numpy(wav), mask=mask),
                           model(torch.from_numpy(wav), mask=mask))
        got = knobs(torch.from_numpy(wav), mask=mask, mask_indices=spans, mask_emb=emb,
                    channel_mask=channels).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# ------------------------------------------------------------ fairseq map

def fairseq_state_dict(seed, dim=64, layers=2, ffn=128, conv_layers=SPEC, mode="default"):
    """A seeded state dict in fairseq HubertModel's layout (the pos_conv
    weight-normed over dim 2, as fairseq stores it)."""
    gen = np.random.default_rng(seed)

    def t(*shape, scale=0.05, shift=0.0):
        return torch.from_numpy((gen.normal(scale=scale, size=shape) + shift).astype(np.float32))

    sd, cin = {}, 1
    for i, (c, k, _) in enumerate(conv_layers):
        prefix = f"feature_extractor.conv_layers.{i}"
        sd[f"{prefix}.0.weight"] = t(c, cin, k, scale=(1.0 / (cin * k)) ** 0.5)
        if mode == "layer_norm":
            sd[f"{prefix}.0.bias"] = t(c)
            sd[f"{prefix}.2.1.weight"] = t(c, shift=1.0)
            sd[f"{prefix}.2.1.bias"] = t(c)
        cin = c
    if mode == "default":
        c0 = conv_layers[0][0]
        sd["feature_extractor.conv_layers.0.2.weight"] = t(c0, shift=1.0)
        sd["feature_extractor.conv_layers.0.2.bias"] = t(c0)
    sd["layer_norm.weight"] = t(cin, shift=1.0)
    sd["layer_norm.bias"] = t(cin)
    sd["post_extract_proj.weight"] = t(dim, cin)
    sd["post_extract_proj.bias"] = t(dim)
    sd["encoder.pos_conv.0.weight_g"] = t(1, 1, 128, scale=0.5, shift=1.0)
    sd["encoder.pos_conv.0.weight_v"] = t(dim, dim // 16, 128)
    sd["encoder.pos_conv.0.bias"] = t(dim)
    sd["encoder.layer_norm.weight"] = t(dim, shift=1.0)
    sd["encoder.layer_norm.bias"] = t(dim)
    for n in range(layers):
        p = f"encoder.layers.{n}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{p}.self_attn.{proj}.weight"] = t(dim, dim, scale=dim ** -0.5)
            sd[f"{p}.self_attn.{proj}.bias"] = t(dim)
        for norm in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{p}.{norm}.weight"] = t(dim, shift=1.0)
            sd[f"{p}.{norm}.bias"] = t(dim)
        sd[f"{p}.fc1.weight"] = t(ffn, dim, scale=dim ** -0.5)
        sd[f"{p}.fc1.bias"] = t(ffn)
        sd[f"{p}.fc2.weight"] = t(dim, ffn, scale=ffn ** -0.5)
        sd[f"{p}.fc2.bias"] = t(dim)
    return sd


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@pytest.mark.parametrize("mode", ["default", "layer_norm"])
def test_fairseq_map_matches_jax_bit_for_bit(mode):
    sd = fairseq_state_dict(3, mode=mode)
    got, want = convert_hubert_state(sd, layers=2), jax_convert_hubert_state(sd, layers=2)
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, value in want_leaves.items():
        assert got_leaves[path].dtype == np.float32, path
        np.testing.assert_array_equal(got_leaves[path], np.asarray(value), "/".join(path))
    # the tree loads into the port's encoder (names checked both ways) and
    # comes back out unchanged, GroupNorm's scale included
    model = from_jax_params(HubertEncoder(**SMALL, extractor_mode=mode,
                                          conv_bias=mode == "layer_norm"), got["params"])
    for path, value in _leaves(to_jax_params(model)):
        np.testing.assert_array_equal(value, got_leaves[("params",) + path], "/".join(path))
    # the fairseq `encoder.` prefix on every key is stripped, as in JAX
    prefixed = convert_hubert_state({f"encoder.{k}": v for k, v in sd.items()}, layers=2)
    for path, value in _leaves(prefixed):
        np.testing.assert_array_equal(value, got_leaves[path])


# ---------------------------------------------------------------- k-means

def _clusters(seed, n_per=40, k=6, d=16):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=5.0, size=(k, d)).astype(np.float32)
    feats = (np.repeat(centers, n_per, axis=0)
             + rng.normal(scale=0.3, size=(k * n_per, d))).astype(np.float32)
    return feats[rng.permutation(len(feats))], centers


def test_kmeans_predict_matches_jax():
    feats, centers = _clusters(0)
    want = np.asarray(jax_kmeans.kmeans_predict(jnp.asarray(feats), jnp.asarray(centers)))
    got = kmeans.kmeans_predict(torch.from_numpy(feats), torch.from_numpy(centers))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    batched = kmeans.kmeans_predict(torch.from_numpy(feats.reshape(4, -1, 16)),
                                    torch.from_numpy(centers))
    np.testing.assert_array_equal(batched.numpy().reshape(-1), want)


def test_lloyd_step_matches_jax_and_keeps_empty_clusters():
    feats, centers = _clusters(1)
    start = np.concatenate([centers + 0.5, np.full((1, 16), 1e3, np.float32)])  # last: empty
    want = np.asarray(jax_kmeans._lloyd_step(jnp.asarray(feats), jnp.asarray(start.copy())))
    got = kmeans._lloyd_step(torch.from_numpy(feats), torch.from_numpy(start)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[-1], start[-1])


def test_kmeans_fit_matches_jax():
    feats, _ = _clusters(2)
    want = jax_kmeans.kmeans_fit(feats, 6, iters=4, batch_size=100, seed=5)
    got = kmeans.kmeans_fit(feats, 6, iters=4, batch_size=100, seed=5, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kmeans.kmeans_fit(feats, 6, iters=1)


def test_centroids_npy_round_trip(tmp_path):
    centroids = np.random.default_rng(3).normal(size=(7, 5)).astype(np.float32)
    kmeans.save_centroids(str(tmp_path / "km.npy"), centroids)
    np.testing.assert_array_equal(kmeans.load_centroids(str(tmp_path / "km.npy")), centroids)
    np.testing.assert_array_equal(jax_kmeans.load_centroids(str(tmp_path / "km.npy")), centroids)


def test_centroids_joblib_round_trip(tmp_path):
    pytest.importorskip("sklearn")
    centroids = np.random.default_rng(4).normal(size=(7, 5)).astype(np.float32)
    jax_kmeans.save_centroids(str(tmp_path / "jax.bin"), centroids)
    kmeans.save_centroids(str(tmp_path / "port.bin"), centroids)
    for name in ("jax.bin", "port.bin"):
        np.testing.assert_array_equal(kmeans.load_centroids(str(tmp_path / name)), centroids)
        np.testing.assert_array_equal(jax_kmeans.load_centroids(str(tmp_path / name)),
                                      centroids)


def test_joblib_centroids_need_joblib(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "joblib", None)
    with pytest.raises(ImportError):
        kmeans.load_centroids(str(tmp_path / "km.bin"))


# -------------------------------------------------------------------- CLI

def write_wav(path, wav, sr=16000):
    pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def _read_wav(path):
    with wave.open(str(path), "rb") as f:
        return np.frombuffer(f.readframes(f.getnframes()), np.int16).astype(np.float32) / 32768.0


@pytest.fixture(scope="module")
def fairseq_ckpts(tmp_path_factory):
    """Seeded fairseq checkpoints with the released conv extractor (the CLIs
    infer only the transformer's shape): 768-d and 128-d, two layers."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for dim, ffn in ((768, 3072), (128, 256)):
        path = root / f"hubert_{dim}.pt"
        torch.save({"model": fairseq_state_dict(7, dim=dim, ffn=ffn,
                                                conv_layers=CONV_LAYERS)}, path)
        out[dim] = str(path)
    return out


def test_get_manifest_matches_jax(tmp_path):
    from diffnorm_tpu.cli import get_manifest as jax_get_manifest
    from diffnorm_tpu_torch.cli import get_manifest

    rng = np.random.default_rng(6)
    (tmp_path / "audio" / "sub").mkdir(parents=True)
    for i, rel in enumerate(["b.wav", "a.wav", "sub/c.wav", "sub/skip.txt"]):
        write_wav(tmp_path / "audio" / rel, rng.normal(size=800 + 100 * i) * 0.1)
    for ext, contain in (("wav", None), ("wav", "sub")):
        args = [str(tmp_path / "audio"), "--ext", ext] + (
            ["--path-must-contain", contain] if contain else [])
        assert jax_get_manifest.main(args + ["--dest", str(tmp_path / "jax" / "m.tsv")]) == 0
        assert get_manifest.main(args + ["--dest", str(tmp_path / "port" / "m.tsv")]) == 0
        got = (tmp_path / "port" / "m.tsv").read_text()
        assert got == (tmp_path / "jax" / "m.tsv").read_text()
        assert len(got.splitlines()) == (4 if contain is None else 2)


def test_cli_matches_jax_cli(tmp_path, fairseq_ckpts, monkeypatch):
    """2 s utterances (exactly a JAX length bucket, so JAX pads nothing):
    get_manifest -> dump-features -> learn-kmeans -> quantize through both
    CLIs, on one fairseq .pt."""
    from diffnorm_tpu.cli import prepare as jax_prepare
    from diffnorm_tpu_torch.cli import get_manifest, prepare

    monkeypatch.setenv("DIFFNORM_COMPILE_CACHE", "0")
    rng = np.random.default_rng(8)
    (tmp_path / "audio").mkdir()
    for i in range(2):
        write_wav(tmp_path / "audio" / f"utt{i}.wav", rng.normal(size=32000) * 0.1)
    manifest = str(tmp_path / "train_audio.tsv")
    assert get_manifest.main([str(tmp_path / "audio"), "--dest", manifest]) == 0
    out = {}
    for name, cli in (("jax", jax_prepare), ("port", prepare)):
        d = tmp_path / name
        assert cli.main(["--cpu", "dump-features", "--manifest", manifest, "--hubert-ckpt",
                         fairseq_ckpts[768], "--layer", "1", "--out-dir", str(d / "feat"),
                         "--split", "train"]) == 0
        assert cli.main(["--cpu", "learn-kmeans", "--feat-dir", str(d / "feat"), "--split",
                         "train", "--num-clusters", "8", "--iters", "3", "--max-frames", "150",
                         "--out", str(d / "km.npy")]) == 0
        assert cli.main(["--cpu", "quantize", "--feat-dir", str(d / "feat"), "--split",
                         "train", "--kmeans", str(d / "km.npy"),
                         "--out", str(d / "train.units")]) == 0
        out[name] = d
    n = frames_for_samples(32000)
    for i in range(2):
        got = np.load(out["port"] / "feat" / f"utt{i}.feat.npy")
        want = np.load(out["jax"] / "feat" / f"utt{i}.feat.npy")
        assert got.shape == want.shape == (n, 768) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    manifests = [(out[k] / "feat" / "train.manifest.tsv").read_text().splitlines()
                 for k in ("port", "jax")]
    assert manifests[0][1:] == manifests[1][1:] == [f"utt0.feat.npy\t{n}", f"utt1.feat.npy\t{n}"]
    assert manifests[0][0] == str(out["port"] / "feat")
    np.testing.assert_allclose(np.load(out["port"] / "km.npy"), np.load(out["jax"] / "km.npy"),
                               atol=1e-5, rtol=0)
    units = (out["port"] / "train.units").read_text()
    assert units == (out["jax"] / "train.units").read_text()
    assert len(set(units.split("|")[1].split())) > 1


def test_bucket_padding_fault_of_the_reference(tmp_path, fairseq_ckpts):
    """JAX's CLI pads a 0.5 s utterance to its 2 s bucket and runs the encoder
    unmasked, which changes the features; the port's CLI gives the encoder's
    features of the utterance alone."""
    from diffnorm_tpu.cli import prepare as jax_prepare
    from diffnorm_tpu.utils.convert_weights import convert_hubert_checkpoint
    from diffnorm_tpu_torch.cli import prepare

    write_wav(tmp_path / "short.wav", np.random.default_rng(9).normal(size=8000) * 0.1)
    wav = _read_wav(tmp_path / "short.wav")
    variables = convert_hubert_checkpoint(fairseq_ckpts[128], layers=2)
    unpadded = np.asarray(JHubertEncoder(dim=128, layers=2, heads=2, ffn_dim=256).apply(
        variables, jnp.asarray(wav[None]), output_layer=2))[0]
    padded = jax_prepare.build_hubert(fairseq_ckpts[128], 2)(wav)
    assert padded.shape == unpadded.shape == (frames_for_samples(8000), 128)
    assert np.abs(padded - unpadded).max() > 0.1 * np.abs(unpadded).max()

    (tmp_path / "m.tsv").write_text(f"{tmp_path}\nshort.wav\t8000\n")
    assert prepare.main(["--cpu", "dump-features", "--manifest", str(tmp_path / "m.tsv"),
                         "--hubert-ckpt", fairseq_ckpts[128], "--layer", "2",
                         "--out-dir", str(tmp_path / "feat")]) == 0
    got = np.load(tmp_path / "feat" / "short.feat.npy")
    np.testing.assert_allclose(got, unpadded, atol=1e-5, rtol=0)


def test_cli_reads_npz_and_step_directories(tmp_path, fairseq_ckpts):
    """`--hubert-ckpt` takes a weights.save_npz file (or a step directory
    holding params.npz) as well as a fairseq .pt, with the same features."""
    from diffnorm_tpu_torch.cli import prepare
    from diffnorm_tpu_torch.utils.convert_weights import convert_hubert_checkpoint
    from diffnorm_tpu_torch.weights import save_npz

    params = convert_hubert_checkpoint(fairseq_ckpts[128], layers=2)["params"]
    (tmp_path / "step").mkdir()
    save_npz(str(tmp_path / "step" / "params.npz"), {"params": params})
    save_npz(str(tmp_path / "hubert.npz"), params)
    wav = (np.random.default_rng(10).normal(size=6000) * 0.1).astype(np.float32)
    cpu = torch.device("cpu")
    want = prepare.build_hubert(fairseq_ckpts[128], 2, cpu)(wav)
    for ckpt in (str(tmp_path / "step"), str(tmp_path / "hubert.npz")):
        np.testing.assert_array_equal(prepare.build_hubert(ckpt, 2, cpu)(wav), want)
    assert want.shape == (frames_for_samples(6000), 128)
    assert prepare.build_hubert(fairseq_ckpts[128], 2, cpu)(wav[:300]).shape == (0, 128)


def test_cli_chunks_long_utterances(monkeypatch, fairseq_ckpts):
    """An utterance longer than CHUNK goes through the encoder chunk by
    chunk, each at its own length, as fairseq's feature reader does."""
    from diffnorm_tpu_torch.cli import prepare

    monkeypatch.setattr(prepare, "CHUNK", 6400)
    wav = (np.random.default_rng(11).normal(size=16000) * 0.1).astype(np.float32)
    cpu = torch.device("cpu")
    extract = prepare.build_hubert(fairseq_ckpts[128], 1, cpu)
    got = extract(wav)
    want = np.concatenate([extract(wav[:6400]), extract(wav[6400:12800]),
                           extract(wav[12800:])])
    np.testing.assert_array_equal(got, want)
    assert len(got) == 2 * frames_for_samples(6400) + frames_for_samples(3200)
