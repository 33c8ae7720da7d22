"""TranSpeech's baseline normalization in the port (ops/speech_norm.py,
cli/speech_norm.py) against the JAX package on the CPU: YIN's difference
function and CMNDF within 1e-5 relative, yin_pitch's voiced flags and
integer lags equal and f0 within 1e-4 relative, the pitch shift within 1e-4
of the peak, the energy normalization within 1e-6, InterpLnr bit for bit
under equal generators, and cli.speech_norm against JAX's CLI (the same
medians, the wavs within 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffnorm_tpu.ops import speech_norm as J
from diffnorm_tpu_torch.ops import speech_norm as P
from tests.torch_threads import torch_threads_per_worker  # noqa: F401 (autouse)

SR = 16000
SECONDS = 1.2  # one length for every YIN comparison: JAX compiles its ops once a shape


def voice(f0: float, seconds: float, rng, silence: int = 2400) -> np.ndarray:
    """A harmonic voice with 5 Hz vibrato and noise, silence at both ends."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 6)) * 0.3 + 0.01 * rng.normal(size=n)
    x[:silence] = 0.0
    x[-silence:] = 0.0
    return x.astype(np.float32)


def test_yin_difference_and_cmndf_match_jax():
    rng = np.random.default_rng(0)
    for w, tau_max in ((2048, 214), (64, 24), (300, 300)):
        frames = rng.normal(size=(5, w)).astype(np.float32)
        want = np.asarray(J.yin_difference(jnp.asarray(frames), tau_max))
        got = P.yin_difference(torch.from_numpy(frames), tau_max).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        cm_want = np.asarray(J.yin_cmndf(jnp.asarray(want)))
        cm_got = P.yin_cmndf(torch.from_numpy(want.copy())).numpy()
        assert np.abs(cm_got - cm_want).max() <= 1e-5 * np.abs(cm_want).max()


def _lags(f0, voiced, sr=SR):
    """The integer lag under a voiced frame's f0 (the refinement is within
    half a lag)."""
    return np.round(sr / f0[voiced]).astype(int)


@pytest.mark.parametrize("f0", [90.0, 140.0, 210.0, 240.0])
def test_yin_pitch_matches_jax(f0):
    rng = np.random.default_rng(int(f0))
    x = voice(f0, SECONDS, rng)
    fj, vj = (np.asarray(a) for a in J.yin_pitch(jnp.asarray(x), SR))
    fp, vp = (a.numpy() for a in P.yin_pitch(torch.from_numpy(x), SR))
    np.testing.assert_array_equal(vp, vj)
    assert vj.sum() > 30 and not vj.all()  # the silences are unvoiced
    np.testing.assert_array_equal(_lags(fp, vp), _lags(fj, vj))
    np.testing.assert_allclose(fp, fj, rtol=1e-4, atol=0)
    assert abs(P.pitch_median(x, SR, device="cpu") - J.pitch_median(x, SR)) <= 1e-4 * f0


def test_yin_pitch_silent_and_short_signals():
    for x in (np.zeros(int(SECONDS * SR), np.float32),
              voice(150.0, 0.1, np.random.default_rng(1), 0)):  # shorter than a frame
        fj, vj = (np.asarray(a) for a in J.yin_pitch(jnp.asarray(x), SR))
        fp, vp = (a.numpy() for a in P.yin_pitch(torch.from_numpy(x), SR))
        np.testing.assert_array_equal(vp, vj)
        np.testing.assert_allclose(fp, fj, rtol=1e-4, atol=0)
    assert P.pitch_median(np.zeros(SR, np.float32), SR, device="cpu") == 0.0


def test_pitch_median_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.pitch_median(np.zeros(SR, np.float32), SR)


@pytest.mark.parametrize("ratio", [0.8, 1.25])
def test_pitch_shift_and_shift_to_median_match_jax(ratio):
    rng = np.random.default_rng(7)
    x = voice(150.0, SECONDS, rng)
    want = J.pitch_shift(x, SR, ratio)
    got = P.pitch_shift(x, SR, ratio)
    assert got.shape == want.shape == x.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    want = J.shift_to_median(x, SR, 150.0 * ratio)
    got = P.shift_to_median(x, SR, 150.0 * ratio, device="cpu")
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_energy_normalization_matches_jax():
    x = voice(120.0, 0.5, np.random.default_rng(3))
    np.testing.assert_allclose(P.normalize_energy(x, 0.123), J.normalize_energy(x, 0.123),
                               atol=1e-6, rtol=0)
    assert abs(P.mean_abs_energy(x) - J.mean_abs_energy(x)) <= 1e-6
    np.testing.assert_array_equal(P.normalize_energy(np.zeros(10), 0.5), np.zeros(10))


@pytest.mark.parametrize("seed, len_seq, dtype", [(0, 280, np.float32), (1, None, np.float64),
                                                  (2, 1, np.float32)])
def test_random_segment_resample_bit_equal(seed, len_seq, dtype):
    x = np.random.default_rng(10 + seed).normal(size=(300, 8)).astype(dtype)
    want = J.random_segment_resample(x, len_seq, np.random.default_rng(seed))
    got = P.random_segment_resample(x, len_seq, np.random.default_rng(seed))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_cli_matches_jax_cli(tmp_path, capsys):
    from diffnorm_tpu.cli.speech_norm import main as jax_main
    from diffnorm_tpu_torch.cli import speech_norm
    from diffnorm_tpu_torch.cli.generate_waveform import write_wav
    from diffnorm_tpu_torch.data.audio import read_audio

    rng = np.random.default_rng(11)
    wav_root = tmp_path / "wavs"
    (wav_root / "dev").mkdir(parents=True)
    write_wav(str(wav_root / "dev" / "a.wav"), voice(130.0, SECONDS, rng), SR)
    write_wav(str(wav_root / "dev" / "b.wav"), voice(200.0, SECONDS, rng) * 0.5, SR)
    flags = ["--wav", str(wav_root), "--splits", "dev,test", "--cpu"]
    jax_main(flags + ["--out", str(tmp_path / "jax")])
    jax_line = [ln for ln in capsys.readouterr().out.splitlines() if "mean voiced" in ln]
    assert speech_norm.main(flags + ["--out", str(tmp_path / "port")]) == 0
    port_line = [ln for ln in capsys.readouterr().out.splitlines() if "mean voiced" in ln]
    assert port_line == jax_line and "2 utts" in port_line[0]
    for name in ("a.wav", "b.wav"):
        want, _ = read_audio(str(tmp_path / "jax" / "dev" / "result" / name))
        got, sr = read_audio(str(tmp_path / "port" / "dev" / "result" / name))
        assert sr == SR and got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4
    stats = speech_norm.normalize_split(str(wav_root), str(tmp_path / "again"), "dev", SR,
                                        250.0, torch.device("cpu"))
    assert set(stats["medians"]) == {"a", "b"}
    assert stats["target_median"] == pytest.approx(np.mean(list(stats["medians"].values())))


def test_cli_refuses_the_cpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    from diffnorm_tpu_torch.cli import speech_norm

    with pytest.raises(RuntimeError, match="CUDA"):
        speech_norm.main(["--wav", str(tmp_path), "--out", str(tmp_path / "out")])
