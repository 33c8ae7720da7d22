"""Audio augmentation transforms (the port's copy of
diffnorm_tpu/data/augment.py; reference fairseq/data/audio/
waveform_transforms/noiseaugment.py and dataset_transforms/).

Waveform transforms mix samples of a noise directory into a source
waveform: NoiseAugment (aliases MusicAugment / BackgroundNoiseAugment),
BabbleAugment (3-7 speech samples aggregated), SporadicNoiseAugment (short
bursts at a rate per second). Dataset transforms: ConcatAugment (a second
sample index to concatenate) and NoisyOverlapAugment (a snippet of another
in-batch utterance, or of external noise, overlaid at a random SNR).

Host-side numpy, no device work. Every draw comes from the caller's `rng`
(an np.random.Generator) in the reference's order and number, so one seeded
generator gives JAX's outputs bit for bit. As the reference's, the waveform
transforms ask for a 2-D noise sample (`always_2d`) whatever the source's
rank, so a 1-D source gets zeros for noise after the same draws
(`pick_sample`'s rank check).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from diffnorm_tpu_torch.data.audio import read_audio

SNR_MIN = 5.0
SNR_MAX = 15.0
RATE = 0.25

NOISE_RATE = 1.0
NOISE_LEN_MEAN = 0.2
NOISE_LEN_STD = 0.05


def rand_uniform(rng, a: float, b: float) -> float:
    # reference fairseq/data/audio/__init__.py:92 (np.random.uniform() scaled)
    return float(rng.uniform(0.0, 1.0)) * (b - a) + a


class NoiseAugment:
    """Mix a random noise-directory sample into the waveform at a random SNR
    (noiseaugment.py:20-118). `samples_path` is globbed for **/*.wav (plus
    .npy, which the reference's loader also accepts upstream)."""

    def __init__(self, samples_path: str, snr_min: float = SNR_MIN,
                 snr_max: float = SNR_MAX, rate: float = RATE):
        assert samples_path, "need a noise-sample directory"
        assert snr_max >= snr_min, f"empty SNR range ({snr_min}, {snr_max})"
        assert 0 <= rate <= 1, "rate must be in [0, 1]"
        self.paths = sorted(Path(samples_path).glob("**/*.wav")) + sorted(
            Path(samples_path).glob("**/*.npy"))
        self.n_samples = len(self.paths)
        assert self.n_samples > 0, f"no audio files found in {samples_path}"
        self.snr_min, self.snr_max, self.rate = snr_min, snr_max, rate

    def _load(self, path, always_2d: bool) -> np.ndarray:
        if str(path).endswith(".npy"):
            wav = np.load(path)
        else:
            wav, _ = read_audio(str(path))
        wav = np.asarray(wav, np.float32)
        if always_2d and wav.ndim == 1:
            wav = wav[None, :]
        return wav

    def pick_sample(self, goal_shape, rng, always_2d: bool = False,
                    use_sample_rate: Optional[int] = None) -> np.ndarray:
        """Pick a random noise file and cut/tile it to `goal_shape`
        (noiseaugment.py:67-92: dim-mismatch silently yields zeros BEFORE the
        start-offset draw)."""
        path = self.paths[int(rng.integers(0, self.n_samples))]
        sample = self._load(path, always_2d)

        is_2d = len(goal_shape) == 2
        if len(goal_shape) != sample.ndim or (
                is_2d and goal_shape[0] != sample.shape[0]):
            return np.zeros(goal_shape)

        len_dim = len(goal_shape) - 1
        n_repeat = math.ceil(goal_shape[len_dim] / sample.shape[len_dim])
        repeated = np.tile(sample, [1, n_repeat] if is_2d else n_repeat)
        start = int(rng.integers(
            0, repeated.shape[len_dim] - goal_shape[len_dim] + 1))
        return (repeated[:, start:start + goal_shape[len_dim]] if is_2d
                else repeated[start:start + goal_shape[len_dim]])

    @staticmethod
    def _mix(source, noise, snr):
        get_power = lambda x: np.mean(x ** 2)  # noqa: E731
        if get_power(noise):
            scl = np.sqrt(
                get_power(source) / (np.power(10, snr / 10) * get_power(noise)))
        else:
            scl = 0
        return 1 * source + scl * noise

    def _get_noise(self, goal_shape, rng, always_2d=False, use_sample_rate=None):
        return self.pick_sample(goal_shape, rng, always_2d, use_sample_rate)

    def __call__(self, source: np.ndarray, sample_rate: int, rng):
        if rng.random() > self.rate:
            return source, sample_rate
        noise = self._get_noise(
            source.shape, rng, always_2d=True, use_sample_rate=sample_rate)
        return (self._mix(source, noise,
                          rand_uniform(rng, self.snr_min, self.snr_max)),
                sample_rate)


class MusicAugment(NoiseAugment):
    pass


class BackgroundNoiseAugment(NoiseAugment):
    pass


class BabbleAugment(NoiseAugment):
    """Aggregate 3-7 speech samples, each mixed at SNR = #already-aggregated
    (noiseaugment.py:131-139)."""

    def _get_noise(self, goal_shape, rng, always_2d=False, use_sample_rate=None):
        agg_noise = None
        for i in range(int(rng.integers(3, 8))):
            speech = self.pick_sample(goal_shape, rng, always_2d, use_sample_rate)
            agg_noise = speech if i == 0 else self._mix(agg_noise, speech, i)
        return agg_noise


class SporadicNoiseAugment(NoiseAugment):
    """Short noise bursts: ~noise_rate per second, each N(len_mean, len_std)
    seconds, added at uniform start points (noiseaugment.py:142-201)."""

    def __init__(self, samples_path, snr_min=SNR_MIN, snr_max=SNR_MAX,
                 rate=RATE, noise_rate=NOISE_RATE,
                 noise_len_mean=NOISE_LEN_MEAN, noise_len_std=NOISE_LEN_STD):
        super().__init__(samples_path, snr_min, snr_max, rate)
        self.noise_rate = noise_rate
        self.noise_len_mean = noise_len_mean
        self.noise_len_std = noise_len_std

    def _get_noise(self, goal_shape, rng, always_2d=False, use_sample_rate=None):
        agg_noise = np.zeros(goal_shape)
        len_dim = len(goal_shape) - 1
        is_2d = len(goal_shape) == 2

        n_noises = round(self.noise_rate * goal_shape[len_dim] / use_sample_rate)
        start_pointers = [
            round(rand_uniform(rng, 0, goal_shape[len_dim]))
            for _ in range(n_noises)
        ]
        for start_pointer in start_pointers:
            noise_shape = list(goal_shape)
            len_seconds = float(rng.normal(self.noise_len_mean,
                                           self.noise_len_std))
            noise_shape[len_dim] = round(max(0, len_seconds) * use_sample_rate)
            end_pointer = start_pointer + noise_shape[len_dim]
            if end_pointer >= goal_shape[len_dim]:
                continue
            noise = self.pick_sample(tuple(noise_shape), rng, always_2d,
                                     use_sample_rate)
            if is_2d:
                agg_noise[:, start_pointer:end_pointer] += noise
            else:
                agg_noise[start_pointer:end_pointer] += noise
        return agg_noise


class ConcatAugment:
    """Pick a second sample index to concatenate onto sample `index`
    (concataugment.py:13-61): gated by `rate`, skipped when the base sample
    already exceeds `max_tokens`, up to `attempts` rejection-sampling tries
    for a distinct partner that keeps the total under `max_tokens`."""

    def __init__(self, rate: float = 0.25, max_tokens: int = 3000,
                 attempts: int = 5):
        self.rate, self.max_tokens, self.attempts = rate, max_tokens, attempts

    def find_indices(self, index: int, n_frames: Sequence[int],
                     n_samples: int, rng) -> List[int]:
        if rng.random() > self.rate:
            return [index]
        if self.max_tokens and n_frames[index] > self.max_tokens:
            return [index]
        for _ in range(self.attempts):
            index2 = int(rng.integers(0, n_samples))
            if index2 != index and (
                    not self.max_tokens
                    or n_frames[index] + n_frames[index2] < self.max_tokens):
                return [index, index2]
        return [index]


class NoisyOverlapAugment:
    """Overlay a snippet of another in-batch utterance (or of external noise
    with prob `mixing_noise_rate`) at a random SNR (noisyoverlapaugment.py:
    76-112). Operates on the whole batch list; earlier entries augmented in
    this call can be picked as the overlay source for later ones, exactly as
    in the reference's in-place loop."""

    def __init__(self, rate: float = 0.25, mixing_noise_rate: float = 0.1,
                 noise_path: str = "", noise_snr_min: float = -5,
                 noise_snr_max: float = 5, utterance_snr_min: float = -5,
                 utterance_snr_max: float = 5):
        self.rate = rate
        self.mixing_noise_rate = mixing_noise_rate
        # The reference unconditionally builds a NoiseAugmentTransform (and
        # so requires a noise dir even for pure utterance mixing); we only
        # require one if the noise branch is reachable.
        self.noise_shaper = NoiseAugment(noise_path) if noise_path else None
        if mixing_noise_rate > 0 and self.noise_shaper is None:
            raise ValueError(
                "mixing_noise_rate > 0 requires a noise_path directory")
        self.noise_snr_min, self.noise_snr_max = noise_snr_min, noise_snr_max
        self.utterance_snr_min = utterance_snr_min
        self.utterance_snr_max = utterance_snr_max

    def __call__(self, sources: Sequence[np.ndarray], rng) -> List[np.ndarray]:
        sources = [np.asarray(s) for s in sources]
        for i in range(len(sources)):
            if rng.random() > self.rate:
                continue
            pri = np.array(sources[i], dtype=sources[i].dtype)  # copy
            if rng.random() > self.mixing_noise_rate:
                sec = sources[int(rng.integers(0, len(sources)))]
                snr = rand_uniform(rng, self.utterance_snr_min,
                                   self.utterance_snr_max)
            else:
                sec = self.noise_shaper.pick_sample(sources[i].shape, rng)
                snr = rand_uniform(rng, self.noise_snr_min, self.noise_snr_max)

            L1, L2 = pri.shape[-1], sec.shape[-1]
            l = int(rng.integers(0, min(round(L1 / 2), L2)))  # noqa: E741
            s_source = int(rng.integers(0, L1 - l))
            s_sec = int(rng.integers(0, L2 - l))

            if np.mean(sec ** 2) == 0:
                continue
            scl = np.sqrt(np.mean(pri ** 2)
                          / (np.power(10, snr / 10) * np.mean(sec ** 2)))
            pri[s_source:s_source + l] = (
                pri[s_source:s_source + l] + scl * sec[s_sec:s_sec + l])
            sources[i] = pri
        return sources


_WAVEFORM_TRANSFORMS = {
    "noiseaugment": NoiseAugment,
    "musicaugment": MusicAugment,
    "backgroundnoiseaugment": BackgroundNoiseAugment,
    "babbleaugment": BabbleAugment,
    "sporadicnoiseaugment": SporadicNoiseAugment,
}


def _selected(cfg: dict, key: str, is_train: bool) -> List[str]:
    block = (cfg or {}).get(key, {})
    names = list(block.get("*", []))
    names += list(block.get("_train" if is_train else "_eval", []))
    return names


def build_waveform_transforms(cfg: dict, is_train: bool) -> List:
    """Resolve the `waveform_transforms` block of a data config YAML
    (reference S2TDataConfig.get_waveform_transforms, data_cfg.py:168)."""
    out = []
    for name in _selected(cfg, "waveform_transforms", is_train):
        klass = _WAVEFORM_TRANSFORMS.get(name)
        if klass is None:
            raise ValueError(f"unknown waveform transform: {name}")
        c = dict(cfg.get(name, {}))
        c["samples_path"] = c.pop("samples_path", None)
        out.append(klass(**c))
    return out


def build_dataset_transforms(cfg: dict, is_train: bool) -> List:
    """Resolve the `dataset_transforms` block of a data config YAML
    (reference S2TDataConfig.get_dataset_transforms, data_cfg.py:173)."""
    out = []
    for name in _selected(cfg, "dataset_transforms", is_train):
        c = cfg.get(name, {})
        if name == "concataugment":
            out.append(ConcatAugment(
                rate=c.get("rate", 0.25),
                max_tokens=c.get("max_tokens", 3000),
                attempts=c.get("attempts", 5)))
        elif name == "noisyoverlapaugment":
            out.append(NoisyOverlapAugment(
                rate=c.get("rate", 0.25),
                mixing_noise_rate=c.get("mixing_noise_rate", 0.1),
                noise_path=c.get("noise_path", ""),
                noise_snr_min=c.get("noise_snr_min", -5),
                noise_snr_max=c.get("noise_snr_max", 5),
                utterance_snr_min=c.get("utterance_snr_min", -5),
                utterance_snr_max=c.get("utterance_snr_max", 5)))
        else:
            raise ValueError(f"unknown dataset transform: {name}")
    return out


def get_transform(transforms: Sequence, klass):
    """First transform of type `klass` or None (reference
    AudioDatasetTransforms.{has,get}_transform)."""
    for t in transforms or []:
        if isinstance(t, klass):
            return t
    return None
