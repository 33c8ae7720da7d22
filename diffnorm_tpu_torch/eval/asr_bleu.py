"""ASR-BLEU: transcribe generated waveforms with a wav2vec2-CTC model and
score them against reference transcripts (the port's copy of
diffnorm_tpu/eval/asr_bleu.py; reference
examples/speech_to_speech/asr_bleu/ utils.py:47-299 and
compute_asr_bleu_custom.py:129-186).

  python -m diffnorm_tpu_torch.eval.asr_bleu --audio-dir R/wav \\
      --reference-path REF --lang en --asr-model ASR_DIR [--cpu]

The recognizer is the port's own (`models/wav2vec2_ctc.py`), read from a
local Hugging Face checkpoint directory; greedy CTC decoding, text
normalization (lowercase, punctuation stripped) and corpus BLEU
(`eval/bleu.py:corpus_bleu`: sacrebleu where it imports, the counters
otherwise). With no --asr-model, or a hub id, the language's default model
is looked up in the local Hugging Face cache
($HF_HOME/hub/models--{org}--{name}/snapshots/*/); nothing is downloaded.
The recognizer runs in float32 (TF32 off) on the GPU unless --cpu is given.
"""

from __future__ import annotations

import glob
import logging
import os
import re
import string
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from diffnorm_tpu_torch.data.audio import read_audio
from diffnorm_tpu_torch.device import resolve_device
from diffnorm_tpu_torch.models.wav2vec2_ctc import (
    ctc_decode,
    load_ctc_checkpoint,
    normalize_waveform,
)

logger = logging.getLogger(__name__)

# per-language default CTC checkpoints (reference asr_bleu/asr_model_cfgs.json)
DEFAULT_ASR_MODELS = {
    "en": "facebook/wav2vec2-large-960h-lv60-self",
    "es": "jonatasgrosman/wav2vec2-large-xlsr-53-spanish",
    "fr": "jonatasgrosman/wav2vec2-large-xlsr-53-french",
}
MIN_SAMPLES = 640  # 40 ms: below it the conv extractor's receptive field underflows


def normalize_text(text: str) -> str:
    """Lowercase + strip punctuation (reference utils.py text post-process)."""
    text = text.lower()
    text = re.sub(rf"[{re.escape(string.punctuation)}]", " ", text)
    return " ".join(text.split())


def resolve_asr_model(lang: str, model_name: Optional[str] = None) -> str:
    """A local checkpoint directory: `model_name` where it is one, else the
    hub id (`model_name`, or the language's default) in the local Hugging
    Face cache. Raises FileNotFoundError naming where it looked."""
    if model_name and os.path.isdir(model_name):
        return model_name
    name = model_name or DEFAULT_ASR_MODELS[lang]
    hf_home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache"), "huggingface")
    pattern = os.path.join(hf_home, "hub", "models--" + name.replace("/", "--"), "snapshots", "*")
    found = sorted(d for d in glob.glob(pattern)
                   if os.path.exists(os.path.join(d, "config.json")))
    if not found:
        raise FileNotFoundError(
            f"ASR model {name!r}: no local checkpoint directory (looked for {pattern}); "
            "pass --asr-model DIR. Nothing is downloaded.")
    return found[-1]


class ASRGenerator:
    def __init__(self, lang: str = "en", model_name: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        ckpt = load_ctc_checkpoint(resolve_asr_model(lang, model_name), self.device)
        self.model, self.vocab, self.tokenizer = ckpt.model, ckpt.vocab, ckpt.tokenizer
        self.sampling_rate = int(ckpt.preprocessor.get("sampling_rate", 16000))
        self.do_normalize = bool(ckpt.preprocessor.get("do_normalize", True))

    @torch.no_grad()
    def logits(self, waveform: np.ndarray, sample_rate: int = 16000) -> torch.Tensor:
        """[frames, vocab] float32 CTC logits of one utterance."""
        if sample_rate != self.sampling_rate:
            raise ValueError(f"the ASR model takes {self.sampling_rate} Hz audio, "
                             f"not {sample_rate} Hz")
        x = (normalize_waveform(waveform) if self.do_normalize
             else np.asarray(waveform, dtype=np.float32))
        return self.model(torch.from_numpy(x)[None].to(self.device))[0]

    def transcribe(self, waveform: np.ndarray, sample_rate: int = 16000) -> str:
        ids = self.logits(waveform, sample_rate).argmax(dim=-1).cpu().tolist()
        return normalize_text(ctc_decode(ids, self.vocab, self.tokenizer))

    def transcribe_file(self, path: str) -> str:
        wav, sr = read_audio(path)
        if len(wav) < MIN_SAMPLES:
            # a degenerate synthesis (an empty decoded unit stream) scores
            # as an empty transcript
            logger.warning("%s: %d samples < 40 ms; scoring empty", path, len(wav))
            return ""
        return self.transcribe(wav, sr)


def read_references(reference_path: str,
                    ids_path: Optional[str] = None) -> Tuple[List[str], Optional[List[str]]]:
    """-> (normalized transcripts, utt ids or None). An id-keyed TSV
    (`utt_id\\ttranscript` on every line, ids without spaces) gives its
    ids; plain lines take them from `ids_path` (one per line, same order)
    where given, else None."""
    with open(reference_path) as f:
        lines = [line.rstrip("\n") for line in f if line.strip()]
    ids: Optional[List[str]] = None
    if lines and all("\t" in line for line in lines):
        first = [line.split("\t", 1)[0] for line in lines]
        if all(tok and " " not in tok for tok in first):
            ids = first
            lines = [line.split("\t", 1)[1] for line in lines]
    refs = [normalize_text(line) for line in lines]
    if ids_path:
        if ids is not None:
            logger.info("references are id-keyed; ignoring --ids-file")
        else:
            with open(ids_path) as f:
                ids = [line.strip() for line in f if line.strip()]
            if len(ids) != len(refs):
                raise ValueError(f"{ids_path}: {len(ids)} ids vs {len(refs)} reference "
                                 f"transcripts in {reference_path}")
    return refs, ids


def run_asr_bleu(audio_dir: str, reference_path: str, lang: str = "en",
                 audio_format: str = "{i}_pred.wav", model_name: Optional[str] = None,
                 ids_path: Optional[str] = None,
                 device="cuda") -> Tuple[float, List[str], List[str]]:
    """Transcribe the waveforms of `audio_dir` against the reference
    transcripts; returns (bleu, transcripts, references).

    A waveform pairs with its transcript by utterance id where the
    references give ids (`audio_format.format(i=uid)`), else by position
    with index-named `{0..N-1}_pred.wav` files. If none of the expected
    files exists, it raises rather than guess a positional pairing. A
    missing waveform scores as an empty transcript."""
    from diffnorm_tpu_torch.eval.bleu import corpus_bleu

    refs, ref_ids = read_references(reference_path, ids_path)
    keys = ref_ids if ref_ids is not None else range(len(refs))
    paths = [os.path.join(audio_dir, audio_format.format(i=k)) for k in keys]
    present = [os.path.exists(p) for p in paths]
    if paths and not any(present):
        raise FileNotFoundError(
            f"none of the {len(paths)} expected waveforms exist under "
            f"{audio_dir} (first: {paths[0]}). If the waveforms are named "
            "by utterance id (cli.s2st output), the references must be "
            "joinable by id: use id-keyed `utt_id\\ttranscript` reference "
            "lines or pass --ids-file with the manifest-order utt ids. "
            "Refusing to guess a positional pairing.")
    asr = ASRGenerator(lang=lang, model_name=model_name, device=device)
    hyps = []
    for path, ok in zip(paths, present):
        if not ok:
            logger.warning("missing %s; scoring empty", path)
            hyps.append("")
            continue
        hyps.append(asr.transcribe_file(path))
    n_missing = len(present) - sum(present)
    if n_missing:
        logger.warning("%d/%d waveforms missing (scored as empty transcripts)",
                       n_missing, len(present))
    bleu = corpus_bleu(refs, hyps)
    logger.info("ASR-BLEU: %.2f over %d utterances", bleu, len(refs))
    return bleu, hyps, refs


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--audio-dir", required=True)
    p.add_argument("--reference-path", required=True)
    p.add_argument("--lang", default="en")
    p.add_argument("--asr-model", default=None,
                   help="a local checkpoint directory (or a hub id in the local cache)")
    p.add_argument("--transcripts-path", default=None)
    p.add_argument("--ids-file", default=None,
                   help="utt ids (one per line) pairing plain-text "
                        "reference lines with {utt_id}_pred.wav files")
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    bleu, hyps, _ = run_asr_bleu(args.audio_dir, args.reference_path, args.lang,
                                 model_name=args.asr_model, ids_path=args.ids_file,
                                 device="cpu" if args.cpu else "cuda")
    if args.transcripts_path:
        with open(args.transcripts_path, "w") as f:
            for h in hyps:
                f.write(h + "\n")
    print(f"ASR-BLEU: {bleu:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
