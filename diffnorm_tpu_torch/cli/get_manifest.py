"""Wav-manifest builder (the port's copy of diffnorm_tpu/cli/get_manifest.py).

Indexes every `*.{ext}` under ROOT (recursively) into a wav2vec-style
manifest: the root directory on the first line, then `relpath\\tn_frames` per
file, the format `cli.prepare dump-features --manifest` reads.

  python -m diffnorm_tpu_torch.cli.get_manifest ROOT --dest out/train.tsv --ext wav
"""

from __future__ import annotations

import argparse
import glob
import os


def wav_frames(path: str) -> int:
    """Sample frames of an audio file: soundfile where it is installed,
    else a WAV header through `wave`."""
    try:
        import soundfile as sf

        return sf.info(path).frames
    except ImportError:
        import wave

        with wave.open(path, "rb") as w:
            return w.getnframes()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("root", metavar="DIR")
    p.add_argument("--dest", default="train.tsv")
    p.add_argument("--ext", default="wav")
    p.add_argument("--path-must-contain", default=None)
    args = p.parse_args(argv)

    dest_dir = os.path.dirname(args.dest)
    if dest_dir:
        os.makedirs(dest_dir, exist_ok=True)
    root = os.path.realpath(args.root)
    n = 0
    with open(args.dest, "w") as f:
        print(root, file=f)
        for fname in sorted(glob.iglob(os.path.join(root, "**/*." + args.ext), recursive=True)):
            path = os.path.realpath(fname)
            if args.path_must_contain and args.path_must_contain not in path:
                continue
            print(f"{os.path.relpath(path, root)}\t{wav_frames(path)}", file=f)
            n += 1
    print(f"wrote {n} entries -> {args.dest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
