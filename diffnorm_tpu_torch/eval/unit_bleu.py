"""Unit BLEU (the port's copy of diffnorm_tpu/eval/unit_bleu.py): parse
`generate-{split}.txt` (H-/T-/D- lines) into `hyp.unit` / `ref.unit` and
score them, or score two id-keyed unit files.

  python -m diffnorm_tpu_torch.eval.unit_bleu R/generate-test.txt R
  python -m diffnorm_tpu_torch.eval.unit_bleu HYP.unit REF.unit [--allow-partial]

The score comes from `eval.bleu.corpus_bleu`: sacrebleu where it imports,
the port's counters otherwise.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Dict, Tuple

from diffnorm_tpu_torch.eval.bleu import corpus_bleu

logger = logging.getLogger(__name__)


def parse_generate_output(path: str) -> Tuple[Dict[int, str], Dict[int, str]]:
    """-> ({id: hyp_units}, {id: ref_units})"""
    hyps, refs = {}, {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("H-"):
                parts = line.split("\t")
                hyps[int(parts[0][2:])] = parts[2] if len(parts) > 2 else ""
            elif line.startswith("T-"):
                sid, text = line.split("\t", 1)
                refs[int(sid[2:])] = text
    return hyps, refs


def extract_unit_files(generate_path: str, out_dir: str) -> Tuple[str, str]:
    """Write hyp.unit / ref.unit (`id\\tunits` lines) sorted by sentence id."""
    hyps, refs = parse_generate_output(generate_path)
    os.makedirs(out_dir, exist_ok=True)
    hyp_path = os.path.join(out_dir, "hyp.unit")
    ref_path = os.path.join(out_dir, "ref.unit")
    ids = sorted(set(hyps) & set(refs))
    with open(hyp_path, "w") as hf, open(ref_path, "w") as rf:
        for i in ids:
            hf.write(f"{i}\t{hyps[i]}\n")
            rf.write(f"{i}\t{refs[i]}\n")
    return hyp_path, ref_path


def unit_bleu(generate_path: str) -> float:
    hyps, refs = parse_generate_output(generate_path)
    ids = sorted(set(hyps) & set(refs))
    return corpus_bleu([refs[i] for i in ids], [hyps[i] for i in ids])


def read_unit_lines(path: str) -> Dict[str, str]:
    """`id|u1 u2 ...` unit files (cli.s2st's `s2st-{split}.unit`) or a
    translation manifest `{split}.tsv` (its tgt_audio column) ->
    {utt_id: unit string}."""
    if path.endswith(".tsv"):
        from diffnorm_tpu_torch.data.manifest import read_translation_manifest

        return {r["id"]: r["tgt_audio"] for r in read_translation_manifest(path)}
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and "|" in line:
                uid, units = line.split("|", 1)
                out[uid] = units
    return out


def unit_files_bleu(hyp_path: str, ref_path: str, allow_partial: bool = False) -> float:
    """Corpus BLEU between two id-keyed unit files, joined by utterance id.
    Every reference id must have a hypothesis unless `allow_partial`, which
    scores the intersection (with a warning)."""
    hyps, refs = read_unit_lines(hyp_path), read_unit_lines(ref_path)
    ids = sorted(set(hyps) & set(refs))
    logger.info("unit BLEU join: %d hyp ids, %d ref ids, %d common",
                len(hyps), len(refs), len(ids))
    if not ids:
        raise SystemExit(f"no shared utterance ids between {hyp_path} and {ref_path}")
    missing = sorted(set(refs) - set(hyps))
    if missing:
        msg = (f"{len(missing)}/{len(refs)} reference ids have no "
               f"hypothesis in {hyp_path} (first: {missing[:5]})")
        if not allow_partial:
            raise SystemExit(msg + " — refusing to score a subset; pass --allow-partial "
                             "to override")
        logger.warning("%s — scoring the intersection (--allow-partial)", msg)
    extra = len(hyps) - len(ids)
    if extra:
        logger.warning("%d hypothesis ids not in the reference are ignored", extra)
    return corpus_bleu([refs[i] for i in ids], [hyps[i] for i in ids])


def _is_generate_txt(path: str) -> bool:
    with open(path) as f:
        for line in f:
            if line.startswith(("H-", "T-", "D-", "S-")):
                return True
            if "|" in line or "\t" in line:
                return False
    return False


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    argv = list(sys.argv[1:] if argv is None else argv)
    allow_partial = "--allow-partial" in argv
    argv = [a for a in argv if a != "--allow-partial"]
    if not argv:
        raise SystemExit("usage: unit_bleu GENERATE_TXT [OUT_DIR] | unit_bleu HYP REF "
                         "[--allow-partial]")
    path = argv[0]
    if _is_generate_txt(path):
        out_dir = argv[1] if len(argv) > 1 else os.path.dirname(path)
        extract_unit_files(path, out_dir)
        print(f"unit BLEU: {unit_bleu(path):.2f}")
    else:
        if len(argv) < 2:
            raise SystemExit(f"{path} is a unit-lines file; a reference unit file is "
                             "required: unit_bleu HYP REF")
        print(f"unit BLEU: {unit_files_bleu(path, argv[1], allow_partial):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
