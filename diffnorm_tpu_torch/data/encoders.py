"""Tokenizers, BPEs and `post_process` (the port's copy of
diffnorm_tpu/data/encoders.py; reference fairseq/data/encoders/ and
data_utils.post_process).

* tokenizers: space (pure Python); moses (sacremoses) and nltk, gated on
  their packages with JAX's error;
* BPEs: characters, bytes (byte fallback with UTF-8 recovery), subword_nmt
  (the apply-BPE merge loop over a codes file) and gpt2 (byte-level BPE over
  local encoder.json / vocab.bpe files), in pure Python; sentencepiece and
  bert, gated on their packages;
* `post_process(sentence, symbol)`: the detokenization of
  `cli.generate --post-process / --remove-bpe`.

`build_tokenizer(cfg)` / `build_bpe(cfg)` take a mapping (or an object)
with a `tokenizer` / `bpe` key, as the multitask YAML's `pre_tokenizer` and
`bpe_tokenizer` blocks give it. All of it is host-side text processing.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional, Tuple

TOKENIZERS: Dict[str, Callable] = {}
BPES: Dict[str, Callable] = {}


def register_tokenizer(name: str):
    def wrap(cls):
        TOKENIZERS[name] = cls
        return cls
    return wrap


def register_bpe(name: str):
    def wrap(cls):
        BPES[name] = cls
        return cls
    return wrap


def _build(table: Dict[str, Callable], kind: str, cfg):
    name = _get(cfg, kind)
    if not name:
        return None
    if name not in table:
        raise KeyError(f"unknown {kind} {name!r}; known: {sorted(table)}")
    return table[name](cfg)


def build_tokenizer(cfg) -> Optional[object]:
    """cfg's `tokenizer` -> a tokenizer object (None if unset)."""
    return _build(TOKENIZERS, "tokenizer", cfg)


def build_bpe(cfg) -> Optional[object]:
    """cfg's `bpe` -> a BPE object (None if unset)."""
    return _build(BPES, "bpe", cfg)


def _get(cfg, key, default=None):
    if cfg is None:
        return default
    if hasattr(cfg, "get"):
        v = cfg.get(key, default)
        return default if v is None else v
    return getattr(cfg, key, default)


# ---------------------------------------------------------------------------
# post_process — detokenization dispatch
# (reference: fairseq/data/data_utils.py:368-390; parity-tested verbatim)
# ---------------------------------------------------------------------------

def post_process(sentence: str, symbol: Optional[str]) -> str:
    if symbol == "sentencepiece":
        return sentence.replace(" ", "").replace("▁", " ").strip()
    if symbol == "wordpiece":
        return sentence.replace(" ", "").replace("_", " ").strip()
    if symbol == "letter":
        return sentence.replace(" ", "").replace("|", " ").strip()
    if symbol == "silence":
        return re.sub(" +", " ", sentence.replace("<SIL>", "")).strip()
    if symbol == "_EOW":
        return sentence.replace(" ", "").replace("_EOW", " ").strip()
    if symbol in {"subword_nmt", "@@ ", "@@"}:
        sep = "@@ " if symbol == "subword_nmt" else symbol
        return (sentence + " ").replace(sep, "").rstrip()
    if symbol == "none" or symbol is None:
        return sentence
    raise NotImplementedError(f"Unknown post_process option: {symbol}")


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------

@register_tokenizer("space")
class SpaceTokenizer:
    """Whitespace normalization only (reference space_tokenizer.py)."""

    def __init__(self, cfg=None):
        self._ws = re.compile(r"\s+")

    def encode(self, x: str) -> str:
        return self._ws.sub(" ", x)

    def decode(self, x: str) -> str:
        return x


@register_tokenizer("moses")
class MosesTokenizerWrapper:
    """sacremoses tokenize/detokenize (reference moses_tokenizer.py).

    Flags: --source-lang/--target-lang pick the tokenizer languages;
    --moses-no-dash-splits / --moses-no-escape mirror the reference knobs.
    """

    def __init__(self, cfg=None):
        try:
            from sacremoses import MosesDetokenizer, MosesTokenizer
        except ImportError as e:  # pragma: no cover
            raise ImportError("--tokenizer moses needs sacremoses") from e
        self._tok = MosesTokenizer(_get(cfg, "source_lang", "en") or "en")
        self._detok = MosesDetokenizer(_get(cfg, "target_lang", "en") or "en")
        self._dash = not _get(cfg, "moses_no_dash_splits", False)
        self._escape = not _get(cfg, "moses_no_escape", False)

    def encode(self, x: str) -> str:
        return self._tok.tokenize(
            x, aggressive_dash_splits=self._dash, return_str=True,
            escape=self._escape)

    def decode(self, x: str) -> str:
        return self._detok.detokenize(x.split())


@register_tokenizer("nltk")
class NLTKTokenizer:
    def __init__(self, cfg=None):
        try:
            from nltk.tokenize import word_tokenize
        except ImportError as e:  # pragma: no cover
            raise ImportError("--tokenizer nltk needs nltk") from e
        self._tok = word_tokenize

    def encode(self, x: str) -> str:
        return " ".join(self._tok(x))

    def decode(self, x: str) -> str:
        return x


# ---------------------------------------------------------------------------
# Byte/char fallback vocabularies (reference characters.py / bytes.py /
# byte_utils.py — format constants are fixed by trained-model compat)
# ---------------------------------------------------------------------------

_SPACE = chr(32)
_SPACE_ESCAPE = chr(9601)  # lower one-eighth block, same as sentencepiece
# byte values rendered as themselves; the rest shifted past the BMP latin
# range so every byte is a single printable char (byte_utils.py mapping)
_PRINTABLE = frozenset(range(32, 127)) | frozenset(range(161, 173)) \
    | frozenset(range(174, 256))
_BYTE_TO_CHAR = {b: (chr(b) if b in _PRINTABLE else chr(256 + b))
                 for b in range(256)}
_CHAR_TO_BYTE = {c: b for b, c in _BYTE_TO_CHAR.items()}


def byte_encode(x: str) -> str:
    x = re.sub(r"\s+", _SPACE, x)
    return "".join(_BYTE_TO_CHAR[b] for b in x.encode("utf-8"))


def byte_decode(x: str) -> str:
    try:
        return bytes(_CHAR_TO_BYTE[c] for c in x).decode("utf-8")
    except (ValueError, KeyError):
        return ""


def smart_byte_decode(x: str) -> str:
    """byte_decode with best-effort recovery of broken UTF-8: dynamic
    program maximizing the number of decodable characters (reference
    byte_utils.smart_byte_decode)."""
    out = byte_decode(x)
    if out != "" or not x:
        return out
    n = len(x)
    best = [0] * (n + 1)
    back = [0] * (n + 1)
    for i in range(1, n + 1):
        best[i], back[i] = best[i - 1], i - 1
        for j in range(1, min(4, i) + 1):
            if best[i - j] + 1 > best[i] and byte_decode(x[i - j:i]) != "":
                best[i], back[i] = best[i - j] + 1, i - j
    pieces: List[str] = []
    i = n
    while i > 0:
        if best[i] == best[back[i]] + 1:
            pieces.append(byte_decode(x[back[i]:i]))
        i = back[i]
    return "".join(reversed(pieces))


@register_bpe("characters")
class Characters:
    def __init__(self, cfg=None):
        pass

    def encode(self, x: str) -> str:
        return _SPACE.join(x.replace(_SPACE, _SPACE_ESCAPE))

    def decode(self, x: str) -> str:
        return x.replace(_SPACE, "").replace(_SPACE_ESCAPE, _SPACE)


@register_bpe("bytes")
class Bytes:
    def __init__(self, cfg=None):
        pass

    def encode(self, x: str) -> str:
        return _SPACE.join(byte_encode(x).replace(_SPACE, _SPACE_ESCAPE))

    def decode(self, x: str) -> str:
        return smart_byte_decode(
            x.replace(_SPACE, "").replace(_SPACE_ESCAPE, _SPACE))


# ---------------------------------------------------------------------------
# subword-nmt BPE: the apply-BPE merge loop in pure Python (the reference
# wraps the subword-nmt package in subword_nmt_bpe.py; the codes-file format
# and merge semantics follow the public subword-nmt spec, version 0.2)
# ---------------------------------------------------------------------------

class _BPEMerger:
    """Greedy lowest-rank pair merging over a symbol tuple."""

    def __init__(self, ranks: Dict[Tuple[str, str], int]):
        self.ranks = ranks

    def merge(self, syms: Tuple[str, ...]) -> Tuple[str, ...]:
        while len(syms) > 1:
            pairs = set(zip(syms[:-1], syms[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(syms):
                if (i < len(syms) - 1
                        and (syms[i], syms[i + 1]) == best):
                    merged.append(syms[i] + syms[i + 1])
                    i += 2
                else:
                    merged.append(syms[i])
                    i += 1
            syms = tuple(merged)
        return syms


@register_bpe("subword_nmt")
class SubwordNMTBPE:
    """Apply subword-nmt BPE codes (--bpe-codes; separator --bpe-separator).

    Word-final symbols carry an end-of-word marker during merging (v0.2
    codes semantics: the marker is glued to the final character; v0.1:
    a standalone symbol). Output joins word-internal segments with
    `separator + " "` — the stream `--post-process subword_nmt` inverts.
    """

    EOW = "</w>"

    def __init__(self, cfg=None, codes_path: Optional[str] = None,
                 separator: Optional[str] = None):
        path = codes_path or _get(cfg, "bpe_codes")
        if not path:
            raise ValueError("--bpe subword_nmt requires --bpe-codes")
        self.separator = separator or _get(cfg, "bpe_separator", "@@")
        self.version, self.ranks = self._read_codes(path)
        self._merger = _BPEMerger(self.ranks)
        self._cache: Dict[str, Tuple[str, ...]] = {}

    @staticmethod
    def _read_codes(path: str) -> Tuple[Tuple[int, int],
                                        Dict[Tuple[str, str], int]]:
        ranks: Dict[Tuple[str, str], int] = {}
        version = (0, 1)
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        body = lines
        if lines and lines[0].startswith("#version:"):
            ver = lines[0].split("#version:")[-1].strip()
            parts = ver.split(".")
            version = (int(parts[0]), int(parts[1]))
            body = lines[1:]
        for i, line in enumerate(body):
            fields = line.strip("\r\n ").split(" ")
            if len(fields) != 2:
                continue
            pair = (fields[0], fields[1])
            ranks.setdefault(pair, i)  # first occurrence wins
        return version, ranks

    def _segment_word(self, word: str) -> Tuple[str, ...]:
        if not word:
            return ()
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self.version >= (0, 2):
            syms: Tuple[str, ...] = tuple(word[:-1]) + (word[-1] + self.EOW,)
        else:
            syms = tuple(word) + (self.EOW,)
        syms = self._merger.merge(syms)
        # strip the end-of-word marker from the final symbol
        if syms and syms[-1] == self.EOW:
            syms = syms[:-1]
        elif syms and syms[-1].endswith(self.EOW):
            syms = syms[:-1] + (syms[-1][:-len(self.EOW)],)
        self._cache[word] = syms
        return syms

    def encode(self, x: str) -> str:
        out: List[str] = []
        for word in x.split():
            segs = self._segment_word(word)
            out.extend(s + self.separator for s in segs[:-1])
            if segs:
                out.append(segs[-1])
        return " ".join(out)

    def decode(self, x: str) -> str:
        return post_process(x, self.separator + " ")


# ---------------------------------------------------------------------------
# GPT-2 byte-level BPE — native implementation over the public
# encoder.json / vocab.bpe asset format (reference gpt2_bpe.py +
# vendored gpt2_bpe_utils.py)
# ---------------------------------------------------------------------------

def gpt2_bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 reversible byte<->unicode-char table: printable bytes map
    to themselves, the rest to 256+k in first-seen order."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table: Dict[int, str] = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


@register_bpe("gpt2")
class GPT2BPE:
    """Byte-level BPE over --gpt2-encoder-json / --gpt2-vocab-bpe assets.

    encode -> space-joined token-id strings; decode inverts (reference
    gpt2_bpe.py:encode/decode). The asset paths must be local files (the
    reference defaults to download URLs).
    """

    def __init__(self, cfg=None, encoder_json: Optional[str] = None,
                 vocab_bpe: Optional[str] = None):
        encoder_json = encoder_json or _get(cfg, "gpt2_encoder_json")
        vocab_bpe = vocab_bpe or _get(cfg, "gpt2_vocab_bpe")
        if not encoder_json or not vocab_bpe:
            raise ValueError(
                "--bpe gpt2 requires local --gpt2-encoder-json and "
                "--gpt2-vocab-bpe paths")
        with open(encoder_json, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(vocab_bpe, encoding="utf-8") as f:
            merge_lines = f.read().split("\n")[1:-1]
        ranks = {}
        for i, line in enumerate(merge_lines):
            a, b = line.split()
            ranks.setdefault((a, b), i)
        self._merger = _BPEMerger(ranks)
        self._byte_enc = gpt2_bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self._cache: Dict[str, List[str]] = {}
        try:
            import regex
            self._pat = regex.compile(
                r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
                r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
            self._findall = self._pat.findall
        except ImportError:  # pragma: no cover
            self._findall = re.compile(
                r"'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\s\w]+|\s+").findall

    def _bpe_token(self, token: str) -> List[str]:
        hit = self._cache.get(token)
        if hit is None:
            hit = list(self._merger.merge(tuple(token)))
            self._cache[token] = hit
        return hit

    def encode_ids(self, x: str) -> List[int]:
        ids: List[int] = []
        for piece in self._findall(x):
            mapped = "".join(self._byte_enc[b] for b in piece.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe_token(mapped))
        return ids

    def encode(self, x: str) -> str:
        return " ".join(str(i) for i in self.encode_ids(x))

    def decode(self, x: str) -> str:
        toks = [t if t in {"<unk>", "<mask>"} else int(t)
                for t in x.split()]
        text = "".join(
            t if isinstance(t, str) else self.decoder[t] for t in toks)
        return bytes(
            self._byte_dec[c] for c in text if c in self._byte_dec
        ).decode("utf-8", errors="replace")

    def is_beginning_of_word(self, x: str) -> bool:
        return self.decode(x).startswith(" ")


# ---------------------------------------------------------------------------
# Import-gated wrappers around optional third-party tokenizers
# ---------------------------------------------------------------------------

@register_bpe("sentencepiece")
class SentencepieceBPE:
    def __init__(self, cfg=None):
        try:
            import sentencepiece as spm
        except ImportError as e:  # pragma: no cover
            raise ImportError("--bpe sentencepiece needs sentencepiece") from e
        model = _get(cfg, "sentencepiece_model")
        if not model:
            raise ValueError("--bpe sentencepiece requires "
                             "--sentencepiece-model")
        self.sp = spm.SentencePieceProcessor()
        self.sp.Load(model)
        self.enable_sampling = _get(cfg, "sentencepiece_enable_sampling",
                                    False)
        self.alpha = _get(cfg, "sentencepiece_alpha")

    def encode(self, x: str) -> str:
        return " ".join(self.sp.Encode(
            x, out_type=str, enable_sampling=self.enable_sampling,
            alpha=self.alpha))

    def decode(self, x: str) -> str:
        return post_process(x, "sentencepiece")

    def is_beginning_of_word(self, x: str) -> bool:
        if x in ("<unk>", "<s>", "</s>", "<pad>"):
            return True
        return x.startswith("▁")


@register_bpe("bert")
class BertBPE:
    """HuggingFace BertTokenizer over a LOCAL --bpe-vocab-file
    (reference hf_bert_bpe.py; the vocab file is required: nothing is
    downloaded)."""

    def __init__(self, cfg=None):
        try:
            from transformers import BertTokenizer
        except ImportError as e:  # pragma: no cover
            raise ImportError("--bpe bert needs transformers") from e
        vocab = _get(cfg, "bpe_vocab_file")
        if not vocab:
            raise ValueError("--bpe bert requires a local --bpe-vocab-file "
                             "(nothing is downloaded)")
        self.tok = BertTokenizer(
            vocab, do_lower_case=not _get(cfg, "bpe_cased", False))

    def encode(self, x: str) -> str:
        return " ".join(self.tok.tokenize(x))

    def decode(self, x: str) -> str:
        return self.tok.clean_up_tokenization(
            self.tok.convert_tokens_to_string(x.split(" ")))

    def is_beginning_of_word(self, x: str) -> bool:
        return not x.startswith("##")


def decode_fn(x: str, bpe=None, tokenizer=None) -> str:
    """hyp-string -> human text: invert BPE then the tokenizer
    (reference fairseq_cli/interactive.py decode_fn)."""
    if bpe is not None:
        x = bpe.decode(x)
    if tokenizer is not None:
        x = tokenizer.decode(x)
    return x


def encode_fn(x: str, bpe=None, tokenizer=None) -> str:
    """raw text -> model-facing token string: tokenizer then BPE
    (reference fairseq_cli/interactive.py encode_fn)."""
    if tokenizer is not None:
        x = tokenizer.encode(x)
    if bpe is not None:
        x = bpe.encode(x)
    return x
