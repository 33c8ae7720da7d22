"""Symbol dictionaries (the port's copy of diffnorm_tpu/data/dictionary.py):
bos=0 <s>, pad=1 <pad>, eos=2 </s>, unk=3 <unk>, then the symbols, each
with its count. The unit dictionary's symbols are the units "0".."K-1", so
unit k is index k + 4; `load` reads a fairseq dictionary file (`symbol
count` lines: the multitask tasks' letter dictionaries, the S2T and TTS
tasks' dict.txt, cli.preprocess's dict.{lang}.txt) and `save` writes one,
the symbols after the specials with their counts, byte for byte as JAX's;
`add_symbol` grows one and counts (cli.preprocess's `build_dictionary`, the
TTS task's dictionary built from its training text)."""

from __future__ import annotations

from typing import Iterable

import numpy as np

SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")
BOS, PAD, EOS, UNK = 0, 1, 2, 3


class Dictionary:
    nspecial = len(SPECIALS)

    def __init__(self, num_units: int = 0, symbols: Iterable[str] = ()):
        """The specials, the units "0".."num_units-1", then `symbols`, each
        counted once; a symbol already present keeps its first index."""
        self.symbols, self.count, self.indices = [], [], {}
        for sym in [*SPECIALS, *(str(u) for u in range(num_units)), *symbols]:
            self.add_symbol(sym)

    def __len__(self) -> int:
        return len(self.symbols)

    def __getitem__(self, idx: int) -> str:
        """The symbol of an index; <unk> out of range."""
        return self.symbols[idx] if 0 <= idx < len(self.symbols) else SPECIALS[UNK]

    @classmethod
    def unit_dictionary(cls, num_units: int) -> "Dictionary":
        """Units 0..num_units-1; len == num_units + 4."""
        return cls(num_units)

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        """A fairseq dictionary file: one `symbol count` line per symbol (a
        line without a count, or whose last field is not an integer, is the
        symbol alone, counted once); a repeated symbol adds its count."""
        d = cls()
        with open(path) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                sym, space, count = line.rpartition(" ")
                try:
                    n = int(count)
                except ValueError:
                    space = ""
                if not space:
                    sym, n = line, 1
                d.add_symbol(sym, n)
        return d

    def save(self, path: str) -> None:
        """Write the symbols after the specials as `symbol count` lines."""
        with open(path, "w") as f:
            for sym, n in zip(self.symbols[self.nspecial:], self.count[self.nspecial:]):
                f.write(f"{sym} {n}\n")

    def add_symbol(self, sym: str, n: int = 1) -> int:
        """The index of `sym`, appended where it is new; its count grows by n."""
        if sym in self.indices:
            idx = self.indices[sym]
            self.count[idx] += n
            return idx
        self.indices[sym] = len(self.symbols)
        self.symbols.append(sym)
        self.count.append(n)
        return self.indices[sym]

    def index(self, sym: str) -> int:
        return self.indices.get(sym, UNK)

    def bos(self) -> int:
        return BOS

    def unk(self) -> int:
        return UNK

    def encode_line(self, line: str, append_eos: bool = True,
                    add_if_not_exist: bool = False) -> np.ndarray:
        """The indices of a space-separated symbol line (an unknown symbol
        is <unk>, or with `add_if_not_exist` added and counted), </s>
        appended where `append_eos`; int32."""
        words = line.split()
        if add_if_not_exist:
            ids = [self.add_symbol(w) for w in words]
        else:
            ids = [self.indices.get(w, UNK) for w in words]
        if append_eos:
            ids.append(EOS)
        return np.asarray(ids, dtype=np.int32)

    def string(self, tokens, remove_special: bool = True) -> str:
        """The symbols of an index sequence joined by spaces, the specials
        left out where `remove_special`."""
        return " ".join(self[int(i)] for i in np.asarray(tokens).reshape(-1)
                        if not (remove_special and int(i) < self.nspecial))
