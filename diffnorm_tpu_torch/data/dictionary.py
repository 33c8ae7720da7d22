"""Symbol dictionaries (the port's copy of what training and generation use
of diffnorm_tpu/data/dictionary.py): bos=0 <s>, pad=1 <pad>, eos=2 </s>,
unk=3 <unk>, then the symbols. The unit dictionary's symbols are the units
"0".."K-1", so unit k is index k + 4; `load` reads a fairseq dictionary file
(`symbol count` lines, the multitask tasks' letter dictionaries, the S2T
and TTS tasks' dict.txt); `add_symbol` grows one (the TTS task's dictionary
built from its training text)."""

from __future__ import annotations

from typing import Iterable

import numpy as np

SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")
BOS, EOS, UNK = 0, 2, 3


class Dictionary:
    nspecial = len(SPECIALS)

    def __init__(self, num_units: int = 0, symbols: Iterable[str] = ()):
        """The specials, the units "0".."num_units-1", then `symbols`; a
        symbol already present keeps its first index."""
        self.symbols, self.indices = [], {}
        for sym in [*SPECIALS, *(str(u) for u in range(num_units)), *symbols]:
            if sym not in self.indices:
                self.indices[sym] = len(self.symbols)
                self.symbols.append(sym)

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
        symbol alone)."""
        symbols = []
        with open(path) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                sym, space, count = line.rpartition(" ")
                try:
                    int(count)
                except ValueError:
                    space = ""
                symbols.append(sym if space else line)
        return cls(symbols=symbols)

    def add_symbol(self, sym: str) -> int:
        """The index of `sym`, appended where it is new."""
        if sym not in self.indices:
            self.indices[sym] = len(self.symbols)
            self.symbols.append(sym)
        return self.indices[sym]

    def index(self, sym: str) -> int:
        return self.indices.get(sym, UNK)

    def bos(self) -> int:
        return BOS

    def unk(self) -> int:
        return UNK

    def encode_line(self, line: str, append_eos: bool = True) -> np.ndarray:
        """The indices of a space-separated symbol line (an unknown symbol
        is <unk>), </s> appended where `append_eos`; int32."""
        ids = [self.indices.get(w, UNK) for w in line.split()]
        if append_eos:
            ids.append(EOS)
        return np.asarray(ids, dtype=np.int32)
