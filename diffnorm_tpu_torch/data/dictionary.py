"""The unit dictionary (the port's copy of what training and generation use
of diffnorm_tpu/data/dictionary.py): bos=0 <s>, pad=1 <pad>, eos=2 </s>,
unk=3 <unk>, then the units "0".."K-1", so unit k is index k + 4."""

from __future__ import annotations

import numpy as np

SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")
EOS, UNK = 2, 3


class Dictionary:
    nspecial = len(SPECIALS)

    def __init__(self, num_units: int):
        self.num_units = num_units
        self.symbols = list(SPECIALS) + [str(u) for u in range(num_units)]
        self.indices = {s: i for i, s in enumerate(self.symbols)}

    def __len__(self) -> int:
        return len(self.symbols)

    def __getitem__(self, idx: int) -> str:
        """The symbol of an index; <unk> out of range."""
        return self.symbols[idx] if 0 <= idx < len(self.symbols) else SPECIALS[UNK]

    @classmethod
    def unit_dictionary(cls, num_units: int) -> "Dictionary":
        """Units 0..num_units-1; len == num_units + 4."""
        return cls(num_units)

    def encode_line(self, line: str, append_eos: bool = True) -> np.ndarray:
        """The indices of a space-separated symbol line (an unknown symbol
        is <unk>), </s> appended where `append_eos`; int32."""
        ids = [self.indices.get(w, UNK) for w in line.split()]
        if append_eos:
            ids.append(EOS)
        return np.asarray(ids, dtype=np.int32)
