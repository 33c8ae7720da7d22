"""The unit dictionary (the port's copy of what the training stages use of
diffnorm_tpu/data/dictionary.py): bos=0 <s>, pad=1 <pad>, eos=2 </s>,
unk=3 <unk>, then the units 0..K-1, so unit k is index k + 4."""

from __future__ import annotations


class Dictionary:
    nspecial = 4  # <s> <pad> </s> <unk>

    def __init__(self, num_units: int):
        self.num_units = num_units

    def __len__(self) -> int:
        return self.nspecial + self.num_units

    @classmethod
    def unit_dictionary(cls, num_units: int) -> "Dictionary":
        """Units 0..num_units-1; len == num_units + 4."""
        return cls(num_units)
