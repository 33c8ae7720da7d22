"""Indexed datasets in fairseq's binary layouts (the port's copy of
diffnorm_tpu/data/indexed_dataset.py; reference fairseq/data/indexed_dataset.py):
a flat `.bin` of tokens beside an `.idx` header. Host code on numpy memmaps.
The reader sniffs the index magic and takes all three layouts:

* **mmap** (`MMIDIDX\\x00\\x00`, fairseq's default): magic, version <Q>=1,
  dtype code <B>, count <Q>, sizes int32[count], byte pointers
  int64[count]; the .bin holds raw little-endian tokens;
* **legacy / cached** (`TNTIDX\\x00\\x00`, TorchNet): magic, version <Q>=1,
  <QQ> (dtype code, element size), <QQ> (len, s), dim_offsets int64[len+1],
  data_offsets int64[len+1] (in elements), sizes int64[s]; an item may be
  multi-dimensional, and its tokens are stored +1 (Lua indexing), read back
  -1 as fairseq does;
* **native** (`DNTPUIDX1`): the JAX package's first layout.

Writers: `MMapIndexedDatasetBuilder` writes the mmap layout byte for byte as
JAX's (and so fairseq's); `IndexedDatasetBuilder` the native one.
`binarize_file` (cli.preprocess) encodes a line file through a dictionary
into either, the mmap tokens in `best_fitting_int_dtype` of the vocabulary.
"""

from __future__ import annotations

import os
import struct
from typing import List

import numpy as np

NATIVE_MAGIC = b"DNTPUIDX1"
MMAP_MAGIC = b"MMIDIDX\x00\x00"
LEGACY_MAGIC = b"TNTIDX\x00\x00"

# reference _code_to_dtype (indexed_dataset.py:109-120); codes 6/7 are
# np.float/np.double = float64 under the torch builds that wrote them
_CODE_TO_DTYPE = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
    6: np.float64, 7: np.float64, 8: np.uint16, 9: np.uint32, 10: np.uint64,
}
_DTYPE_TO_CODE = {
    np.dtype(np.uint8): 1, np.dtype(np.int8): 2, np.dtype(np.int16): 3,
    np.dtype(np.int32): 4, np.dtype(np.int64): 5, np.dtype(np.float64): 7,
    np.dtype(np.uint16): 8, np.dtype(np.uint32): 9, np.dtype(np.uint64): 10,
}


def best_fitting_int_dtype(max_int_to_represent) -> np.dtype:
    """Smallest dtype that holds the vocabulary (reference
    indexed_dataset.py:22-35; uint64 avoided there too)."""
    if max_int_to_represent is None:
        return np.uint32
    if max_int_to_represent < 65500:
        return np.uint16
    if max_int_to_represent < 4294967295:
        return np.uint32
    return np.int64


def infer_dataset_impl(prefix: str):
    """'mmap' / 'cached' / 'native' / None from the index magic
    (reference infer_dataset_impl:42-59, minus huffman/fasta/raw)."""
    idx = prefix + ".idx"
    if not os.path.exists(idx):
        return None
    with open(idx, "rb") as f:
        magic = f.read(9)
    if magic == MMAP_MAGIC[:9]:
        return "mmap"
    if magic[:8] == LEGACY_MAGIC:
        return "cached"
    if magic == NATIVE_MAGIC:
        return "native"
    return None


class IndexedDatasetBuilder:
    """Round-1 native layout writer (kept for old data; new code should
    prefer MMapIndexedDatasetBuilder for fairseq interchange)."""

    def __init__(self, prefix: str, dtype=np.int32):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        self._bin = open(prefix + ".bin", "wb")
        self._sizes: List[int] = []

    def add_item(self, tokens: np.ndarray):
        arr = np.asarray(tokens, dtype=self.dtype)
        self._bin.write(arr.tobytes())
        self._sizes.append(len(arr))

    def finalize(self):
        self._bin.close()
        with open(self.prefix + ".idx", "wb") as f:
            f.write(NATIVE_MAGIC)
            f.write(struct.pack("<B", self.dtype.itemsize))
            f.write(struct.pack("<q", len(self._sizes)))
            np.asarray(self._sizes, np.int64).tofile(f)


class MMapIndexedDatasetBuilder:
    """fairseq mmap-layout writer (reference MMapIndexedDatasetBuilder +
    Index.writer, indexed_dataset.py:396-431,560-584): .bin streams raw
    tokens; finalize() writes magic, version 1, dtype code, count, int32
    sizes, int64 byte pointers."""

    def __init__(self, prefix: str, dtype=np.int64):
        self.prefix = prefix
        self.dtype = np.dtype(dtype)
        self._bin = open(prefix + ".bin", "wb")
        self._sizes: List[int] = []

    def add_item(self, tokens: np.ndarray):
        arr = np.asarray(tokens, dtype=self.dtype)
        self._bin.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def merge_file_(self, another_prefix: str):
        """Append another mmap dataset (sharded binarization merge)."""
        other = IndexedDataset(another_prefix)
        assert np.dtype(other.dtype) == self.dtype, (other.dtype, self.dtype)
        for i in range(len(other)):
            self._bin.write(np.ascontiguousarray(other[i]).tobytes(order="C"))
            self._sizes.append(int(other.sizes[i]))

    def finalize(self):
        self._bin.close()
        sizes = np.asarray(self._sizes, np.int32)
        pointers = np.zeros(len(self._sizes), np.int64)
        if len(self._sizes) > 1:
            np.cumsum(
                np.asarray(self._sizes[:-1], np.int64) * self.dtype.itemsize,
                out=pointers[1:],
            )
        with open(self.prefix + ".idx", "wb") as f:
            f.write(MMAP_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", _DTYPE_TO_CODE[self.dtype]))
            f.write(struct.pack("<Q", len(self._sizes)))
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))


class IndexedDataset:
    """Reader for all three layouts; zero-copy views via np.memmap."""

    def __init__(self, prefix: str):
        with open(prefix + ".idx", "rb") as f:
            magic = f.read(9)
            if magic == NATIVE_MAGIC:
                itemsize = struct.unpack("<B", f.read(1))[0]
                n = struct.unpack("<q", f.read(8))[0]
                self.sizes = np.fromfile(f, np.int64, n)
                self.dtype = {4: np.int32, 8: np.int64, 2: np.int16}[itemsize]
                self._el_offsets = np.concatenate(
                    [[0], np.cumsum(self.sizes)])
                self._shapes = None
            elif magic == MMAP_MAGIC[:9]:
                (version,) = struct.unpack("<Q", f.read(8))
                assert version == 1, f"unsupported mmap index v{version}"
                (code,) = struct.unpack("<B", f.read(1))
                self.dtype = _CODE_TO_DTYPE[code]
                (n,) = struct.unpack("<Q", f.read(8))
                self.sizes = np.fromfile(f, np.int32, n).astype(np.int64)
                ptrs = np.fromfile(f, np.int64, n)
                itemsize = np.dtype(self.dtype).itemsize
                assert (ptrs % itemsize == 0).all(), "unaligned pointers"
                self._el_offsets = ptrs // itemsize
                self._shapes = None
            elif magic[:8] == LEGACY_MAGIC:
                f.seek(8)
                (version,) = struct.unpack("<Q", f.read(8))
                assert version == 1, f"unsupported legacy index v{version}"
                code, element_size = struct.unpack("<QQ", f.read(16))
                self.dtype = _CODE_TO_DTYPE[code]
                assert np.dtype(self.dtype).itemsize == element_size
                n, s = struct.unpack("<QQ", f.read(16))
                dim_offsets = np.fromfile(f, np.int64, n + 1)
                self._el_offsets = np.fromfile(f, np.int64, n + 1)
                all_sizes = np.fromfile(f, np.int64, s)
                # per-item shape tuples; sizes = total elements per item
                self._shapes = [
                    tuple(all_sizes[dim_offsets[i]:dim_offsets[i + 1]])
                    for i in range(n)
                ]
                self.sizes = np.asarray(
                    [int(np.prod(sh, dtype=np.int64)) for sh in self._shapes],
                    np.int64)
                # the legacy builder writes tokens +1 ("Lua compatibility",
                # reference IndexedDatasetBuilder.add_item:342-344); fairseq
                # reads it back with fix_lua_indexing=True
                # (data_utils.load_indexed_dataset:107-110)
                self._fix_lua = self.dtype not in (np.float64,)
            else:
                raise ValueError(
                    f"unrecognized index magic {magic!r} in {prefix}.idx")
        self._data = np.memmap(prefix + ".bin", dtype=self.dtype, mode="r")

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        item = np.asarray(
            self._data[self._el_offsets[i]: self._el_offsets[i] + self.sizes[i]]
        )
        if item.dtype.kind in "iu" and item.dtype.itemsize < 4:
            # fairseq casts to long on read (MMapIndexedDataset.__getitem__);
            # int32 is plenty for token ids and half the memory
            item = item.astype(np.int32)
        if getattr(self, "_fix_lua", False):
            item = item - 1
        if self._shapes is not None and len(self._shapes[i]) > 1:
            item = item.reshape(self._shapes[i])
        return item

    def num_tokens(self, i: int) -> int:
        return int(self.sizes[i])

    @staticmethod
    def exists(prefix: str) -> bool:
        return (os.path.exists(prefix + ".idx")
                and os.path.exists(prefix + ".bin"))


def make_builder(prefix: str, impl: str = "mmap", vocab_size=None):
    """Builder factory (reference make_builder:62-75)."""
    if impl == "mmap":
        return MMapIndexedDatasetBuilder(
            prefix, dtype=best_fitting_int_dtype(vocab_size))
    if impl == "native":
        return IndexedDatasetBuilder(prefix)
    raise ValueError(f"unsupported --dataset-impl {impl} "
                     "(supported: mmap, native)")


def binarize_file(
    text_path: str, out_prefix: str, dictionary, append_eos: bool = True,
    impl: str = "mmap",
) -> int:
    """Line file -> indexed dataset; returns sequence count
    (reference fairseq_cli/preprocess.py Binarizer path)."""
    builder = make_builder(out_prefix, impl=impl, vocab_size=len(dictionary))
    n = 0
    with open(text_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            builder.add_item(dictionary.encode_line(line, append_eos=append_eos))
            n += 1
    builder.finalize()
    return n
