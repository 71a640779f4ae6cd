"""The TPSPACK1 indexed-record file (counterpart of
``tps_pp_tpu/native.py:93-175``, ``write_packed`` and ``PackedReader``,
which read it through the JAX package's native library or, without it,
through ``mmap``).

The layout, little-endian: the magic ``TPSPACK1``; the record count n as a
u64; n + 1 u64 offsets from the start of the file, record i spanning
``offsets[i]:offsets[i + 1]``; then the records, back to back. A file
written here is byte for byte the one the JAX package writes for the same
records, and each package reads the other's.

Plain Python: ``struct`` and ``mmap``, no C++ library. The reader keeps one
read-only map open and pickles as its path, so that a spawned
``DataLoader`` worker opens the file again on its side.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Iterable, List

MAGIC = b'TPSPACK1'


def write_packed(path: str, records: Iterable[bytes]):
    """Write ``records`` (bytes each) as a TPSPACK1 file at ``path``."""
    records: List[bytes] = [bytes(r) for r in records]
    offsets = [16 + 8 * (len(records) + 1)]
    for r in records:
        offsets.append(offsets[-1] + len(r))
    with open(path, 'wb') as f:
        f.write(MAGIC)
        f.write(struct.pack('<Q', len(records)))
        f.write(struct.pack(f'<{len(offsets)}Q', *offsets))
        for r in records:
            f.write(r)


class PackedReader:
    """``len()`` and ``[i]`` -> the bytes of record i of a TPSPACK1 file;
    an ``IndexError`` out of range, a ``ValueError`` on a file that is not
    TPSPACK1."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._open()

    def _open(self):
        with open(self.path, 'rb') as f:
            head = f.read(16)
            if len(head) < 16 or head[:8] != MAGIC:
                raise ValueError(f'not a TPSPACK1 file: {self.path}')
            (count,) = struct.unpack('<Q', head[8:])
            table = f.read(8 * (count + 1))
            if len(table) != 8 * (count + 1):
                raise ValueError(f'TPSPACK1 file cut short: {self.path}')
            self._offsets = struct.unpack(f'<{count + 1}Q', table)
            if self._offsets[-1] > os.fstat(f.fileno()).st_size:
                raise ValueError(f'TPSPACK1 file cut short: {self.path}')
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._count = count

    def __len__(self):
        return self._count

    def __getitem__(self, index: int) -> bytes:
        if not 0 <= index < self._count:
            raise IndexError(index)
        return bytes(self._map[self._offsets[index]:
                               self._offsets[index + 1]])

    def __getstate__(self):
        return {'path': self.path}

    def __setstate__(self, state):
        self.path = state['path']
        self._open()
