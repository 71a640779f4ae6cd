"""Annotation loaders and line parsers (counterpart of
``tps_pp_tpu/datasets/loader.py:19-151``, the reference's
``mmocr/datasets/utils/loader.py`` and ``utils/parser.py``).

``LmdbLoader`` opens the database lazily in each process, as the JAX
package does, and raises an ``ImportError`` that names the alternatives
when python-lmdb is absent. ``PackedLoader`` reads the annotation lines of
a TPSPACK1 file (``utils/packed.py``, the JAX package's format, read here
in plain Python), one UTF-8 line a record.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

from ..registry import LOADERS, PARSERS
from ..utils.packed import PackedReader
from ..utils.string_util import StringStrip


@PARSERS.register_module()
class LineStrParser:
    """Split a text line into a dict by separator (reference
    parser.py:9-46)."""

    def __init__(self, keys=('filename', 'text'), keys_idx=(0, 1),
                 separator=' ', **kwargs):
        if not keys or len(keys) != len(keys_idx):
            raise ValueError(f'keys {keys} and keys_idx {keys_idx} must be '
                             'non-empty and of one length')
        self.keys = list(keys)
        self.keys_idx = list(keys_idx)
        self.separator = separator
        self.strip_cls = StringStrip(**kwargs)

    def get_item(self, data_ret: List[str], index: int) -> Dict:
        map_index = index % len(data_ret)
        line_str = self.strip_cls(data_ret[map_index])
        for sub in self.separator:
            if sub != ' ':
                line_str = line_str.replace(sub, ' ')
        line = line_str.split()
        if len(line) <= max(self.keys_idx):
            raise ValueError(f'key index {max(self.keys_idx)} out of range '
                             f'for line: {line_str}')
        return {k: line[i] for k, i in zip(self.keys, self.keys_idx)}


@PARSERS.register_module()
class LineJsonParser:
    """Parse a JSON line, keeping ``keys`` (reference parser.py:50-72)."""

    def __init__(self, keys=('filename', 'text')):
        if not keys:
            raise ValueError('LineJsonParser: no keys')
        self.keys = list(keys)

    def get_item(self, data_ret: List[str], index: int) -> Dict:
        map_index = index % len(data_ret)
        obj = json.loads(data_ret[map_index])
        missing = [k for k in self.keys if k not in obj]
        if missing:
            raise ValueError(f'keys {missing} not in line json: {obj}')
        return {k: obj[k] for k in self.keys}


class BaseLoader:
    """``len()`` and ``[index]`` -> the parsed annotation; ``repeat``
    repeats the file's lines."""

    def __init__(self, ann_file: str, parser: Dict, repeat: int = 1):
        if not (isinstance(ann_file, str) and ann_file) or repeat <= 0:
            raise ValueError(f'ann_file {ann_file!r} must be a path and '
                             f'repeat {repeat} positive')
        self.ann_file = ann_file
        self.repeat = repeat
        self.parser = PARSERS.build(parser)
        self.ordered_indexes = self._load(ann_file)

    def __len__(self):
        return int(len(self.ordered_indexes) * self.repeat)

    def __getitem__(self, index: int) -> Dict:
        return self.parser.get_item(self.ordered_indexes, index)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def _load(self, ann_file):
        raise NotImplementedError


@LOADERS.register_module()
class HardDiskLoader(BaseLoader):
    """The non-blank lines of a text file, read into memory (reference
    loader.py:55-63)."""

    def _load(self, ann_file):
        if not os.path.exists(ann_file):
            raise FileNotFoundError(ann_file)
        with open(ann_file, encoding='utf-8') as f:
            return [line.rstrip('\r\n') for line in f if line.strip()]


class _LmdbBackend:
    """Annotation lines of an LMDB, opened lazily in each process
    (reference LmdbAnnFileBackend, loader.py:95-115)."""

    def __init__(self, lmdb_path: str, coding: str = 'utf8'):
        self.lmdb_path = lmdb_path
        self.coding = coding
        self._env = None
        env = self._get_env()
        try:
            with env.begin(write=False) as txn:
                self.total_number = int(
                    txn.get('total_number'.encode(self.coding)).decode(
                        self.coding))
        finally:
            env.close()

    def _get_env(self):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                'python-lmdb is not installed; use HardDiskLoader (a text '
                'file of annotation lines) or PackedLoader (a TPSPACK1 file, '
                'tools/data/pack_converter.py) instead') from e
        return lmdb.open(self.lmdb_path, max_readers=1, readonly=True,
                         lock=False, readahead=False, meminit=False)

    def __len__(self):
        return self.total_number

    def __getitem__(self, index: int) -> str:
        if self._env is None:
            self._env = self._get_env()
        with self._env.begin(write=False) as txn:
            return txn.get(str(index).encode(self.coding)).decode(self.coding)

    def __getstate__(self):
        state = self.__dict__.copy()
        state['_env'] = None
        return state


@LOADERS.register_module()
class LmdbLoader(BaseLoader):
    """Annotation lines stored in an LMDB (reference loader.py:67-92)."""

    def _load(self, ann_file):
        return _LmdbBackend(ann_file)


class _PackedBackend:
    """The annotation lines of a TPSPACK1 file, decoded from UTF-8."""

    def __init__(self, path: str):
        self._reader = PackedReader(path)

    def __len__(self):
        return len(self._reader)

    def __getitem__(self, index: int) -> str:
        return self._reader[index].decode('utf-8')


@LOADERS.register_module()
class PackedLoader(BaseLoader):
    """Annotation lines stored in a TPSPACK1 file (JAX
    ``tps_pp_tpu/datasets/loader.py:154-175``)."""

    def _load(self, ann_file):
        return _PackedBackend(ann_file)
