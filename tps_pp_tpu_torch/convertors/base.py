"""Base string<->index codec (copy of ``tps_pp_tpu/convertors/base.py``).

A JAX-free copy: the JAX package's ``convertors/__init__`` imports the cv2
based segmentation codec, which the GPU machine does not have. Semantics are
the reference's (DICT36/DICT90 charsets, dict_file/dict_list overrides);
``tests/test_torch_flagship.py`` holds it against the original.
"""
from __future__ import annotations

from typing import List, Optional

from ..registry import CONVERTORS


@CONVERTORS.register_module()
class BaseConvertor:
    start_idx = end_idx = padding_idx = 0
    unknown_idx: Optional[int] = None
    lower = False

    DICT36 = tuple('0123456789abcdefghijklmnopqrstuvwxyz')
    DICT90 = tuple('0123456789abcdefghijklmnopqrstuvwxyz'
                   'ABCDEFGHIJKLMNOPQRSTUVWXYZ!"#$%&\'()'
                   '*+,-./:;<=>?@[\\]_`~')

    def __init__(self, dict_type='DICT90', dict_file=None, dict_list=None):
        assert dict_type in ('DICT36', 'DICT90')
        self.idx2char: List[str] = []
        if dict_file is not None:
            with open(dict_file) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self.idx2char.append(line)
        elif dict_list is not None:
            self.idx2char = list(dict_list)
        else:
            self.idx2char = list(
                self.DICT36 if dict_type == 'DICT36' else self.DICT90)
        self._rebuild_char2idx()

    def _rebuild_char2idx(self):
        self.char2idx = {c: i for i, c in enumerate(self.idx2char)}

    def num_classes(self) -> int:
        return len(self.idx2char)

    def str2idx(self, strings: List[str]) -> List[List[int]]:
        assert isinstance(strings, list)
        indexes = []
        for string in strings:
            if self.lower:
                string = string.lower()
            index = []
            for char in string:
                char_idx = self.char2idx.get(char, self.unknown_idx)
                if char_idx is None:
                    raise ValueError(
                        f'Character: {char} not in dict; supply a custom '
                        f'dict file or set with_unknown=True')
                index.append(char_idx)
            indexes.append(index)
        return indexes

    def idx2str(self, indexes: List[List[int]]) -> List[str]:
        assert isinstance(indexes, list)
        return [''.join(self.idx2char[i] for i in index) for index in indexes]
