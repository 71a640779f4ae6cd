"""Annotation lines between a text file, an LMDB and a TPSPACK1 file
(counterpart of ``tools/data/lmdb_converter.py``; the reference's
``tools/data/utils/txt2lmdb.py`` and ``mmocr/utils/lmdb_util.py``):

    python -m tps_pp_tpu_torch.tools.data.lmdb_converter txt2pack \\
        label.txt label.pack
    python -m tps_pp_tpu_torch.tools.data.lmdb_converter pack2txt \\
        label.pack label.txt
    python -m tps_pp_tpu_torch.tools.data.lmdb_converter txt2lmdb \\
        label.txt label.lmdb
    python -m tps_pp_tpu_torch.tools.data.lmdb_converter lmdb2txt \\
        label.lmdb label.txt

The LMDB keeps line i under the key ``str(i)`` and the count under
``total_number``. The two LMDB modes need python-lmdb; without it they
raise an ``ImportError`` that names ``pack_converter``, whose TPSPACK1
files ``PackedLoader`` reads with no dependency.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ...utils.packed import PackedReader, write_packed


def import_lmdb():
    """The ``lmdb`` module, or an ``ImportError`` naming the way round."""
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            'python-lmdb is not installed; convert the annotation text '
            'file with tps_pp_tpu_torch.tools.data.pack_converter into a '
            'TPSPACK1 file and read it with PackedLoader') from e
    return lmdb


def _read_lines(path: str) -> List[str]:
    with open(path, encoding='utf-8') as f:
        return [ln.rstrip('\n') for ln in f if ln.strip()]


def _write_lines(path: str, lines: List[str]):
    with open(path, 'w', encoding='utf-8') as f:
        f.write('\n'.join(lines) + '\n')


def txt2lmdb(txt_path: str, lmdb_path: str) -> int:
    lmdb = import_lmdb()
    lines = _read_lines(txt_path)
    env = lmdb.open(lmdb_path, map_size=1 << 34)
    with env.begin(write=True) as txn:
        for i, line in enumerate(lines):
            txn.put(str(i).encode(), line.encode('utf-8'))
        txn.put(b'total_number', str(len(lines)).encode())
    env.close()
    return len(lines)


def lmdb2txt(lmdb_path: str, txt_path: str) -> int:
    lmdb = import_lmdb()
    env = lmdb.open(lmdb_path, readonly=True, lock=False)
    with env.begin() as txn:
        total = int(txn.get(b'total_number').decode())
        lines = [txn.get(str(i).encode()).decode('utf-8')
                 for i in range(total)]
    env.close()
    _write_lines(txt_path, lines)
    return total


def txt2pack(txt_path: str, pack_path: str) -> int:
    lines = _read_lines(txt_path)
    write_packed(pack_path, [ln.encode('utf-8') for ln in lines])
    return len(lines)


def pack2txt(pack_path: str, txt_path: str) -> int:
    reader = PackedReader(pack_path)
    lines = [reader[i].decode('utf-8') for i in range(len(reader))]
    _write_lines(txt_path, lines)
    return len(lines)


MODES = {'txt2lmdb': txt2lmdb, 'lmdb2txt': lmdb2txt, 'txt2pack': txt2pack,
         'pack2txt': pack2txt}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description='Convert annotation stores')
    p.add_argument('mode', choices=list(MODES))
    p.add_argument('src')
    p.add_argument('dst')
    args = p.parse_args(argv)
    n = MODES[args.mode](args.src, args.dst)
    print(f'{args.mode}: {n} records {args.src} -> {args.dst}')
    return n


if __name__ == '__main__':
    main()
