"""Annotation lines (a text file, or an LMDB) into a TPSPACK1 file
(counterpart of ``tools/data/pack_converter.py``):

    python -m tps_pp_tpu_torch.tools.data.pack_converter label.txt label.pack
    python -m tps_pp_tpu_torch.tools.data.pack_converter label.lmdb \\
        label.pack --from-lmdb

A text file gives its non-blank lines, one record each, UTF-8; an LMDB its
``total_number`` records in key order (that branch needs python-lmdb,
``lmdb_converter.import_lmdb``). ``PackedLoader`` reads the file.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ...utils.packed import write_packed
from .lmdb_converter import import_lmdb


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description='Write a TPSPACK1 file')
    p.add_argument('src')
    p.add_argument('dst')
    p.add_argument('--from-lmdb', action='store_true')
    args = p.parse_args(argv)
    if args.from_lmdb:
        env = import_lmdb().open(args.src, readonly=True, lock=False)
        with env.begin() as txn:
            total = int(txn.get(b'total_number').decode())
            records = [txn.get(str(i).encode()) for i in range(total)]
    else:
        with open(args.src, encoding='utf-8') as f:
            records = [line.rstrip('\r\n').encode('utf-8')
                       for line in f if line.strip()]
    write_packed(args.dst, records)
    print(f'wrote {len(records)} records -> {args.dst}')
    return len(records)


if __name__ == '__main__':
    main()
