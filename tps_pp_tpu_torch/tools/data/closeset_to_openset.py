"""A closeset KIE annotation file (wildreceipt's) in the openset format
(counterpart of ``tools/data/closeset_to_openset.py``; the reference's
``tools/data/kie/closeset_to_openset.py:10-95``):

    python -m tps_pp_tpu_torch.tools.data.closeset_to_openset IN OUT \\
        [--merge]

Openset node labels: bg 0, key 1, value 2, others 3 (``--merge`` folds
others into bg). Each closeset key/value class pair (odd index = value,
the next even index = its key, as in wildreceipt's ``class_list.txt``)
becomes one edge id linking the pair; ``ignore`` (0) and ``others`` (25)
nodes each get an edge id of their own.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

from ...utils.fileio import list_from_file, list_to_file


def convert_line(line: str, merge_bg_others: bool = False,
                 ignore_idx: int = 0, others_idx: int = 25) -> str:
    """One closeset JSON line -> one openset JSON line."""
    node_label = {'bg': 0, 'key': 1, 'value': 2,
                  'others': 0 if merge_bg_others else 3}
    key_inds = list(range(2, others_idx, 2))
    value_inds = list(range(1, others_idx, 2))

    obj = json.loads(line)
    edge_idx = 1
    label_to_edge = {}
    for ann in obj['annotations']:
        label = ann['label']
        if label == ignore_idx:
            ann['label'] = node_label['bg']
            ann['edge'], edge_idx = edge_idx, edge_idx + 1
        elif label == others_idx:
            ann['label'] = node_label['others']
            ann['edge'], edge_idx = edge_idx, edge_idx + 1
        elif label in label_to_edge:
            ann['edge'] = label_to_edge[label]
            ann['label'] = node_label['key' if label in key_inds
                                      else 'value']
        else:
            kind = 'key' if label in key_inds else 'value'
            counterpart = (value_inds[key_inds.index(label)]
                           if kind == 'key'
                           else key_inds[value_inds.index(label)])
            if counterpart in label_to_edge:
                ann['edge'] = label_to_edge[counterpart]
            else:
                ann['edge'], edge_idx = edge_idx, edge_idx + 1
            ann['label'] = node_label[kind]
            label_to_edge[label] = ann['edge']
    out = {'file_name': obj['file_name'], 'height': obj['height'],
           'width': obj['width'], 'annotations': obj['annotations']}
    return json.dumps(out, ensure_ascii=False)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description='Closeset KIE -> openset')
    p.add_argument('in_file')
    p.add_argument('out_file')
    p.add_argument('--merge', action='store_true',
                   help='fold "others" into "bg"')
    args = p.parse_args(argv)
    lines = [convert_line(ln, merge_bg_others=args.merge)
             for ln in list_from_file(args.in_file) if ln.strip()]
    list_to_file(args.out_file, lines)
    print(f'converted {len(lines)} lines -> {args.out_file}')
    return len(lines)


if __name__ == '__main__':
    main()
