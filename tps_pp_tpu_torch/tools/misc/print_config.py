"""Print a config with its ``_base_`` files merged (counterpart of
``tools/misc/print_config.py``, the reference's):

    python -m tps_pp_tpu_torch.tools.misc.print_config CONFIG

The port's ``config.load_config`` reads the file; the text is ``pprint``'s
of the plain dicts and lists, as the JAX CLI prints it.
"""
from __future__ import annotations

import argparse
import pprint
from typing import List, Optional


def plain(x):
    """``x`` with every dict (a ``ConfigDict`` too) a plain dict."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def main(argv: Optional[List[str]] = None) -> str:
    from ...config import load_config
    p = argparse.ArgumentParser(description='Print a resolved config')
    p.add_argument('config')
    args = p.parse_args(argv)
    text = pprint.pformat(plain(dict(load_config(args.config))), width=79)
    print(text)
    return text


if __name__ == '__main__':
    main()
