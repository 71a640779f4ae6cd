"""Python-file configs with ``_base_`` inheritance (copy of
``tps_pp_tpu/config.py``, which is pure Python; the port carries its own so
that nothing of the JAX package is imported).

``load_config`` executes a config file in an isolated namespace, merges the
dicts of its ``_base_`` files (the child wins; ``_delete_=True`` replaces a
subtree instead of merging into it; two bases defining one key raise, as
mmcv does), and substitutes ``{{_base_.name}}`` templates with values from
the merged bases. ``merge_cli_options`` applies ``--cfg-options a.b=v``
overrides. ``tests/test_torch_config.py`` holds both equal to the JAX ones
on every config under ``configs/textrecog/`` and ``configs/_base_/``.
"""
from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict):
            return ConfigDict({k: ConfigDict._wrap(v)
                               for k, v in value.items()})
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value


_BASE_KEY = '_base_'
_DELETE_KEY = '_delete_'
_INTERP_RE = re.compile(r'\{\{\s*_base_\.([\w.]+)\s*\}\}')
# mmcv allows a template bare at statement level
# (``train_list = {{_base_.train_list}}``): it is quoted before the file is
# parsed, and then resolved as a whole-string template
_BARE_INTERP_RE = re.compile(
    r"(?<!['\"])(\{\{\s*_base_\.[\w.]+\s*\}\})(?!['\"])")


def _strip_delete(value):
    """Remove ``_delete_`` markers from subtrees copied whole (the merge
    pops them only at the levels it visits)."""
    if isinstance(value, dict):
        return {k: _strip_delete(v) for k, v in value.items()
                if k != _DELETE_KEY}
    if isinstance(value, (list, tuple)):
        return type(value)(_strip_delete(v) for v in value)
    return value


def _merge_dict(base: Dict, child: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in child.items():
        if isinstance(v, dict) and v.pop(_DELETE_KEY, False):
            out[k] = _strip_delete(copy.deepcopy(v))
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge_dict(out[k], v)
        else:
            out[k] = _strip_delete(copy.deepcopy(v))
    return out


def _lookup(ns: Dict, dotted: str):
    obj = ns
    for part in dotted.split('.'):
        obj = obj[part]
    return obj


def _interp_value(value, base_ns: Dict):
    if isinstance(value, str):
        m = _INTERP_RE.fullmatch(value.strip())
        if m:   # a whole-string template stands for the object itself
            return copy.deepcopy(_lookup(base_ns, m.group(1)))
        return _INTERP_RE.sub(
            lambda m: str(_lookup(base_ns, m.group(1))), value)
    if isinstance(value, dict):
        return {k: _interp_value(v, base_ns) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_interp_value(v, base_ns) for v in value)
    return value


def _exec_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        src = _BARE_INTERP_RE.sub(r"'\1'", f.read())
    ns: Dict[str, Any] = {'__file__': os.path.abspath(path)}
    exec(compile(src, path, 'exec'), ns)
    # callables are legal config values; modules and dunders are not
    return {k: v for k, v in ns.items()
            if not k.startswith('__') and not isinstance(v, type(os))}


def load_config(path: str) -> ConfigDict:
    """Load a config file, resolving ``_base_`` chains and templates."""
    path = os.path.abspath(path)
    ns = _exec_file(path)
    bases: List[str] = ns.pop(_BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    base_ns: Dict[str, Any] = {}
    for rel in bases:
        parent = load_config(os.path.join(os.path.dirname(path), rel))
        dup = set(base_ns) & set(parent)
        if dup:
            raise KeyError(
                f'duplicate keys {sorted(dup)} among _base_ files of '
                f'{path} (mmcv: "Duplicate key is not allowed among '
                'bases")')
        base_ns = _merge_dict(base_ns, parent)
    ns = _interp_value(ns, base_ns)
    return ConfigDict._wrap(_merge_dict(base_ns, ns))


def merge_cli_options(cfg: ConfigDict, options: Dict[str, Any]) -> ConfigDict:
    """Apply ``--cfg-options a.b.c=v`` overrides in place; missing levels
    are created."""
    for dotted, value in options.items():
        parts = dotted.split('.')
        node = cfg
        for p in parts[:-1]:
            if p not in node:
                node[p] = ConfigDict()
            node = node[p]
        node[parts[-1]] = value
    return cfg
