"""The port's config system (``tps_pp_tpu_torch/config.py``) against the
JAX package's: every config under ``configs/textrecog/``,
``configs/textdet/dbnet/`` and ``configs/_base_/`` (the ``det_*`` bases
among them) loads to the same plain dict (a callable a config
defines compared by its qualified name), ``merge_cli_options`` applies the
same overrides, and duplicate keys among ``_base_`` files raise the same
error."""
import glob
import os

import pytest

from tps_pp_tpu import config as jconfig

from tps_pp_tpu_torch import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, 'configs/textrecog/**/*.py'),
              recursive=True) +
    glob.glob(os.path.join(REPO, 'configs/textdet/dbnet/*.py')) +
    glob.glob(os.path.join(REPO, 'configs/_base_/**/*.py'), recursive=True))


def plain(value):
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(plain(v) for v in value)
    if callable(value):
        return ('callable', getattr(value, '__qualname__', repr(value)))
    return value


def load(module, path):
    """(plain dict, None) or (None, the exception's type and text)."""
    try:
        return plain(module.load_config(path)), None
    except Exception as e:  # the two must fail alike
        return None, (type(e), str(e))


def test_every_config_is_listed():
    assert len(CONFIGS) > 60
    assert 'configs/textrecog/nrtr/nrtr_tps++.py' in CONFIGS
    assert 'configs/textdet/dbnet/dbnet_r18_fpnc_1200e_icdar2015.py' in \
        CONFIGS
    assert 'configs/_base_/det_models/dbnet_r50dcnv2_fpnc.py' in CONFIGS


@pytest.mark.parametrize('rel', CONFIGS)
def test_load_config_matches_jax(rel):
    path = os.path.join(REPO, rel)
    got, want = load(tconfig, path), load(jconfig, path)
    assert got == want
    if got[0] is not None:
        cfg = tconfig.load_config(path)
        assert type(cfg) is tconfig.ConfigDict
        for k in cfg:
            assert getattr(cfg, k) is cfg[k]


def test_flagship_config_resolves_its_bases():
    cfg = tconfig.load_config(os.path.join(
        REPO, 'configs/textrecog/nrtr/nrtr_tps++.py'))
    assert cfg.model.type == 'NRTR' and 'dtype' not in cfg.model
    assert cfg.test_pipeline[0]['type'] == 'LoadImageFromFile'
    assert cfg.data.test.pipeline == cfg.test_pipeline
    assert len(cfg.data.test.datasets) == 6


OPTIONS = [
    {'model.dtype': 'bfloat16'},
    {'model.decoder.kv_dtype': 'int8', 'data.samples_per_gpu': 8},
    {'new.branch.leaf': [1, 2], 'evaluation': None},
]


@pytest.mark.parametrize('options', OPTIONS)
def test_merge_cli_options_matches_jax(options):
    path = os.path.join(REPO, 'configs/textrecog/nrtr/nrtr_tps++_toy.py')
    got = tconfig.merge_cli_options(tconfig.load_config(path), options)
    want = jconfig.merge_cli_options(jconfig.load_config(path), options)
    assert plain(got) == plain(want)
    assert isinstance(got['new'] if 'new.branch.leaf' in options
                      else got['model'], tconfig.ConfigDict)


def test_duplicate_base_keys_raise_as_in_jax(tmp_path):
    (tmp_path / 'a.py').write_text('x = 1\ny = dict(k=1)\n')
    (tmp_path / 'b.py').write_text('y = dict(k=2)\n')
    (tmp_path / 'c.py').write_text("_base_ = ['a.py', 'b.py']\nz = 3\n")
    got, want = (load(m, str(tmp_path / 'c.py'))
                 for m in (tconfig, jconfig))
    assert got == want and want[1][0] is KeyError
    assert 'duplicate keys' in want[1][1]


def test_delete_and_templates_match_jax(tmp_path):
    (tmp_path / 'base.py').write_text(
        "p = [dict(type='A', v=1)]\nm = dict(a=1, b=dict(c=2, d=3))\n"
        "name = 'x'\n")
    (tmp_path / 'child.py').write_text(
        "_base_ = 'base.py'\nm = dict(b=dict(_delete_=True, e=4))\n"
        "q = {{_base_.p}}\nr = dict(n='{{ _base_.name }}')\n")
    got, want = (load(m, str(tmp_path / 'child.py'))
                 for m in (tconfig, jconfig))
    assert got == want
    assert want[0]['m'] == {'a': 1, 'b': {'e': 4}}
    assert want[0]['q'] == [{'type': 'A', 'v': 1}]
    assert want[0]['r'] == {'n': 'x'}
