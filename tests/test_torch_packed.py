"""The port's TPSPACK1 reader and writer (``tps_pp_tpu_torch/utils/
packed.py``) and its ``PackedLoader`` against the JAX package's
(``tps_pp_tpu/native.py`` ``write_packed`` / ``PackedReader``, its native
library and its Python path), on the CPU.

* A file written by JAX is read by the port equal, record by record, with
  empty records, multi-byte UTF-8 and raw bytes, and with no record.
* A file written by the port is byte-equal to JAX's for the same records,
  and JAX reads it through its native and its Python path.
* The reader pickles as its path and reads in a spawned ``DataLoader``
  worker; an ``OCRDataset`` on ``PackedLoader`` gives the samples of the
  same lines read by ``HardDiskLoader``, in the process and in a worker.
* A bad magic, a cut file and an index out of range raise.
"""
import pickle

import numpy as np
import pytest

import tps_pp_tpu.native as jnative

from tps_pp_tpu_torch.datasets import DataLoader, OCRDataset
from tps_pp_tpu_torch.datasets.pipelines.cv_ops import png_encode
from tps_pp_tpu_torch.registry import LOADERS
from tps_pp_tpu_torch.utils.packed import PackedReader, write_packed

RECORDS = {
    'lines': [b'img_0.jpg hello', b'img_1.jpg w\xc3\xb6rld', b'',
              'crop.png 文字'.encode(), b'', b'x' * 5000],
    'raw bytes': [bytes(range(256)), b'\x00', b'', b'\xff' * 3],
    'one empty': [b''],
    'none': [],
}


def _jax_records(path, python_path, monkeypatch):
    if python_path:
        monkeypatch.setattr(jnative, 'get_lib', lambda: None)
    r = jnative.PackedReader(str(path))
    return [r[i] for i in range(len(r))]


@pytest.mark.parametrize('records', list(RECORDS))
def test_port_reads_jax_files(tmp_path, records):
    recs = RECORDS[records]
    path = tmp_path / 'jax.pack'
    jnative.write_packed(str(path), recs)
    r = PackedReader(str(path))
    assert len(r) == len(recs)
    assert [r[i] for i in range(len(r))] == recs


@pytest.mark.parametrize('python_path', [False, True],
                         ids=['native', 'python'])
@pytest.mark.parametrize('records', list(RECORDS))
def test_jax_reads_port_files(tmp_path, monkeypatch, records, python_path):
    recs = RECORDS[records]
    ours, theirs = tmp_path / 'port.pack', tmp_path / 'jax.pack'
    write_packed(str(ours), recs)
    jnative.write_packed(str(theirs), recs)
    assert ours.read_bytes() == theirs.read_bytes()
    assert _jax_records(ours, python_path, monkeypatch) == recs


def test_reader_errors(tmp_path):
    path = tmp_path / 'a.pack'
    write_packed(str(path), [b'a', b'bc'])
    r = PackedReader(str(path))
    for i in (-1, 2, 100):
        with pytest.raises(IndexError):
            r[i]
    bad = tmp_path / 'bad.pack'
    bad.write_bytes(b'TPSPACK2' + path.read_bytes()[8:])
    with pytest.raises(ValueError, match='not a TPSPACK1'):
        PackedReader(str(bad))
    cut = tmp_path / 'cut.pack'
    cut.write_bytes(path.read_bytes()[:-1])
    with pytest.raises(ValueError, match='cut short'):
        PackedReader(str(cut))
    empty = tmp_path / 'empty.pack'
    empty.write_bytes(b'')
    with pytest.raises(ValueError, match='not a TPSPACK1'):
        PackedReader(str(empty))


def test_reader_pickles_as_its_path(tmp_path):
    path = tmp_path / 'p.pack'
    write_packed(str(path), RECORDS['lines'])
    r = PackedReader(str(path))
    state = pickle.dumps(r)
    assert len(state) < 400 and b'hello' not in state
    r2 = pickle.loads(state)
    assert [r2[i] for i in range(len(r2))] == RECORDS['lines']


@pytest.fixture
def crops(tmp_path):
    """Six PNG crops of seed-0 pixels and their label lines, as a text
    file and as a TPSPACK1 file."""
    g = np.random.default_rng(0)
    lines = []
    for i in range(6):
        img = g.integers(0, 256, (int(g.integers(12, 40)),
                                  int(g.integers(20, 90)), 3), np.uint8)
        (tmp_path / f'c{i}.png').write_bytes(png_encode(img))
        lines.append(f'c{i}.png word{i}')
    (tmp_path / 'label.txt').write_text('\n'.join(lines) + '\n')
    write_packed(str(tmp_path / 'label.pack'),
                 [ln.encode() for ln in lines])
    return tmp_path, lines


PIPELINE = [dict(type='LoadImageFromFile'),
            dict(type='ResizeOCR', height=32, min_width=64, max_width=64,
                 keep_aspect_ratio=False),
            dict(type='ToTensorOCR'),
            dict(type='NormalizeOCR', mean=[0.5] * 3, std=[0.5] * 3),
            dict(type='Collect', keys=['img'],
                 meta_keys=['filename', 'valid_ratio'])]


def _dataset(root, kind):
    ann, loader = {'text': ('label.txt', 'HardDiskLoader'),
                   'packed': ('label.pack', 'PackedLoader')}[kind]
    return OCRDataset(ann_file=str(root / ann), img_prefix=str(root),
                      loader=dict(type=loader,
                                  parser=dict(type='LineStrParser')),
                      pipeline=PIPELINE, test_mode=True)


def test_packed_loader_is_registered_and_equals_text_lines(crops):
    root, lines = crops
    assert LOADERS.get('PackedLoader').__name__ == 'PackedLoader'
    packed, text = _dataset(root, 'packed'), _dataset(root, 'text')
    assert len(packed) == len(text) == len(lines)
    for i in range(len(lines)):
        a, b = packed[i], text[i]
        assert a['img_metas'] == b['img_metas']
        assert a['text'] == b['text'] == f'word{i}'
        np.testing.assert_array_equal(a['img'], b['img'])


def test_packed_dataset_in_a_spawned_worker(crops):
    root, lines = crops
    ds = _dataset(root, 'packed')
    loader = DataLoader(ds, 4, num_workers=1)
    try:
        got = list(loader)
    finally:
        loader.close()
    want = list(DataLoader(_dataset(root, 'text'), 4))
    assert [b['texts'] for b in got] == [b['texts'] for b in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a['img']),
                                      np.asarray(b['img']))
