"""The port's ``utils/profiling.py`` on the CPU, against the JAX package's
``ThroughputMeter`` and ``timed`` surface (``tps_pp_tpu/utils/
profiling.py``).

* ``trace`` writes a Chrome trace under its directory, whose events name
  the operators run in the block (a matmul here).
* ``ThroughputMeter`` counts images over the time since ``reset`` per
  chip; ``timed`` adds each block's seconds to its name in the sink, as
  JAX's does.
"""
import json
import os
import time

import pytest
import torch

from tps_pp_tpu.utils import profiling as jprof

from tps_pp_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / 'traces'
    a = torch.randn(64, 64)
    with profiling.trace(str(log_dir)) as path:
        for _ in range(3):
            a = a @ a.t() / 64
    assert os.path.dirname(path) == str(log_dir) and os.path.isfile(path)
    events = json.load(open(path))['traceEvents']
    assert any('mm' in str(e.get('name', '')) for e in events)
    with profiling.trace(str(log_dir)) as second:
        pass
    assert second != path and len(os.listdir(log_dir)) == 2


@pytest.mark.parametrize('n_chips', [1, 4])
def test_throughput_meter_counts(n_chips):
    ours, theirs = (m.ThroughputMeter(n_chips) for m in (profiling, jprof))
    for m in (ours, theirs):
        m.update(100)
        m.update(28)
    time.sleep(0.05)
    for m in (ours, theirs):
        rate = m.images_per_sec_per_chip
        assert 0 < rate < 128 / 0.05 / n_chips
        assert repr(m).endswith('img/s/chip')
    ours.reset()
    assert ours._images == 0 and ours.images_per_sec_per_chip == 0.0


def test_timed_sums_into_its_sink():
    sinks = ({}, {})
    for sink, mod in zip(sinks, (profiling, jprof)):
        for _ in range(2):
            with mod.timed('step', sink):
                time.sleep(0.01)
        with mod.timed('other'):
            pass
    for sink in sinks:
        assert list(sink) == ['step'] and sink['step'] >= 0.02
