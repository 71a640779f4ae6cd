"""The full-width ABINet + TPS++ of ``configs/textrecog/abinet/
abinet_tps++.py`` (ResNetABI at strides (1, 2, 2, 1, 1), TPS++ at 16 x 64,
3 encoder layers, 4 language layers, 3 rounds, DICT36) in the port against
the JAX package, on the CPU in float32 at batch 2: the JAX variables
(seeded, perturbed BatchNorm statistics) carried across, ``predict``'s
argmax equal and its logits within atol 1e-3, which allows for float32
sums taken in another order through the trunk, 7 transformer layers and
the rounds. One JAX init for the file (it takes ~45 s on a CPU).

``abinet_academic.py`` and ``abinet_vision_only_academic.py``
(``iter_size=0``, no language decoder, no fuser) at full width on one crop,
from variables drawn with numpy at an init's scale: logits within 1e-5 of
their magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import perturb_batch_stats

from tps_pp_tpu.apis.recognizer import build_recognizer as build_jax
from tps_pp_tpu.config import load_config as jax_load_config

from tps_pp_tpu_torch.apis import build_recognizer
from tps_pp_tpu_torch.config import load_config
from tps_pp_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(2)
CFG = 'configs/textrecog/abinet/abinet_tps++.py'


@pytest.fixture(scope='module')
def full():
    model = dict(jax_load_config(CFG)['model'])
    assert model == dict(load_config(CFG)['model'])
    # the JAX rectifier's gather sampler (its default); the port warps
    # through kernel 1's plain version here
    cfg = dict(model, tpsnet=dict(model['tpsnet'], sample_mode='gather'))
    jrec = build_jax(cfg)
    v = jax.jit(lambda key: jrec.init_variables(key, (1, 32, 128, 3)))(
        jax.random.PRNGKey(4))
    v = perturb_batch_stats(v, 4)
    img = np.random.default_rng(4).standard_normal((2, 32, 128, 3)).astype(
        np.float32)
    vr = np.array([1.0, 0.7], np.float32)
    want = np.asarray(jrec.predict(jax.tree.map(jnp.asarray, v),
                                   jnp.asarray(img), jnp.asarray(vr)))
    rec = build_recognizer(cfg, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    return rec, img, vr, want


@pytest.mark.heavy
def test_full_width_abinet_logits_match_jax(full):
    rec, img, vr, want = full
    got = rec.predict(img, vr).numpy()
    assert got.shape == want.shape == (2, 26, 37)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.heavy
def test_full_width_abinet_texts_match_jax(full):
    rec, img, vr, want = full
    lc = rec.label_convertor
    texts = [r['text'] for r in rec.simple_test(img, vr)]
    assert texts == lc.idx2str(lc.tensor2idx(want)[0])


ACADEMIC = {
    'abinet_academic': 'configs/textrecog/abinet/abinet_academic.py',
    'abinet_vision_only': (
        'configs/textrecog/abinet/abinet_vision_only_academic.py')}


def _seeded_variables(shapes, seed):
    """Variables in the shapes of ``shapes`` at an init's scale, drawn
    with numpy (no JAX init of the full model, ~45 s): kernels
    N(0, 1 / fan_in), norm scales and running variances U(0.5, 1.5),
    every other leaf (biases, running means, embeddings) 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return (rng.standard_normal(s.shape) /
                    np.sqrt(np.prod(s.shape[:-1]))).astype(s.dtype)
        if name.endswith(("['scale']", "['var']")):
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        return (0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize('name', list(ACADEMIC))
def test_academic_configs_match_jax(name):
    """``abinet_academic.py`` (ResNetABI without a rectifier, 3 rounds)
    and ``abinet_vision_only_academic.py`` (``iter_size=0``: no language
    decoder, no fuser; ``predict`` is the vision model's logits) at full
    width: built from the files by both packages, the JAX variables
    carried over, one 32 x 128 crop through ``predict``: logits within
    1e-5 of their magnitude, argmax and texts equal."""
    path = ACADEMIC[name]
    cfg = dict(load_config(path)['model'])
    assert cfg == dict(jax_load_config(path)['model'])
    jrec = build_jax(cfg)
    v = _seeded_variables(jax.eval_shape(lambda: jrec.init_variables(
        jax.random.PRNGKey(0), (1, 32, 128, 3))), 5)
    rec = build_recognizer(cfg, device='cpu')
    rec.model.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    m = rec.model
    if name == 'abinet_vision_only':
        assert m.iter_size == 0 and m.decoder is None and m.fuser is None
    else:
        assert m.iter_size == 3 and m.decoder is not None
    assert m.tpsnet is None and m.preprocessor is None
    img = np.random.default_rng(6).standard_normal((1, 32, 128, 3)).astype(
        np.float32)
    want = np.asarray(jrec.predict(jax.tree.map(jnp.asarray, v),
                                   jnp.asarray(img)))
    got = rec.predict(img).numpy()
    assert got.shape == want.shape == (1, 26, 37)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    lc = rec.label_convertor
    assert [r['text'] for r in rec.simple_test(img)] == \
        lc.idx2str(lc.tensor2idx(want)[0])
