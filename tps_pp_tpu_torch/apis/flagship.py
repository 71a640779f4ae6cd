"""Flagship model configs (copy of ``tps_pp_tpu/apis/flagship.py``).

The JAX module cannot be imported without JAX, so the port carries its own
copy; ``tests/test_torch_flagship.py`` holds the two equal.
``nrtr_tps_pp_cfg`` is the NRTR + ResNetABI_v2_large + TPS_PP + DICT90
AttnConvertor flagship (reference configs/textrecog/nrtr/nrtr_tps++.py) with
the consistent stride geometry [1, 2, 2, 1, 2]; ``tiny=True`` keeps the
topology at toy widths for tests.
"""
from __future__ import annotations


def nrtr_tps_pp_cfg(dtype: str = 'float32', tiny: bool = False,
                    kv_dtype: str = 'bfloat16', decode_mode: str = 'steps'):
    if tiny:
        return dict(
            type='NRTR',
            dtype=dtype,
            label_convertor=dict(type='AttnConvertor', dict_type='DICT36',
                                 with_unknown=True),
            backbone=dict(type='ResNetABI_v2_large', in_channels=3,
                          stem_channels=4, base_channels=4,
                          arch_settings=[1, 1, 1, 1, 1],
                          strides=[1, 2, 2, 1, 2]),
            tpsnet=dict(type='TPS_PP', num_img_channel=8,
                        img_size=(16, 32), rectified_img_size=(16, 32),
                        point_size=(2, 8)),
            encoder=dict(type='NRTREncoder', n_layers=2, n_head=2, d_k=8,
                         d_v=8, d_model=64, d_inner=128, dropout=0.1),
            decoder=dict(type='NRTRDecoder', n_layers=2, d_embedding=64,
                         n_head=2, d_model=64, d_inner=128, d_k=8, d_v=8,
                         kv_dtype=kv_dtype),
            loss=dict(type='TFLoss'),
            max_seq_len=8,
            decode_mode=decode_mode,
        )
    return dict(
        type='NRTR',
        dtype=dtype,
        label_convertor=dict(type='AttnConvertor', dict_type='DICT90',
                             with_unknown=True),
        backbone=dict(type='ResNetABI_v2_large', in_channels=3,
                      stem_channels=32, base_channels=32,
                      arch_settings=[3, 4, 6, 6, 3], strides=[1, 2, 2, 1, 2]),
        tpsnet=dict(type='TPS_PP', img_size=(16, 64),
                    rectified_img_size=(16, 64), num_img_channel=64,
                    point_size=(2, 16), p_stride=2, sample_mode='pallas'),
        # d_inner=256: the reference flagship config leaves NRTREncoder /
        # NRTRDecoder at their defaults (nrtr_encoder.py:37,
        # nrtr_decoder.py:49), so the released checkpoint's FFN weights
        # are 512x256 — this config must match to load them.
        encoder=dict(type='NRTREncoder', n_layers=6, n_head=8, d_k=64,
                     d_v=64, d_model=512, d_inner=256, dropout=0.1),
        # the decoder honours use_fused_step and kv_dtype as the JAX
        # package's does.
        decoder=dict(type='NRTRDecoder', n_layers=6, d_embedding=512,
                     n_head=8, d_model=512, d_inner=256, d_k=64, d_v=64,
                     n_position=200, use_fused_step=False,
                     kv_dtype=kv_dtype),
        loss=dict(type='TFLoss'),
        max_seq_len=40,
        decode_mode=decode_mode,
    )


# input geometry for the flagship (TPS++ train pipeline resizes to 32x128,
# reference configs/_base_/recog_pipelines/crnn_pp_pipeline.py)
FLAGSHIP_INPUT = (32, 128, 3)
TINY_INPUT = (32, 64, 3)
