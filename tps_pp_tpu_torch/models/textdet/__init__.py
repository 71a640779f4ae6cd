"""Text detection (counterpart of ``tps_pp_tpu/models/textdet``): DBNet's
trunks, neck and head, the ResNet-50 trunk with DCNv2, and the host-side
postprocessor."""
from .dbnet import DBHead, DBNetModule, FPNC, ResNetDet
from .pan import Bottleneck, ResNetDet50
from .postprocess import DBPostprocessor, eval_hmean_iou

__all__ = ['ResNetDet', 'FPNC', 'DBHead', 'DBNetModule', 'Bottleneck',
           'ResNetDet50', 'DBPostprocessor', 'eval_hmean_iou']
