"""Text detection (counterpart of ``tps_pp_tpu/models/textdet``): DBNet's
and PANet's / PSENet's trunks, necks, heads and losses, their targets and
the host-side postprocessors."""
from .dbnet import DBHead, DBLoss, DBNetModule, FPNC, ResNetDet
from .pan import (Bottleneck, FPEM_FFM, FPNF, PANHead, PANLoss, PANetModule,
                  PSELoss, ResNetDet50)
from .postprocess import (DBPostprocessor, PANPostprocessor,
                          PSEPostprocessor, eval_hmean_iou)
from .targets import DBNetTargets, PANetTargets, PSENetTargets

__all__ = ['ResNetDet', 'FPNC', 'DBHead', 'DBLoss', 'DBNetModule',
           'Bottleneck', 'ResNetDet50', 'FPEM_FFM', 'FPNF', 'PANHead',
           'PANLoss', 'PSELoss', 'PANetModule', 'DBPostprocessor',
           'PANPostprocessor', 'PSEPostprocessor', 'DBNetTargets',
           'PANetTargets', 'PSENetTargets', 'eval_hmean_iou']
