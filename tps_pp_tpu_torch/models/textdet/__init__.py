"""Text detection (counterpart of ``tps_pp_tpu/models/textdet``): DBNet's,
PANet's / PSENet's, FCENet's, TextSnake's, DRRG's and Mask R-CNN's trunks,
necks, heads and losses, their targets and the host-side postprocessors."""
from .dbnet import DBHead, DBLoss, DBNetModule, FPNC, ResNetDet
from .drrg import (DRRGDetector, DRRGHead, DRRGLoss, DRRGModule,
                   DRRGPostprocessor, GCN, GraphConv, LocalGraphs,
                   ProposalLocalGraphs, roi_align_rotated_np)
from .fce_textsnake import (FCEHead, FCELoss, FCENetModule, FPNDet,
                            FPN_UNet, TextSnakeHead, TextSnakeLoss,
                            TextSnakeModule, UpBlock)
from .maskrcnn import (BoxHead, MaskHead, MaskRCNNDetector, MaskRCNNModule,
                       RoIHead, RPNHead, roi_align, roi_align_np)
from .pan import (Bottleneck, FPEM_FFM, FPNF, PANHead, PANLoss, PANetModule,
                  PSELoss, ResNetDet50)
from .postprocess import (DBPostprocessor, FCEPostprocessor,
                          PANPostprocessor, PSEPostprocessor,
                          TextSnakePostprocessor, eval_hmean_iou,
                          fourier2poly, poly_nms)
from .targets import (DBNetTargets, DRRGTargets, FCENetTargets,
                      PANetTargets, PSENetTargets, TextSnakeTargets)

__all__ = ['ResNetDet', 'FPNC', 'DBHead', 'DBLoss', 'DBNetModule',
           'Bottleneck', 'ResNetDet50', 'FPEM_FFM', 'FPNF', 'PANHead',
           'PANLoss', 'PSELoss', 'PANetModule', 'FPNDet', 'FCEHead',
           'FCELoss', 'FCENetModule', 'UpBlock', 'FPN_UNet',
           'TextSnakeHead', 'TextSnakeLoss', 'TextSnakeModule',
           'DBPostprocessor', 'PANPostprocessor', 'PSEPostprocessor',
           'FCEPostprocessor', 'TextSnakePostprocessor', 'fourier2poly',
           'poly_nms', 'DBNetTargets', 'PANetTargets', 'PSENetTargets',
           'TextSnakeTargets', 'FCENetTargets', 'eval_hmean_iou',
           'DRRGHead', 'DRRGLoss', 'DRRGModule', 'DRRGDetector',
           'DRRGPostprocessor', 'DRRGTargets', 'GCN', 'GraphConv',
           'LocalGraphs', 'ProposalLocalGraphs', 'roi_align_rotated_np',
           'BoxHead', 'MaskHead', 'MaskRCNNDetector', 'MaskRCNNModule',
           'RoIHead', 'RPNHead', 'roi_align', 'roi_align_np']
