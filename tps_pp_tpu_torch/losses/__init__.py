from .abi import ABILoss, masked_ce_by_length
from .ce import CELoss, SARLoss, TFLoss, masked_ce
from .ctc import CTCLoss
from .kd import KD_Loss, kd_loss, pod_spatial_loss_v2

__all__ = ['ABILoss', 'CELoss', 'CTCLoss', 'KD_Loss', 'SARLoss', 'TFLoss',
           'kd_loss', 'masked_ce', 'masked_ce_by_length',
           'pod_spatial_loss_v2']
