"""KIE: SDMGR (counterpart of ``tps_pp_tpu/models/kie``)."""
from .sdmgr import (SDMGR, BlockFusion, GNNLayer, SDMGRHead, SDMGRLoss,
                    build_sdmgr, roi_visual_pool)

__all__ = ['SDMGR', 'SDMGRHead', 'SDMGRLoss', 'GNNLayer', 'BlockFusion',
           'build_sdmgr', 'roi_visual_pool']
