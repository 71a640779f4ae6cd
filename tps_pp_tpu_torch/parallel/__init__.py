from . import dist, tp
from .dist import maybe_init_distributed
from .mesh import Mesh, create_mesh, param_sharding
from .train import (OptimizerChain, build_optimizer,
                    build_optimizer_from_run_cfg, make_lr_schedule,
                    make_train_step, paramwise_lr_mult, step_generator)

__all__ = ['Mesh', 'OptimizerChain', 'build_optimizer',
           'build_optimizer_from_run_cfg', 'create_mesh', 'dist',
           'make_lr_schedule', 'make_train_step', 'maybe_init_distributed',
           'param_sharding', 'paramwise_lr_mult', 'step_generator', 'tp']
