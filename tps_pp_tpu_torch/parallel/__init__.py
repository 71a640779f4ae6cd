from . import dist
from .dist import maybe_init_distributed
from .train import (OptimizerChain, build_optimizer,
                    build_optimizer_from_run_cfg, make_lr_schedule,
                    make_train_step, paramwise_lr_mult, step_generator)

__all__ = ['OptimizerChain', 'build_optimizer',
           'build_optimizer_from_run_cfg', 'dist', 'make_lr_schedule',
           'make_train_step', 'maybe_init_distributed', 'paramwise_lr_mult',
           'step_generator']
