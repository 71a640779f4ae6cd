from .train import (OptimizerChain, build_optimizer,
                    build_optimizer_from_run_cfg, make_lr_schedule,
                    make_train_step, paramwise_lr_mult)

__all__ = ['OptimizerChain', 'build_optimizer',
           'build_optimizer_from_run_cfg', 'make_lr_schedule',
           'make_train_step', 'paramwise_lr_mult']
