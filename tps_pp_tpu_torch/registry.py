"""Registries of the port (counterpart of ``tps_pp_tpu/registry.py``).

The same ``dict(type='Name', **kwargs)`` convention as the JAX package, with
the port's own instances: nothing registers into the JAX package's shared
``MODELS`` namespace. The class is a small copy rather than an import, so
the port and everything that drives it load without the JAX package.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """Maps ``type=`` names to classes."""

    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Callable] = {}

    def get(self, key: str) -> Callable:
        if key not in self._modules:
            raise KeyError(f"'{key}' is not registered in '{self.name}' "
                           f'(available: {sorted(self._modules)})')
        return self._modules[key]

    def register_module(self, name: Optional[str] = None):
        """Class decorator: ``@REG.register_module()``."""
        def _register(cls):
            key = name or cls.__name__
            if self._modules.get(key, cls) is not cls:
                raise KeyError(f"'{key}' already registered in '{self.name}'")
            self._modules[key] = cls
            return cls
        return _register

    def build(self, cfg: Any, **default_kwargs):
        """Instantiate ``dict(type='Name', **kwargs)``; ``default_kwargs``
        fill keys the config leaves out, where the class takes them."""
        cfg = dict(cfg)
        cls = self.get(cfg.pop('type'))
        params = inspect.signature(cls).parameters
        for k, v in default_kwargs.items():
            if k in params:
                cfg.setdefault(k, v)
        return cls(**cfg)


BACKBONES = Registry('torch_backbones')
RECTIFIERS = Registry('torch_rectifiers')
PREPROCESSORS = Registry('torch_preprocessors')
ENCODERS = Registry('torch_encoders')
DECODERS = Registry('torch_decoders')
FUSERS = Registry('torch_fusers')
# the segmentation recognizer's neck and head
NECKS = Registry('torch_necks')
HEADS = Registry('torch_heads')
CONVERTORS = Registry('torch_convertors')
LOSSES = Registry('torch_losses')
# data side: the test pipeline's transforms, datasets, annotation loaders
# and their line parsers
PIPELINES = Registry('torch_pipelines')
DATASETS = Registry('torch_datasets')
LOADERS = Registry('torch_loaders')
PARSERS = Registry('torch_parsers')
