"""File and environment utilities (counterpart of
``tps_pp_tpu/utils/fileio.py``; the reference's ``mmocr/utils/fileio.py``
``list_from_file`` / ``list_to_file`` and ``collect_env``)."""
from __future__ import annotations

import os
import platform
import shutil
import subprocess
import sys
from typing import Iterable, List


def list_from_file(filename: str, encoding: str = 'utf-8') -> List[str]:
    """The lines of ``filename`` without their line ends."""
    with open(filename, encoding=encoding) as f:
        return [line.rstrip('\r\n') for line in f]


def list_to_file(filename: str, lines: Iterable[str],
                 encoding: str = 'utf-8'):
    """Write ``lines``, one a line, making the directory where needed."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, 'w', encoding=encoding) as f:
        for line in lines:
            f.write(f'{line}\n')


def collect_env() -> dict:
    """The environment the port runs in: Python, torch and its CUDA, the
    card's name, ``nvcc``'s version, whether the kernel library for the
    current sources is built, and numpy's and cv2's versions (cv2
    ``missing`` where it is absent: only JPEG bodies and drawing need
    it)."""
    import torch

    from ..ops import _lib
    info = {
        'sys.platform': sys.platform,
        'python': sys.version.replace('\n', ''),
        'machine': platform.machine(),
        'torch': torch.__version__,
        'torch.version.cuda': torch.version.cuda,
        'cuda.is_available': torch.cuda.is_available(),
    }
    if torch.cuda.is_available():
        info['cuda.device'] = torch.cuda.get_device_name(0)
        info['cuda.device_count'] = torch.cuda.device_count()
    try:
        nvcc = _lib._nvcc()
        out = subprocess.run([nvcc, '--version'], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        info['nvcc'] = out.splitlines()[-1] if out else nvcc
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        info['nvcc'] = f'missing ({e})'
    lib = _lib.library_path()
    info['kernels'] = (f'built ({lib.name})' if lib.exists()
                       else f'not built ({lib.name})')
    for mod in ('numpy', 'cv2'):
        try:
            info[mod] = getattr(__import__(mod), '__version__', 'unknown')
        except ImportError:
            info[mod] = 'missing'
    info['nvidia-smi'] = shutil.which('nvidia-smi') or 'missing'
    return info
