"""Runtime introspection: the port of the JAX package's `utils/runtime.py`
(the analog of the reference's one-shot SIMD-mode log,
`dpf/internal/get_hwy_mode.{h,cc}`).

Where the JAX package reports its JAX backend, the port reports the
PyTorch backend it runs on: the backend, the device count, the device
name and compute capability, and the torch and CUDA versions.
"""

from __future__ import annotations

import logging

import torch

_logged = False


def get_backend_mode_string() -> str:
    """One line naming the backend the port runs on."""
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        return (
            f"backend=cuda devices={torch.cuda.device_count()} "
            f"kinds={torch.cuda.get_device_name(0)} capability={major}.{minor} "
            f"torch={torch.__version__} cuda={torch.version.cuda}"
        )
    return f"backend=cpu devices=0 torch={torch.__version__} cuda={torch.version.cuda}"


def log_backend_mode_once(logger: logging.Logger | None = None) -> None:
    """Logs the execution mode once per process, like the reference's
    `LOG_FIRST_N(INFO, 1)`."""
    global _logged
    if _logged:
        return
    _logged = True
    (logger or logging.getLogger(__name__)).info(
        "distributed_point_functions_tpu_torch is in mode %s",
        get_backend_mode_string(),
    )
