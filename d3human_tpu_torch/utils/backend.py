"""The process-wide PyTorch settings every entry point of the port makes.

``configure_backends`` keeps float32 float32, as the JAX package computes
at "highest" (no TF32 in matrix products or cuDNN convolutions), and makes
cuDNN pick deterministic convolution algorithms (no autotuning), so that
two runs on a card add in the same order. It does not switch on
``torch.use_deterministic_algorithms``: the port's step paths hold no op
that PyTorch lists as nondeterministic on CUDA
(``tests/test_torch_determinism.py``), and the global switch would only
hide the next one.
"""

from __future__ import annotations

import torch


def configure_backends() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def device_or_exit(name: str, requested: str) -> torch.device:
    """The device of an entry point's ``--device``, the backends
    configured; a CUDA device without a card ends the run with a message
    (no entry point drops to the CPU)."""
    dev = torch.device(requested)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: --device {requested} but no CUDA device "
                         "is available (pass --device cpu for a CPU run)")
    configure_backends()
    return dev
