"""simka-tpu-torch: the PyTorch/CUDA port of simka-tpu.

The exact Simka pipeline (per-sample k-mer spectra joined across
samples into ecological distance matrices) with its device work in
PyTorch and its kernels written by hand for NVIDIA Hopper
(``csrc/``). The package mirrors ``simka_tpu``'s layout (``io/``,
``ops/``, ``core/``, ``utils/``, ``cli.py``) and imports neither JAX
nor ``simka_tpu``: the host modules are jax-free copies, held against
their originals by the tests.

The device is always explicit. Every device function takes a
``device`` argument, and asking for CUDA where there is none raises;
nothing falls back to the CPU behind the caller's back.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

from simka_tpu_torch.config import SimkaConfig  # noqa: E402,F401


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"`` as a ``torch.device``.

    Raises RuntimeError for ``"cuda"`` when no CUDA device is present,
    and ValueError for any other name.
    """
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() "
                "is false; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown device {name!r} (expected 'cuda' or 'cpu')")
