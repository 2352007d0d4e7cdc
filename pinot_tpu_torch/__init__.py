"""PyTorch/CUDA port of pinot-tpu's single-server query path.

The package mirrors ``pinot_tpu``'s layout (``spi/``, ``segment/``,
``query/``, ``engine/``, ``tools/``) so each module's counterpart is easy to
find. It imports ``torch`` and ``numpy`` only. Entry points run on the CUDA
card by default and raise on a host without one; the CPU is used only when
the caller passes ``device="cpu"``.
"""

from pinot_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
