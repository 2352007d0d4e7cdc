"""PyTorch/CUDA port of pinot-tpu's single-server query path.

The package mirrors ``pinot_tpu``'s layout (``spi/``, ``segment/``,
``query/``, ``engine/``, ``tools/``) so each module's counterpart is easy to
find. It imports ``torch`` and ``numpy`` only. Entry points run on the CUDA
card by default and raise on a host without one; the CPU is used only when
the caller passes ``device="cpu"``.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    # imported at first use, so that a stdlib-only tool of the package
    # (``tools/lint``) runs without importing torch
    if name == "resolve_device":
        from pinot_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'pinot_tpu_torch' has no attribute "
                         f"{name!r}")
