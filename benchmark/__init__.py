"""The benchmark of the PyTorch and CUDA port (``pinot_tpu_torch``)."""
