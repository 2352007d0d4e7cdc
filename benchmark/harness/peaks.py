"""The published peak the rooflines are stated against.

NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): 80 GB of HBM3
at 3.35 TB/s. Every run prints the card's name and power limit beside its
numbers.
"""

HBM_BYTES_PER_S = 3.35e12
