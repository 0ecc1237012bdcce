"""PyTorch / CUDA port of the FlexiDiT system (``src/repro/`` is the JAX
reference). It mirrors the reference's module layout; the segment-aware
flash attention is a CUDA kernel for Hopper (``csrc/``). Entry points run
on CUDA unless the caller passes ``device="cpu"``."""
