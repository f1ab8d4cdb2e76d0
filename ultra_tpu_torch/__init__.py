"""PyTorch/CUDA port of ``ultra_tpu``: zero-shot ULTRA link prediction on an
NVIDIA Hopper GPU.

Module names mirror ``ultra_tpu``'s, so each port module sits beside its
counterpart. The package imports torch and numpy only. Entry points take a
``device`` argument that defaults to ``"cuda"``; without a card they raise
unless the caller passes ``device="cpu"``. On the CPU every kernel wrapper
runs its plain PyTorch version; on a CUDA tensor it launches the
hand-written kernel from ``csrc/`` or raises.
"""
