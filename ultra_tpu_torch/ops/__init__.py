"""Relational message-passing ops and their CUDA kernels."""

from ultra_tpu_torch.ops.rspmm import degree, generalized_rspmm, rspmm_from_graph, spmm_max
from ultra_tpu_torch.ops import variadic
