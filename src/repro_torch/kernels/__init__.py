"""Kernels of the port: plain PyTorch versions (``ref``), the CUDA kernel
wrappers (``topk_router``, ``flash_attention``, ``ragged_dispatch``), their
build and launch counters (``_build``) and the device dispatch between the
two (``backend``).  Importing this package builds nothing: the CUDA
library is compiled at the first kernel launch."""
