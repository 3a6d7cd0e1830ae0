"""Peaks of one NVIDIA H100 SXM (the data sheet's dense rates at the 700 W
limit): the denominators of every roofline and ``mfu`` share."""
import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
MFU_PEAK = PEAK_FLOPS[torch.bfloat16]


def least_time(flops: float, nbytes: float, dtype) -> float:
    """The least seconds the card can take: operations at its peak or bytes
    at its bandwidth, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
