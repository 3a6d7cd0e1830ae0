"""Operations and bytes of ``csrc/flash_attention.cu``'s causal forward:
each query against the keys at or before it (scores and values), q, k and
v read once and the output written once."""

KERNELS = r"flash_(mma|fwd)_kernel"
ENTRIES = ("flash_attention",)


def cost(call):
    B, S, H, KV, D, e = (call[k] for k in ("B", "S", "H", "KV", "D", "elem"))
    flops = 2.0 * B * H * D * S * (S + 1)
    nbytes = e * B * S * D * (2 * H + 2 * KV)
    return flops, nbytes
