"""Operations and bytes of the grouped expert product of
``csrc/ragged_dispatch.cu`` (its adapter body included): the rows routed
to each expert (the plan's padding rows need no work), and the weights of
the experts that received rows."""

KERNELS = r"ragged_(wgmma|matmul)_kernel"
ENTRIES = ("ragged_expert_matmul",)


def cost(call):
    K, N, r, e = call["K"], call["N"], call["r"], call["elem"]
    rows, experts = call["rows"], call["experts"]
    flops = 2.0 * rows * (K * N + K * r + r * N)
    nbytes = e * (experts * (K * N + K * r + r * N) + rows * (K + N))
    return flops, nbytes
