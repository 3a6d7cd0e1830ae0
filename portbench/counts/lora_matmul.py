"""Operations and bytes of the calls into ``csrc/lora_matmul.cu``: the
fused product ``x W + (x A) B s``, two-dimensional (``lora_matmul``) and
stacked by expert (``lora_matmul_experts``).  An expert call counts the
rows its experts were given (capacity slots left empty need no work) and
the weights of the experts that have rows."""

KERNELS = r"lora_(wgmma|matmul)_kernel"
ENTRIES = ("lora_matmul", "lora_matmul_experts")


def cost(call):
    K, N, r, e = call["K"], call["N"], call["r"], call["elem"]
    rows, experts = call["rows"], call.get("experts", 1)
    flops = 2.0 * rows * (K * N + K * r + r * N)
    nbytes = e * (experts * (K * N + K * r + r * N) + rows * (K + N))
    return flops, nbytes
