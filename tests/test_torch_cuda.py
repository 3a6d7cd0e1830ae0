"""The port's CUDA kernels and engine on the card, against the plain versions.

Every test here needs a CUDA device and skips without one (the fixture
decides, at run time).  The file imports no JAX, so it also runs where
JAX is not installed, without the suite's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: routing masks and counts exactly, router weights 1e-6
(float32); bf16 outputs 1e-2 relative + 1e-2 absolute and fp16 outputs
2e-3 + 2e-3 (one rounding on each side, at most an ulp apart — 2^-8 and
2^-11 relative —, different fp32 summation order; flash also rounds P to
the input type for P·V); float32 flash, LoRA matmuls and
gradients 1e-4 (different summation order over K up to 2048); a local
round on the card against the CPU: losses 1e-4, activation counts
exactly, adapters within 1e-5 on at least 99.9% of elements and within
2·lr·steps everywhere (Adam normalises each step's gradient, so an
element whose gradient is about 0 may step the other way).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.core import lora as tlora
from repro_torch.federated import client as tclient
from repro_torch.kernels import _build, backend
from repro_torch.kernels import ragged_dispatch as trd
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention as t_flash
from repro_torch.kernels.lora_matmul import lora_matmul as t_lora
from repro_torch.kernels.lora_matmul import \
    lora_matmul_experts as t_lora_experts
from repro_torch.kernels.topk_router import \
    adaptive_topk_router as t_adaptive_router
from repro_torch.kernels.topk_router import topk_router as t_router
from repro_torch.models import model as tmodel
from repro_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _close_16bit(got, want):
    tol = 2e-3 if got.dtype == torch.float16 else 1e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _check_router(got, want):
    """Masks and counts exactly, weights within 1e-6; NaN where the plain
    version has NaN."""
    w, m, c = got
    pw, pm, pc = want
    assert torch.equal(m, pm) and torch.equal(c, pc)
    torch.testing.assert_close(w, pw, rtol=0, atol=1e-6, equal_nan=True)


def _budgets(T, max_k, g, device):
    """Per-token budgets in [0, max_k + 2]: zeros, and values above max_k
    that the kernel clamps, as the plain version's ``rank < k_tok`` does."""
    return torch.randint(0, max_k + 3, (T,), generator=g,
                         dtype=torch.int32).to(device)


# E: one to sixteen experts per lane, 33 an odd width (element loads);
# T: none, one row, the decode step, several blocks, more rows than the
# grid (each warp loops); k: none to all
_ROUTER_CASES = [(E, k) for E in (8, 33, 64, 128, 512)
                 for k in sorted({0, 1, 2, 8, E})]
# qwen2-moe-a2.7b: 60 experts, two per lane with the last lane's empty
_ROUTER_CASES += [(60, 4), (60, 60)]
# jamba-v0.1-52b: 16 experts at top-2, half a lane's worth
_ROUTER_CASES += [(16, 2), (16, 16)]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("E,k", _ROUTER_CASES)
def test_cuda_router_matches_plain(cuda, dtype, E, k):
    """Both entries of the router kernel against their plain versions,
    one launch per call; uniform budgets equal the static entry bit for
    bit."""
    g = torch.Generator().manual_seed(E * 31 + k)
    for T in (0, 1, 8, 300, 4096):
        logits = torch.randn(T, E, generator=g).to(cuda, dtype)
        k_tok = _budgets(T, k, g, cuda)
        before = dict(_build.LAUNCHES)
        static = t_router(logits, k)
        adaptive = t_adaptive_router(logits, k_tok, k)
        uniform = t_adaptive_router(
            logits, torch.full((T,), k, dtype=torch.int32, device=cuda), k)
        assert _build.LAUNCHES["topk_router"] == before["topk_router"] + 1
        assert (_build.LAUNCHES["adaptive_topk_router"]
                == before["adaptive_topk_router"] + 2)
        _check_router(static, tref.topk_router_ref(logits, k))
        _check_router(adaptive,
                      tref.adaptive_topk_router_ref(logits, k_tok, k))
        for a, b in zip(uniform, static):
            assert torch.equal(a, b), f"T={T}: uniform budgets differ"


@pytest.mark.parametrize("dtype", _DTYPES)
def test_cuda_routers_tied_and_nonfinite_rows(cuda, dtype):
    """Rows of equal logits (the lowest indices win), a NaN, a +inf, all
    -inf (all-NaN softmax: expert 0 in every round, weights NaN),
    probabilities that underflow to 0 (a chosen expert is chosen again),
    and finite rows, spread over several blocks; both entries."""
    E, k, T = 64, 8, 600
    logits = torch.randn(T, E, generator=torch.Generator().manual_seed(9))
    logits[6::50] = 0.5                                   # ties
    logits[1::50, 3] = float("nan")
    logits[2::50, 60] = float("inf")
    logits[3::50] = float("-inf")
    logits[4::50, 10] = float("-inf")
    logits[5::50] = torch.arange(E) * -300.0              # underflow
    logits = logits.to(cuda, dtype)
    k_tok = _budgets(T, k, torch.Generator().manual_seed(10), cuda)
    static = t_router(logits, k)
    _check_router(static, tref.topk_router_ref(logits, k))
    _check_router(t_adaptive_router(logits, k_tok, k),
                  tref.adaptive_topk_router_ref(logits, k_tok, k))
    w, m, _ = static
    assert bool((m[6::50, :k] == 1).all()) and bool((m[6::50, k:] == 0).all())
    for r in (1, 2, 3):                 # NaN, +inf, all -inf
        assert bool((m[r::50, 0] == k).all()) and bool(w[r::50].isnan().all())
    assert bool((m[5::50, 0] == k).all())   # p = (1, 0, ...): 0 chosen again


def test_cuda_router_counts_reset_between_calls(cuda):
    """The count scratch is left zeroed by each call: repeated calls of
    many blocks, and calls of other widths in between, give equal counts."""
    g = torch.Generator().manual_seed(11)
    big = torch.randn(4096, 64, generator=g).to(cuda, torch.bfloat16)
    wide = torch.randn(2000, 512, generator=g).to(cuda)
    k_tok = _budgets(4096, 8, g, cuda)
    want = tref.topk_router_ref(big, 8)[2]
    want_ad = tref.adaptive_topk_router_ref(big, k_tok, 8)[2]
    for _ in range(3):
        assert torch.equal(t_router(big, 8)[2], want)
        assert torch.equal(t_adaptive_router(big, k_tok, 8)[2], want_ad)
        t_router(wide, 2)
        t_router(big[:5], 8)                    # one block: no scratch


@pytest.mark.parametrize("T", [8, 4096])
def test_cuda_router_call_is_one_kernel(cuda, T):
    """One router call is one device kernel: no memset, no second pass."""
    logits = torch.randn(T, 64, device=cuda).to(torch.bfloat16)
    k_tok = torch.full((T,), 4, dtype=torch.int32, device=cuda)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for call in (lambda: t_router(logits, 8),
                 lambda: t_adaptive_router(logits, k_tok, 8)):
        # build and load first; the first profiler window of a process can
        # come back without device events, so a throwaway window precedes
        # the one that is checked
        for _ in range(2):
            call()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                call()
                torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 1 and "router_kernel" in names[0], names


_FLASH_CASES = [(256, 16, 16, 128, 0, 0), (100, 8, 2, 64, 0, 0),
                (77, 4, 4, 32, 16, 0)]
# the registry's head layouts: GQA 24/8 (phi4-mini), MQA 48/1 (granite),
# 64/8 (chameleon), and a 1024-token training sequence
_FLASH_CASES += [(256, 24, 8, 128, 0, 0), (256, 48, 1, 128, 0, 0),
                 (130, 64, 8, 128, 0, 0), (1024, 16, 16, 128, 0, 0)]
# jamba-v0.1-52b's attention layers: GQA 32/8, D = 128
_FLASH_CASES += [(128, 32, 8, 128, 0, 0), (256, 32, 8, 128, 0, 0)]
# musicgen-large's: MHA 32/32 at D = 64 (a client step's 128 tokens, and
# 1024 of the train step's)
_FLASH_CASES += [(128, 32, 32, 64, 0, 0), (1024, 32, 32, 64, 0, 0)]
# the tile edges of the tensor-core kernel (64-query blocks, 64-key tiles)
_FLASH_CASES += [(S, 8, KV, D, window, 0) for S in (1, 63, 65, 128, 256)
                 for D in (32, 64, 128) for KV in (8, 2) for window in (0, 16)]
# pad 1: head stride D + 1, so no row of q, k, v or out is 16-byte aligned
_FLASH_CASES += [(1, 4, 4, 32, 0, 1), (63, 8, 2, 32, 16, 1),
                 (65, 8, 2, 128, 0, 1), (128, 8, 8, 64, 16, 1),
                 (256, 16, 16, 128, 0, 1)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("S,H,KV,D,window,pad", _FLASH_CASES)
def test_cuda_flash_matches_plain(cuda, dtype, S, H, KV, D, window, pad):
    """bf16 and fp16 run the mma.sync kernel; q/k/v are transposed views of
    model-layout (B, S, H, D + pad) buffers and the result goes through
    ``out=`` into a transposed view of another, as ``backend._Flash``
    passes them (pad 0).  With pad 1 the kernel takes its element-load
    path (masked loads, element stores), which must leave the buffers'
    padding column alone."""
    q, k, v, out = (torch.randn(2, S, n, D + pad, device=cuda).to(dtype)
                    for n in (H, KV, KV, H))
    tail = out[..., D:].clone()
    qt, kt, vt, ot = (t[..., :D].transpose(1, 2) for t in (q, k, v, out))
    before = _build.LAUNCHES["flash_attention"]
    got = t_flash(qt, kt, vt, window=window, out=ot)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out[..., D:], tail)
    _close_16bit(ot, tref.flash_attention_ref(qt, kt, vt, window=window))


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,KV,window", [(8, 8, 0), (8, 2, 0), (8, 2, 100)])
def test_cuda_flash_softcap_matches_plain(cuda, dtype, D, H, KV, window):
    """The logit softcap inside both kernels (bf16 / fp16 on mma.sync,
    float32 on the FMA kernel), through the model-layout entry: causal
    and windowed (the window's tile skipping), MHA and GQA, S = 300 (a
    ragged last tile).  Inputs at three times unit scale and a cap of 10,
    so scores pass the cap; the capped result differs from the uncapped
    one."""
    g = torch.Generator(device=cuda).manual_seed(D + H + KV + window)
    q = (3 * torch.randn(2, 300, H, D, generator=g, device=cuda)).to(dtype)
    k = (3 * torch.randn(2, 300, KV, D, generator=g, device=cuda)).to(dtype)
    v = torch.randn(2, 300, KV, D, generator=g, device=cuda).to(dtype)
    before = _build.LAUNCHES["flash_attention"]
    got = backend.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=10.0)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    want = tref.flash_attention_ref(qt, kt, vt, window=window,
                                    softcap=10.0).transpose(1, 2)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _close_16bit(got, want)
    free = tref.flash_attention_ref(qt, kt, vt, window=window).transpose(1, 2)
    assert (want.float() - free.float()).abs().max() > 0.1
    with pytest.raises(ValueError, match="softcap"):
        t_flash(qt, kt, vt, softcap=-1.0)


def test_cuda_flash_float32_contiguous(cuda):
    """float32 runs the FMA kernel, on contiguous (B, H, S, D) operands."""
    q = torch.randn(2, 8, 100, 64, device=cuda)
    k = torch.randn(2, 2, 100, 64, device=cuda)
    v = torch.randn(2, 2, 100, 64, device=cuda)
    torch.testing.assert_close(t_flash(q, k, v),
                               tref.flash_attention_ref(q, k, v),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lora", [False, True])
def test_cuda_ragged_trio_matches_plain(cuda, lora):
    T, E, k, D, H, r = 64, 16, 4, 256, 384, 8
    w_, m_, _ = tref.topk_router_ref(torch.randn(T, E, device=cuda), k)
    plan = trd.ragged_plan(m_, w_, budget=T * k, max_k=k)
    bf = dict(device=cuda, dtype=torch.bfloat16)
    x = torch.randn(T, D, **bf)
    xs = trd.ragged_gather(x, plan.src, plan.valid)
    assert torch.equal(xs, tref.ragged_gather_ref(x, plan.src, plan.valid))
    w = torch.randn(E, D, H, **bf) * D ** -0.5
    extra = (torch.randn(E, D, r, **bf) * D ** -0.5,
             torch.randn(E, r, H, **bf)) if lora else ()
    _close_16bit(trd.ragged_expert_matmul(xs, plan.block_expert, w, *extra,
                                         scale=0.5),
                tref.ragged_expert_matmul_ref(xs, plan.block_expert, w,
                                              *extra, scale=0.5))
    eo = torch.randn(xs.shape[0], H, **bf)
    _close_16bit(trd.ragged_combine(eo, plan.rows, plan.wrank),
                tref.ragged_combine_ref(eo, plan.rows, plan.wrank))


# (kind, T, max_k, D).  max_k 1, 2, 4 and 8 take the combine's unrolled
# kernels, 3 and 40 its loop over ranks (40: three batches of 16); T = 13,
# 37 and 301 are not multiples of the combine block's 4 tokens, T = 1 is
# one warp; D = 100 and 77 are not multiples of the 16-byte vector (the
# scalar slices), D = 24 and 64 fill part of a warp's chunk.  decode: 8
# slots at tiers (8,8,4,4,2,2,1,0) from adaptive_topk_router_ref, so
# zero-weight ranks and a k = 0 slot; nonfinite: that plan with inf and NaN
# in row 0 of x and of eo, which padding rows and zero-weight ranks read
# and multiply by 0
_ROW_CASES = [("topk", 64, 1, 256), ("topk", 64, 2, 2048),
              ("topk", 37, 3, 2048), ("topk", 13, 4, 64),
              ("topk", 301, 8, 256),
              ("topk", 256, 8, 2048), ("topk", 1, 8, 2048),
              ("topk", 20, 8, 100), ("topk", 7, 3, 77), ("topk", 5, 40, 24),
              ("decode", 8, 8, 2048), ("nonfinite", 8, 8, 2048),
              ("nonfinite", 8, 8, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("kind,T,max_k,D", _ROW_CASES)
def test_cuda_gather_and_combine_match_plain(cuda, dtype, kind, T, max_k, D):
    """The gather equals the plain version exactly (NaN where it has NaN),
    the combine within the 16-bit tolerance (float32 1e-4: the plain sum
    may take the ranks in another order); one launch per call."""
    E = 64
    g = torch.Generator().manual_seed(100 * T + 10 * max_k + D)
    logits = torch.randn(T, E, generator=g)
    if kind == "topk":
        w_, m_, _ = tref.topk_router_ref(logits, max_k)
        budget = T * max_k
    else:
        tiers = torch.tensor([8, 8, 4, 4, 2, 2, 1, 0])
        w_, m_, _ = tref.adaptive_topk_router_ref(logits, tiers, max_k)
        budget = int(tiers.sum())
    plan = trd.ragged_plan(m_.to(cuda), w_.to(cuda), budget=budget,
                           max_k=max_k)
    x = torch.randn(T, D, generator=g).to(cuda, dtype)
    eo = torch.randn(plan.src.shape[0], D, generator=g).to(cuda, dtype)
    if kind == "nonfinite":
        for t in (x, eo):
            t[0, ::2], t[0, 1::2] = float("inf"), float("nan")
    before = dict(_build.LAUNCHES)
    xs = trd.ragged_gather(x, plan.src, plan.valid)
    out = trd.ragged_combine(eo, plan.rows, plan.wrank)
    for name in ("ragged_gather", "ragged_combine"):
        assert _build.LAUNCHES[name] == before[name] + 1
    want_xs = tref.ragged_gather_ref(x, plan.src, plan.valid)
    want = tref.ragged_combine_ref(eo, plan.rows, plan.wrank)
    torch.testing.assert_close(xs, want_xs, rtol=0, atol=0, equal_nan=True)
    tol = {torch.float32: 1e-4, torch.float16: 2e-3}.get(dtype, 1e-2)
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol,
                               equal_nan=True)
    if kind == "nonfinite":     # the case reaches what it is about
        pad = plan.valid == 0
        assert bool(pad.any()) and bool(xs[pad].isnan().all())
        assert bool((plan.wrank == 0).any()) and bool(out[7].isnan().all())


def test_cuda_plan_matches_cpu_plan(cuda):
    w_, m_, _ = tref.topk_router_ref(torch.randn(40, 8), 3)
    cpu = trd.ragged_plan(m_, w_, budget=120, max_k=3)
    gpu = trd.ragged_plan(m_.to(cuda), w_.to(cuda), budget=120, max_k=3)
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu())


def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab_size, (int(rng.integers(4, 11)),)).astype(
                    np.int32), max_new_tokens=4, k=(2, 1)[i % 2])
            for i in range(n)]


def test_cuda_engine_matches_cpu_engine(cuda):
    """The engine on the CUDA kernels emits the CPU engine's greedy tokens
    (float32 weights, so routing decisions agree), and its main path
    launches all five serving kernels and no LoRA matmul (no adapters)."""
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(num_slots=4, slot_len=20, slot_k=(2, 2, 1, 1), block_size=4)
    cpu = ServingEngine(cfg, params, **kw).run(_requests(cfg, 8, 4))
    on_card = _to(params, cuda)
    _build.reset_launches()
    gpu = ServingEngine(cfg, on_card, **kw).run(_requests(cfg, 8, 4))
    for name, n in _build.LAUNCHES.items():
        assert (n == 0) if name.startswith("lora") else (n > 0), _build.LAUNCHES
    ct, gt = cpu.tokens_by_rid(), gpu.tokens_by_rid()
    for rid in ct:
        np.testing.assert_array_equal(gt[rid], ct[rid], err_msg=f"rid {rid}")


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_cuda_speculative_engine_matches_plain_decode(cuda, layout):
    """Greedy self-speculative decoding on the card (W = 3 drafts at k = 1,
    one full-k verify, rollback) gives plain decode's tokens on both KV
    layouts, float32 2-layer model, and its rounds run the static router
    (drafts), the per-token router (verify) and the ragged trio."""
    from repro_torch.serving import SpeculativeConfig
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(dtype="float32")
    params = _to(tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu"), cuda)
    kw = dict(num_slots=4, slot_len=24, slot_k=(2, 2, 1, 1), block_size=4,
              kv_layout=layout)
    plain = ServingEngine(cfg, params, **kw).run(_requests(cfg, 8, 4))
    _build.reset_launches()
    eng = ServingEngine(cfg, params, speculative=SpeculativeConfig(3, 1),
                        **kw)
    rep = eng.run(_requests(cfg, 8, 4))
    assert rep.spec_rounds > 0
    for name in ("topk_router", "adaptive_topk_router", "ragged_gather",
                 "ragged_expert_matmul", "ragged_combine"):
        assert _build.LAUNCHES[name] > 0, _build.LAUNCHES
    pt, st = plain.tokens_by_rid(), rep.tokens_by_rid()
    for rid in pt:
        np.testing.assert_array_equal(st[rid], pt[rid], err_msg=f"rid {rid}")
    assert eng.pool.num_free == 4


def _shared_prefix_requests(cfg, n, seed):
    """Prompts of 6 or 10 tokens opening with one of two 4-token prefixes,
    the last two repeating earlier prompts."""
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    reqs = []
    for i in range(n):
        p = rng.integers(0, cfg.vocab_size, (int(rng.choice((6, 10))),))
        p = p.astype(np.int32)
        p[:4] = heads[i % 2]
        if i >= n - 2:
            p = reqs[i - 2].prompt.copy()
        reqs.append(Request(rid=i, prompt=p, max_new_tokens=4,
                            k=(2, 1)[i % 2]))
    return reqs


def test_cuda_traffic_engine_matches_cpu_engine(cuda):
    """The traffic layer on the card (prefix cache with suffix prefill,
    EDF with an already-missed target for k=2, preemption): the CPU
    engine's tokens, prefix counters and preemptions (float32)."""
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(num_slots=4, slot_len=20, slot_k=(2, 2, 1, 1), block_size=4,
              prefix_cache=True, preemption=True,
              slo_ms={2: 0.0, 1: 60000.0})
    cpu = ServingEngine(cfg, params, **kw).run(
        _shared_prefix_requests(cfg, 10, 4))
    eng = ServingEngine(cfg, _to(params, cuda), **kw)
    gpu = eng.run(_shared_prefix_requests(cfg, 10, 4))
    ct, gt = cpu.tokens_by_rid(), gpu.tokens_by_rid()
    for rid in ct:
        np.testing.assert_array_equal(gt[rid], ct[rid], err_msg=f"rid {rid}")
    assert gpu.prefix == cpu.prefix and gpu.prefix["hit_tokens"] > 0
    assert gpu.preemptions == cpu.preemptions >= 1
    eng.pool.check_invariants()
    assert eng.pool.blocks_in_use == 0


@pytest.mark.parametrize("dtype", _DTYPES)
def test_cuda_block_copy_and_swap_are_bit_exact(cuda, dtype):
    """Copy-on-write on the card and a swap to the host and back leave
    the block contents bit for bit."""
    from repro_torch.serving import BlockPool
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(
        dtype=str(dtype).split(".")[1])
    pool = BlockPool(cfg, 2, 16, block_size=4, prefix_cache=True,
                     device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    for c in pool.cache.values():
        for leaf in c["attn"].values():
            leaf.copy_(torch.randn(leaf.shape, generator=g, device=cuda))
    prompt = np.arange(6, dtype=np.int32)
    rows = []
    for _ in range(2):
        s = pool.allocate()
        pool.reserve(s, 12)
        pool.attach_prefix(s, prompt, 6)
        pool.cache_pos[s] = 6
        rows.append(s)
    # the second row shares both blocks; its next write lands in block 1
    shared = int(pool.block_table[rows[1], 1])
    pool.prepare_decode([rows[1]])
    private = int(pool.block_table[rows[1], 1])
    assert private != shared and pool.prefix_stats()["cow_copies"] == 1
    leaves = [leaf for c in pool.cache.values() for leaf in c["attn"].values()]
    for leaf in leaves:
        assert torch.equal(leaf[:, private], leaf[:, shared])
    idx = torch.as_tensor(pool.block_table[rows[1], :2].astype(np.int64),
                          device=cuda)
    before = [leaf[:, idx].clone() for leaf in leaves]
    state = pool.swap_out(rows[1])
    s = pool.allocate()
    pool.reserve(s, 12)
    pool.swap_in(s, state)
    idx = torch.as_tensor(pool.block_table[s, :2].astype(np.int64),
                          device=cuda)
    for leaf, want in zip(leaves, before):
        assert torch.equal(leaf[:, idx], want)
    pool.check_invariants()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _lora_operands(cuda, lead, M, K, N, r, dtype):
    g = torch.Generator(device=cuda).manual_seed(M + K + r)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda)
                * scale).to(dtype)
    return (rn(*lead, M, K), rn(*lead, K, N, scale=K ** -0.5),
            rn(*lead, K, r, scale=K ** -0.5), rn(*lead, r, N, scale=0.5))


def _check_lora(got, want):
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _close_16bit(got, want)


def _ragged_blocks(kind, cuda):
    """(block_expert, N, E) of one plan shape for the grouped matmul."""
    E = 16
    g = torch.Generator().manual_seed(len(kind))
    if kind in ("plan", "empty", "skewed", "decode"):
        T, k = {"plan": (64, 4), "empty": (40, 2), "skewed": (200, 2),
                "decode": (8, 4)}[kind]
        logits = torch.randn(T, E, generator=g)
        if kind == "empty":      # experts 2, 9, 11 only: the last is empty
            logits[:, [2, 9, 11]] += 20.0
        if kind == "skewed":     # every token the same two experts
            logits = logits[:1].expand(T, E).contiguous()
        if kind == "decode":     # per-slot tiers
            kt = torch.tensor([4, 4, 2, 2, 1, 1, 1, 1])
            w_, m_, _ = tref.adaptive_topk_router_ref(logits, kt, k)
            plan = trd.ragged_plan(m_, w_, budget=16, max_k=k)
        else:
            w_, m_, _ = tref.topk_router_ref(logits, k)
            plan = trd.ragged_plan(m_, w_, budget=T * k, max_k=k)
        be = plan.block_expert
        return be.to(cuda), plan.src.shape[0], E
    nb, bm = {"unsorted": (50, 8), "bm1": (300, 1), "bm3": (40, 3)}[kind]
    be = torch.randint(0, E, (nb,), generator=g, dtype=torch.int32)
    if kind == "bm1":
        be = be.sort().values
    return be.to(cuda), nb * bm, E


# plan: runs of a few blocks and the trailing padding run; empty: empty
# experts, the last among them; skewed: runs of 200 rows (longer than the
# 128-row tile), N = 528 (not a multiple of 64 or 128); decode: 8 slots at
# tiers; unsorted: more runs than experts (the blocks take several tiles);
# bm1: tiles of 64 or 128 one-row blocks; K = 100 / H = 77: rows not
# 16-byte aligned (element loads); r 80 and bm 3: the FMA route of bf16 /
# fp16 (LoRA rank above 64, a row block that does not divide 64)
_RAGGED_CASES = [("plan", 256, 384, 0), ("plan", 256, 384, 4),
                 ("plan", 256, 384, 20), ("plan", 512, 256, 64),
                 ("empty", 256, 128, 0), ("skewed", 256, 384, 0),
                 ("skewed", 128, 256, 20), ("decode", 512, 256, 0),
                 ("plan", 100, 77, 0), ("plan", 100, 77, 20),
                 ("unsorted", 128, 128, 0), ("bm1", 64, 128, 0),
                 ("plan", 128, 128, 80), ("bm3", 64, 64, 0)]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("kind,K,H,r", _RAGGED_CASES)
def test_cuda_ragged_expert_matmul_matches_plain(cuda, dtype, kind, K, H, r):
    """bf16 / fp16 run the tensor-core kernel (tiles = runs of row blocks
    that share an expert, found on the card), float32 the FMA kernel; one
    launch per call; every row, the padding rows too, equals the plain
    version."""
    be, N, E = _ragged_blocks(kind, cuda)
    g = torch.Generator(device=cuda).manual_seed(K + H + r)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=cuda)
                * scale).to(dtype)

    xs, w = rn(N, K), rn(E, K, H, scale=K ** -0.5)
    extra = (rn(E, K, r, scale=K ** -0.5), rn(E, r, H)) if r else ()
    before = _build.LAUNCHES["ragged_expert_matmul"]
    got = trd.ragged_expert_matmul(xs, be, w, *extra, scale=0.7)
    assert _build.LAUNCHES["ragged_expert_matmul"] == before + 1
    _check_lora(got, tref.ragged_expert_matmul_ref(xs, be, w, *extra,
                                                   scale=0.7))


# M in {1, 37, 2047}, r in {1, 4, 20, 64}; K = 100 and N = 77 give rows that
# are not 16-byte aligned (the element-load path of the tensor-core kernel)
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("M,K,N,r", [(37, 100, 77, 4), (130, 256, 200, 20),
                                     (1, 5, 3, 64), (1, 64, 256, 1),
                                     (37, 128, 512, 64), (2047, 256, 384, 20),
                                     (2047, 100, 77, 4), (37, 2048, 256, 20),
                                     (1, 100, 77, 20), (2048, 2048, 8192, 40),
                                     (2048, 8192, 2048, 40),
                                     # the Mamba projections: mamba2-780m's
                                     # in_proj (N = 6448 ends in a partial
                                     # tile; HLoRA's rank 5 is odd) and
                                     # out_proj, jamba's in_proj
                                     (8, 1536, 6448, 16), (2048, 1536, 6448, 5),
                                     (256, 3072, 1536, 10),
                                     (2048, 4096, 16768, 16),
                                     # musicgen-large: q/k/v/o and the
                                     # FFN at ranks 16 and 5
                                     (2048, 2048, 2048, 16),
                                     (2048, 2048, 8192, 16),
                                     (2048, 8192, 2048, 16),
                                     (2048, 2048, 8192, 5),
                                     (2048, 8192, 2048, 5)])
def test_cuda_lora_matmul_matches_plain(cuda, dtype, M, K, N, r):
    x, w, a, b = _lora_operands(cuda, (), M, K, N, r, dtype)
    before = _build.LAUNCHES["lora_matmul"]
    got = t_lora(x, w, a, b, scale=1.7)
    assert _build.LAUNCHES["lora_matmul"] == before + 1
    _check_lora(got, tref.lora_matmul_ref(x, w, a, b, 1.7))


# C in {1, 41, 48, 168, 328} (one to three 128-row tiles, each with a
# ragged last tile), r in {1, 4, 20, 64}
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("E,C,K,N,r", [(3, 41, 100, 70, 4),
                                       (2, 64, 128, 256, 20),
                                       (2, 1, 64, 64, 1), (2, 48, 256, 128, 20),
                                       (2, 328, 128, 256, 64),
                                       (3, 41, 100, 77, 20),
                                       (2, 168, 512, 264, 4),
                                       # jamba's experts at the k = 2
                                       # client's capacity (w1)
                                       (16, 320, 4096, 14336, 16)])
def test_cuda_lora_matmul_experts_matches_plain(cuda, dtype, E, C, K, N, r):
    x, w, a, b = _lora_operands(cuda, (E,), C, K, N, r, dtype)
    before = _build.LAUNCHES["lora_matmul_experts"]
    got = t_lora_experts(x, w, a, b, scale=0.6)
    assert _build.LAUNCHES["lora_matmul_experts"] == before + 1
    _check_lora(got, tref.lora_matmul_experts_ref(x, w, a, b, 0.6))


def test_cuda_lora_wrappers_refuse_what_the_kernel_cannot_take(cuda):
    x, w, a, b = _lora_operands(cuda, (), 8, 16, 8, 4, torch.float32)
    with pytest.raises(TypeError):
        t_lora(x.double(), w, a, b, scale=1.0)
    with pytest.raises(ValueError, match="rank"):
        t_lora(x, w, torch.zeros(16, 65, device=cuda),
               torch.zeros(65, 8, device=cuda), scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        t_lora(x, w.T.contiguous().T, a, b, scale=1.0)
    with pytest.raises(ValueError, match="shape"):
        t_lora(x, w, a, b[:, :4].contiguous(), scale=1.0)


def _grads(fn, inputs, cot):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    return out, torch.autograd.grad(out, leaves, cot)


@pytest.mark.parametrize("op", ["lora_matmul", "lora_matmul_experts",
                                "router", "adaptive_router",
                                "flash_attention"])
def test_cuda_autograd_wrappers_match_plain_grads(cuda, op):
    """Gradients through each wrapper (kernel forward) against autograd
    through the plain version on the same card, float32, b != 0."""
    g = torch.Generator(device=cuda).manual_seed(7)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda) * scale
    if op == "lora_matmul":
        inputs = _lora_operands(cuda, (), 40, 64, 48, 20, torch.float32)
        wrap = lambda x, w, a, b: backend.lora_matmul(x, w, a, b, scale=0.9)
        plain = lambda x, w, a, b: tref.lora_matmul_ref(x, w, a, b, 0.9)
    elif op == "lora_matmul_experts":
        inputs = _lora_operands(cuda, (3,), 41, 64, 48, 4, torch.float32)
        wrap = lambda x, w, a, b: backend.lora_matmul_experts(
            x, w, a, b, scale=0.9)
        plain = lambda x, w, a, b: tref.lora_matmul_experts_ref(
            x, w, a, b, 0.9)
    elif op == "router":
        inputs = (rn(100, 64),)
        wrap = lambda l: backend.router(l, 8)
        plain = lambda l: tref.topk_router_ref(l, 8)
    elif op == "adaptive_router":
        inputs = (rn(100, 64),)
        k_tok = _budgets(100, 8, torch.Generator().manual_seed(8), cuda)
        wrap = lambda l: backend.adaptive_router(l, k_tok, 8)
        plain = lambda l: tref.adaptive_topk_router_ref(l, k_tok, 8)
    else:
        inputs = (rn(2, 50, 8, 64), rn(2, 50, 2, 64), rn(2, 50, 2, 64))
        wrap = lambda q, k, v: backend.flash_attention(q, k, v)
        plain = lambda q, k, v: tref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2)).transpose(1, 2)
    ref_out = plain(*inputs)
    cot = rn(*(ref_out[0] if isinstance(ref_out, tuple) else ref_out).shape)
    kname = {"router": "topk_router",
             "adaptive_router": "adaptive_topk_router"}.get(op, op)
    before = _build.LAUNCHES[kname]
    out_w, grads_w = _grads(wrap, inputs, cot)
    assert _build.LAUNCHES[kname] == before + 1
    out_p, grads_p = _grads(plain, inputs, cot)
    torch.testing.assert_close(out_w, out_p, rtol=1e-4, atol=1e-4)
    for gw, gp in zip(grads_w, grads_p):
        torch.testing.assert_close(gw, gp, rtol=1e-4, atol=1e-4)


def _mixed_plan(cuda, T=32, E=16, budgets=(1, 2, 8, 0)):
    """A ragged plan on the card at mixed per-token budgets (a 0 deselects
    the token), with padding rows in the segments and after them."""
    g = torch.Generator().manual_seed(T + E)
    logits = torch.randn(T, E, generator=g).to(cuda)
    k_tok = torch.tensor(budgets * (T // len(budgets)), dtype=torch.int32,
                         device=cuda)
    w_, m_, _ = tref.adaptive_topk_router_ref(logits, k_tok, max(budgets))
    plan = trd.ragged_plan(m_, w_, budget=int(k_tok.sum()),
                           max_k=max(budgets))
    assert int(plan.valid.sum()) < plan.valid.numel()
    return plan


@pytest.mark.parametrize("op", ["ragged_gather", "ragged_expert_matmul",
                                "ragged_expert_matmul_lora",
                                "ragged_combine"])
def test_cuda_ragged_functions_match_plain_grads(cuda, op):
    """The ragged trio's autograd Functions on the card (kernel forward,
    reference backward) against autograd through their plain versions,
    float32, adapter b != 0, mixed budgets (1, 2, 8, 0) with padding
    rows; every gradient nonzero."""
    plan = _mixed_plan(cuda)
    N, E, D, H = plan.src.shape[0], 16, 64, 48
    g = torch.Generator(device=cuda).manual_seed(11)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda) * scale
    if op == "ragged_gather":
        inputs = (rn(32, D),)
        wrap = lambda x: backend.ragged_gather(x, plan.src, plan.valid)
        plain = lambda x: tref.ragged_gather_ref(x, plan.src, plan.valid)
    elif op.startswith("ragged_expert_matmul"):
        inputs = (rn(N, D), rn(E, D, H, scale=D ** -0.5))
        if op.endswith("lora"):
            inputs += (rn(E, D, 20, scale=D ** -0.5), rn(E, 20, H))
        be = plan.block_expert
        wrap = lambda *t: backend.ragged_expert_matmul(t[0], be, *t[1:],
                                                       scale=0.7)
        plain = lambda *t: tref.ragged_expert_matmul_ref(t[0], be, *t[1:],
                                                         scale=0.7)
    else:
        inputs = (rn(N, D), plan.wrank)
        wrap = lambda eo, w: backend.ragged_combine(eo, plan.rows, w)
        plain = lambda eo, w: tref.ragged_combine_ref(eo, plan.rows, w)
    cot = rn(*plain(*inputs).shape)
    kname = op.replace("_lora", "")
    before = _build.LAUNCHES[kname]
    out_w, grads_w = _grads(wrap, inputs, cot)
    assert _build.LAUNCHES[kname] == before + 1
    out_p, grads_p = _grads(plain, inputs, cot)
    torch.testing.assert_close(out_w, out_p, rtol=1e-4, atol=1e-4)
    for gw, gp in zip(grads_w, grads_p):
        torch.testing.assert_close(gw, gp, rtol=1e-4, atol=1e-4)
        assert gw.abs().max() > 0


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("K,H", [(2048, 1024), (1024, 2048)])
def test_cuda_ragged_lora_route_at_the_decode_shape(cuda, dtype, K, H):
    """The grouped matmul with expert adapters (rank 20) at OLMoE's decode
    step: 8 slots at tiers (8,8,4,4,2,2,1,1), 64 experts, w1/w3 (2048 ->
    1024) and w2 (1024 -> 2048), against its plain version."""
    g = torch.Generator().manual_seed(K)
    logits = torch.randn(8, 64, generator=g).to(cuda)
    k_tok = torch.tensor((8, 8, 4, 4, 2, 2, 1, 1), dtype=torch.int32,
                         device=cuda)
    w_, m_, _ = tref.adaptive_topk_router_ref(logits, k_tok, 8)
    plan = trd.ragged_plan(m_, w_, budget=30, max_k=8)
    xs, w, a, b = _lora_operands(cuda, (), plan.src.shape[0], K, H, 20,
                                 dtype)
    E = 64
    w = w.expand(E, K, H).contiguous()
    a = a.expand(E, K, 20).contiguous() * torch.linspace(
        0.5, 1.5, E, device=cuda, dtype=dtype)[:, None, None]
    b = b.expand(E, 20, H).contiguous()
    got = trd.ragged_expert_matmul(xs, plan.block_expert, w, a, b, scale=1.25)
    _check_lora(got, tref.ragged_expert_matmul_ref(xs, plan.block_expert, w,
                                                   a, b, scale=1.25))


def test_cuda_ragged_lm_loss_grads_match_dense(cuda):
    """The gradient of every trainable leaf of a two-layer smoke model's
    LM loss on the card: dispatch="ragged" (the trio's Functions) against
    dispatch="dense", float32, adapter b != 0, relative L2 <= 1e-4."""
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator(device=cuda)
                                .manual_seed(3), cuda)
    lora = tlora.init_lora(torch.Generator(device=cuda).manual_seed(4), cfg,
                           params)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for _, leaf in _b_leaves(lora):
        leaf.normal_(0.0, 0.3, generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                        device=cuda)
    grads = {}
    for mode in ("ragged", "dense"):
        tr = {"lora": _tree_clone(lora),
              "rescaler": tlora.init_rescalers(cfg, 1, device=cuda)}
        leaves = _tree_leaves(tr)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tmodel.lm_loss(cfg, params, tok, tok.roll(-1, 1),
                                 trainable=tr, k=2, dispatch=mode)
        grads[mode] = torch.autograd.grad(loss, leaves)
    for r, d in zip(grads["ragged"], grads["dense"]):
        assert ((r - d).norm() / d.norm()).item() <= 1e-4


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_leaves(tree[k])]
    return [tree]


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _b_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _b_leaves(v, path + (k,))
    elif path[-1] == "b":
        yield path, tree


def test_cuda_lora_engine_matches_merged(cuda):
    """The smoke model served with an adapter unmerged (expert adapters in
    the ragged LoRA route, q/k/v/o through lora_matmul) against the
    engine on the merged weights, float32: the same tokens, and both
    kernels launched."""
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator(device=cuda)
                                .manual_seed(6), cuda)
    lora = tlora.init_lora(torch.Generator(device=cuda).manual_seed(7), cfg,
                           params)
    gen = torch.Generator(device=cuda).manual_seed(8)
    for _, leaf in _b_leaves(lora):
        leaf.normal_(0.0, 0.3, generator=gen)

    def reqs():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (12,))
                        .astype(np.int32), max_new_tokens=6, k=(2, 1)[i % 2])
                for i in range(6)]
    kw = dict(num_slots=4, slot_len=24, slot_k=(2, 2, 1, 1), block_size=4)
    merged = tlora.merge_into_params(params, lora, cfg.lora.scale)
    want = ServingEngine(cfg, merged, **kw).run(reqs()).tokens_by_rid()
    before = dict(_build.LAUNCHES)
    got = ServingEngine(cfg, params, lora=lora, **kw).run(
        reqs()).tokens_by_rid()
    for name in ("lora_matmul", "ragged_expert_matmul"):
        assert _build.LAUNCHES[name] > before[name]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_cuda_local_update_matches_cpu(cuda):
    """A two-step local round of the smoke model (float32) on the card and
    on the CPU from the same weights, adapters and batches; the card's
    run launches the four training kernels and no ragged one."""
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = tlora.init_lora(torch.Generator().manual_seed(1), cfg, params)
    gen = torch.Generator().manual_seed(2)
    lora = {"blocks": {"pos0": _map_b(lora["blocks"]["pos0"], gen)}}
    resc = tlora.init_rescalers(cfg, 1, device="cpu")
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (2, 4, 32)).astype(np.int32)
    lab = np.roll(tok, -1, axis=-1)
    msk = np.ones((2, 4, 32), np.float32)
    valid = np.ones(2, np.float32)
    tc = TrainConfig(learning_rate=1e-3)
    kw = dict(k=1, tc=tc, rescaler_trainable=True)
    cpu = tclient.local_update(cfg, params, tlora.make_trainable(lora, resc),
                               tok, lab, msk, valid, **kw)
    _build.reset_launches()
    gpu = tclient.local_update(cfg, _to(params, cuda),
                               _to(tlora.make_trainable(lora, resc), cuda),
                               tok, lab, msk, valid, **kw)
    for name in ("lora_matmul", "lora_matmul_experts", "topk_router",
                 "flash_attention"):
        assert _build.LAUNCHES[name] > 0, name
    for name in ("ragged_gather", "ragged_expert_matmul", "ragged_combine"):
        assert _build.LAUNCHES[name] == 0, name
    torch.testing.assert_close(gpu[3].cpu(), cpu[3], rtol=1e-4, atol=1e-4)
    assert torch.equal(gpu[1]["pos0"].cpu(), cpu[1]["pos0"])
    diff = torch.cat([(gl.cpu() - cl).abs().flatten()
                      for gl, cl in zip(_leaves(gpu[0]), _leaves(cpu[0]))])
    assert (diff <= 1e-5).float().mean() >= 0.999
    assert diff.max() <= 2 * tc.learning_rate * 2


def _map_b(tree, gen):
    if isinstance(tree, dict) and set(tree) == {"a", "b"}:
        b = tree["b"]
        return {"a": tree["a"],
                "b": (torch.randn(b.shape, generator=gen, device=gen.device)
                      * 0.05).to(b.dtype)}
    return {k: _map_b(v, gen) for k, v in tree.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


def _round_experiment(device, dtype, **fed_kw):
    """The smoke model with 16 experts at top-8 (so the four budget tiers
    have k = 8, 4, 2, 1): 8 clients, a small corpus."""
    from repro_torch.configs import FederatedConfig, MoEConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.federated.simulation import build_experiment
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(
        dtype=dtype, moe=MoEConfig(num_experts=16, top_k=8, d_expert=64))
    return build_experiment(
        cfg, fed=FederatedConfig(num_clients=8, **fed_kw),
        tc=TrainConfig(batch_size=8),
        data=DataConfig(vocab_size=512, n_examples=160, seq_len=32),
        device=device)


def test_cuda_batched_round_matches_looped(cuda):
    """The default (batched) round against the looped one on the card,
    float32, from the same seeded start: the same kernels in the same
    order, so participants, activation frequencies and launches are equal;
    losses within 1e-6 relative, rescalers and the aggregate within 1e-6
    (the aggregation's summation order differs)."""
    runs = []
    for engine in ("batched", "looped"):
        exp = _round_experiment(cuda, "float32", rounds=1,
                                round_engine=engine)
        _build.reset_launches()
        res = exp.server.run_round(0)
        runs.append((exp.server, res, dict(_build.LAUNCHES)))
    (bs, br, bl), (ls, lr, ll) = runs
    assert br.participating == lr.participating == list(range(8))
    for a, b in zip(br.client_freqs, lr.client_freqs):
        np.testing.assert_array_equal(a["pos0"], b["pos0"])
    assert bl == ll
    for name in ("lora_matmul", "lora_matmul_experts", "topk_router",
                 "flash_attention"):
        assert bl[name] > 0, name
    np.testing.assert_allclose(br.client_losses, lr.client_losses, rtol=1e-6)
    for a, b in zip(_leaves(bs.global_lora), _leaves(ls.global_lora)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for a, b in zip(bs.clients, ls.clients):
        torch.testing.assert_close(a.rescaler["pos0"], b.rescaler["pos0"],
                                   rtol=1e-6, atol=1e-6)


def test_cuda_checkpoint_roundtrip(cuda, tmp_path):
    """A bf16 server state on the card through ``save_checkpoint`` and a
    fresh server's ``restore_checkpoint``: every leaf back on the card,
    bit for bit, at the saved round index."""
    exp = _round_experiment(cuda, "bfloat16", rounds=2)
    srv = exp.server
    gen = torch.Generator(device=cuda).manual_seed(0)
    srv.global_lora = {"blocks": {"pos0": _map_b(srv.global_lora["blocks"]
                                                 ["pos0"], gen)}}
    srv.run_round(0)
    path = str(tmp_path / "state.npz")
    srv.save_checkpoint(path)
    fresh = _round_experiment(cuda, "bfloat16", rounds=2).server
    assert fresh.restore_checkpoint(path) == 1
    for a, b in zip(_leaves(fresh.global_lora), _leaves(srv.global_lora)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
    for a, b in zip(fresh.clients, srv.clients):
        assert torch.equal(a.rescaler["pos0"], b.rescaler["pos0"])


_ARCHS = ["olmo-1.3b", "qwen3-1.7b", "phi4-mini-3.8b", "granite-20b",
          "chameleon-34b", "qwen2-moe-a2.7b"]


@pytest.mark.parametrize("arch", _ARCHS)
def test_cuda_arch_engines_match_cpu_engine(cuda, arch):
    """Each registry arch's SMOKE config at float32: the engine on the card
    emits the CPU engine's greedy tokens; a dense arch launches flash and
    nothing else, the MoE arch the five serving kernels."""
    cfg = get_config(arch, "smoke").replace(dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(num_slots=4, slot_len=20, block_size=4)
    tiers = (None,)
    if cfg.moe.enabled:
        kw["slot_k"] = tiers = (2, 2, 1, 1)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 11)),))
             .astype(np.int32), tiers[i % len(tiers)]) for i in range(6)]

    def run(p):
        return ServingEngine(cfg, p, **kw).run(
            [Request(rid=i, prompt=pr, max_new_tokens=4, k=k)
             for i, (pr, k) in enumerate(reqs)]).tokens_by_rid()

    cpu = run(params)
    _build.reset_launches()
    gpu = run(_to(params, cuda))
    for name, n in _build.LAUNCHES.items():
        used = name == "flash_attention" or (
            cfg.moe.enabled and not name.startswith("lora"))
        assert (n > 0) if used else (n == 0), (name, _build.LAUNCHES)
    for rid in cpu:
        np.testing.assert_array_equal(gpu[rid], cpu[rid], err_msg=f"rid {rid}")


@pytest.mark.parametrize("arch", ["olmo-1.3b", "qwen2-moe-a2.7b",
                                  "musicgen-large"])
def test_cuda_train_step_matches_cpu(cuda, arch):
    """``launch/steps.py``'s train step at float32 (SMOKE widths, 4 layers,
    two microbatches, √L checkpointing) on the card against the CPU:
    loss within 1e-4 relative, counts exactly, Adam's moment within 1e-5;
    with and without checkpointing the card's loss is the same.  The
    audio arch trains on (B, S, K) codebook tokens."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.optim import adam
    from repro_torch.tree import leaves
    cfg = get_config(arch, "smoke").replace(dtype="float32", num_layers=4)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = tlora.init_lora(torch.Generator().manual_seed(1), cfg, params)
    g = torch.Generator().manual_seed(2)
    lora = {"blocks": {"pos0": _map_b(lora["blocks"]["pos0"], g)}}
    resc = tlora.init_rescalers(cfg, 1, device="cpu")
    shape = ShapeConfig("t", 32, 4, "train")
    tokens = torch.randint(0, cfg.vocab_size,
                           steps.token_shape(cfg, 4, 32), generator=g,
                           dtype=torch.int32)
    batch = (tokens, tokens.roll(-1, 1), torch.ones(4, 32))
    out = {}
    for where, remat in (("cpu", True), ("cuda", True), ("cuda", False)):
        dev = torch.device(where)
        tr = tlora.make_trainable(_to(lora, dev), None if resc is None
                                  else _to(resc, dev))
        b = steps.build_train(cfg, shape, n_micro=2, remat=remat,
                              remat_chunk=2 if remat else 0, device=dev)
        out[where, remat] = b.fn(_to(params, dev), tr, adam.init(tr),
                                 *(t.to(dev) for t in batch))
    (_, o_c, m_c), (_, o_g, m_g) = out["cpu", True], out["cuda", True]
    torch.testing.assert_close(m_g["loss"].cpu(), m_c["loss"], rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(out["cuda", False][2]["loss"], m_g["loss"],
                               rtol=1e-6, atol=0)
    for key in m_c["counts"]:
        assert torch.equal(m_g["counts"][key].cpu(), m_c["counts"][key])
    assert o_g.step == o_c.step == 1
    for a, b in zip(leaves(o_g.mu), leaves(o_c.mu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


# the swa path's bands: windows that are not a tile multiple (64-query
# blocks, 64-key tiles), at sequences that are not one either
@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("S,window", [(2048, 1000), (2000, 1000), (300, 100),
                                      (200, 65), (129, 1)])
def test_cuda_flash_window_not_a_tile_multiple(cuda, dtype, S, window):
    """The model-layout entry (``backend.flash_attention``, as prefill
    calls it with the config's window) against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(S + window)
    q = torch.randn(2, S, 8, 128, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, S, 2, 128, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = _build.LAUNCHES["flash_attention"]
    got = backend.flash_attention(q, k, v, causal=True, window=window)
    assert _build.LAUNCHES["flash_attention"] == before + 1
    want = tref.flash_attention_ref(
        *(t.transpose(1, 2) for t in (q, k, v)), window=window).transpose(1, 2)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        _close_16bit(got, want)


@pytest.mark.parametrize("layout", ["paged", "slotted"])
def test_cuda_ring_engine_matches_cpu_engine(cuda, layout):
    """A sliding-window model (window 6, float32) on a wrapping ring:
    15-token prompts, 8 new tokens; the engine on the card emits the CPU
    engine's greedy tokens and launches flash with the window."""
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(
        dtype="float32", attention_window=6)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(num_slots=4, slot_len=23, slot_k=(2, 2, 1, 1),
              kv_layout=layout)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (6, 15)).astype(np.int32)

    def run(p):
        eng = ServingEngine(cfg, p, **kw)
        assert eng.pool.attn_len == 6
        return eng.run([Request(rid=i, prompt=pr, max_new_tokens=8,
                                k=(2, 1)[i % 2])
                        for i, pr in enumerate(prompts)]).tokens_by_rid()

    cpu = run(params)
    _build.reset_launches()
    gpu = run(_to(params, cuda))
    assert _build.LAUNCHES["flash_attention"] > 0
    for rid in cpu:
        assert len(cpu[rid]) == 8
        np.testing.assert_array_equal(gpu[rid], cpu[rid], err_msg=f"rid {rid}")


def test_cuda_device_driver_matches_host_driver(cuda, tmp_path):
    """The device round driver on the card (the smoke model's 2 layers,
    float32, 3 rounds at participation 0.75, checkpoint_every=2) against
    the host driver from the same start: participants equal, launches
    equal, losses, frequencies, the global adapter and the rescalers
    within rtol 2e-5 / atol 1e-6."""
    servers = {}
    for driver in ("device", "host"):
        exp = _round_experiment(cuda, "float32", rounds=3, participation=0.75,
                                round_driver=driver, checkpoint_every=2)
        _build.reset_launches()
        exp.server.run(checkpoint_to=str(tmp_path / f"{driver}.npz"))
        servers[driver] = (exp.server, dict(_build.LAUNCHES))
    (ds, dl), (hs, hl) = servers["device"], servers["host"]
    assert dl == hl and dl["lora_matmul_experts"] > 0
    for rd, rh in zip(ds.history, hs.history):
        assert rd.participating == rh.participating
        np.testing.assert_allclose(rd.client_losses, rh.client_losses,
                                   rtol=2e-5, atol=1e-6)
        for fd, fh in zip(rd.client_freqs, rh.client_freqs):
            np.testing.assert_allclose(fd["pos0"], fh["pos0"], rtol=2e-5,
                                       atol=1e-6)
    for a, b in zip(_leaves(ds.global_lora), _leaves(hs.global_lora)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)
    for a, b in zip(ds.clients, hs.clients):
        torch.testing.assert_close(a.rescaler["pos0"], b.rescaler["pos0"],
                                   rtol=2e-5, atol=1e-6)


_SSM_ARCHS = ["mamba2-780m", "jamba-v0.1-52b"]


@pytest.mark.parametrize("layout", ["paged", "slotted"])
@pytest.mark.parametrize("arch", _SSM_ARCHS)
def test_cuda_ssm_engines_match_cpu_engine(cuda, arch, layout):
    """The SSM and hybrid SMOKE configs at float32 with a rank-4 adapter
    served unmerged: the engine on the card emits the CPU engine's greedy
    tokens on both layouts (the attention-free arch on the slotted pool
    under either); mamba2 launches ``lora_matmul`` only (its in and out
    projections), jamba also flash and the MoE serving kernels."""
    cfg = get_config(arch, "smoke").replace(dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = tlora.init_lora(torch.Generator().manual_seed(1), cfg, params)
    g = torch.Generator().manual_seed(2)
    lora = {"blocks": {k: _map_b(v, g) for k, v in lora["blocks"].items()}}
    kw = dict(num_slots=4, slot_len=40, block_size=4, kv_layout=layout)
    tiers = (None,)
    if cfg.moe.enabled:
        kw["slot_k"] = tiers = (2, 2, 1, 1)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, (int(rng.integers(1, 30)),))
             .astype(np.int32), tiers[i % len(tiers)]) for i in range(6)]

    def run(p, lr):
        eng = ServingEngine(cfg, p, lora=lr, **kw)
        assert eng.paged == (layout == "paged" and arch != "mamba2-780m")
        return eng.run([Request(rid=i, prompt=pr, max_new_tokens=6, k=k)
                        for i, (pr, k) in enumerate(reqs)]).tokens_by_rid()

    cpu = run(params, lora)
    _build.reset_launches()
    gpu = run(_to(params, cuda), _to(lora, cuda))
    for name, n in _build.LAUNCHES.items():
        used = name == "lora_matmul" or (
            cfg.moe.enabled and name != "lora_matmul_experts")
        assert (n > 0) if used else (n == 0), (name, _build.LAUNCHES)
    for rid in cpu:
        np.testing.assert_array_equal(gpu[rid], cpu[rid], err_msg=f"rid {rid}")


def test_cuda_apply_mamba_matches_cpu(cuda):
    """The Mamba-2 block on the card against the CPU on the same weights
    (mamba2-smoke widths): a 129-token prefill (chunk 43), a 20-token
    continuation and 4 decode steps from its state, with the LoRA
    projections, float32: outputs and states within 1e-4 (summation
    order only)."""
    from repro_torch.models import mamba2
    dtype = torch.float32
    cfg = get_config("mamba2-780m", "smoke").replace(dtype="float32")
    p = {k: v[0] for k, v in mamba2.init_mamba(
        cfg, 1, torch.Generator().manual_seed(0), "cpu").items()}
    d = mamba2.mamba_dims(cfg)
    g = torch.Generator().manual_seed(1)
    lora = {n: {"a": (torch.randn(k, 4, generator=g) * k ** -0.5).to(dtype),
                "b": (torch.randn(4, m, generator=g) * 0.05).to(dtype)}
            for n, k, m in (("in_proj", cfg.d_model, d["in_dim"]),
                            ("out_proj", d["d_inner"], cfg.d_model))}
    x = torch.randn(2, 153, cfg.d_model, generator=g).to(dtype)

    def run(dev):
        pp, lr = _to(p, dev), _to(lora, dev)
        kw = dict(lora=lr, lora_scale=cfg.lora.scale)
        xs = x.to(dev)
        outs, states = [], []
        o, c = mamba2.apply_mamba(pp, cfg, xs[:, :129], return_cache=True,
                                  **kw)
        outs.append(o)
        o, c = mamba2.apply_mamba(pp, cfg, xs[:, 129:149], cache=c,
                                  return_cache=True, **kw)
        outs.append(o)
        states.append(c)
        c = {"conv": c["conv"].float(), "ssm": c["ssm"]}
        for t in range(149, 153):
            o, c = mamba2.apply_mamba(pp, cfg, xs[:, t:t + 1], cache=c, **kw)
            outs.append(o)
        states.append(c)
        return torch.cat(outs, 1).cpu(), [_to(s, "cpu") for s in states]

    cpu, cpu_st = run("cpu")
    _build.reset_launches()
    gpu, gpu_st = run(cuda)
    assert _build.LAUNCHES["lora_matmul"] == 2 * 6
    torch.testing.assert_close(gpu, cpu, rtol=1e-4, atol=1e-4)
    for a, b in zip(gpu_st, cpu_st):
        for leaf in ("conv", "ssm"):
            torch.testing.assert_close(a[leaf], b[leaf], rtol=1e-4, atol=1e-4)
