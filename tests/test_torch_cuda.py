"""The port's CUDA kernels and engine on the card, against the plain versions.

Every test here needs a CUDA device and skips without one (the fixture
decides, at run time).  The file imports no JAX, so it also runs where
JAX is not installed, without the suite's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: routing masks and counts exactly, router weights 1e-6
(float32); bf16 outputs 1e-2 relative + 1e-2 absolute (one bf16 rounding
on each side, different fp32 summation order).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import ragged_dispatch as trd
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention as t_flash
from repro_torch.kernels.topk_router import topk_router as t_router
from repro_torch.models import model as tmodel
from repro_torch.serving import Request, ServingEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close_bf16(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_router_matches_plain(cuda, dtype):
    logits = torch.randn(300, 64, device=cuda).to(dtype)
    before = _build.LAUNCHES["topk_router"]
    w, m, c = t_router(logits, 8)
    assert _build.LAUNCHES["topk_router"] == before + 1
    pw, pm, pc = tref.topk_router_ref(logits, 8)
    assert torch.equal(m, pm) and torch.equal(c, pc)
    torch.testing.assert_close(w, pw, rtol=0, atol=1e-6)


@pytest.mark.parametrize("S,H,KV,D,window", [(256, 16, 16, 128, 0),
                                             (100, 8, 2, 64, 0),
                                             (77, 4, 4, 32, 16)])
def test_cuda_flash_matches_plain(cuda, S, H, KV, D, window):
    q = torch.randn(2, H, S, D, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(2, KV, S, D, device=cuda, dtype=torch.bfloat16)
    v = torch.randn(2, KV, S, D, device=cuda, dtype=torch.bfloat16)
    _close_bf16(t_flash(q, k, v, window=window),
                tref.flash_attention_ref(q, k, v, window=window))


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
    _close_bf16(trd.ragged_expert_matmul(xs, plan.block_expert, w, *extra,
                                         scale=0.5),
                tref.ragged_expert_matmul_ref(xs, plan.block_expert, w,
                                              *extra, scale=0.5))
    eo = torch.randn(xs.shape[0], H, **bf)
    _close_bf16(trd.ragged_combine(eo, plan.rows, plan.wrank),
                tref.ragged_combine_ref(eo, plan.rows, plan.wrank))


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
    launches all five kernels."""
    cfg = get_config("olmoe-1.3b-6.9b", "smoke").replace(dtype="float32")
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(num_slots=4, slot_len=20, slot_k=(2, 2, 1, 1), block_size=4)
    cpu = ServingEngine(cfg, params, **kw).run(_requests(cfg, 8, 4))
    on_card = _to(params, cuda)
    _build.reset_launches()
    gpu = ServingEngine(cfg, on_card, **kw).run(_requests(cfg, 8, 4))
    assert all(n > 0 for n in _build.LAUNCHES.values()), _build.LAUNCHES
    ct, gt = cpu.tokens_by_rid(), gpu.tokens_by_rid()
    for rid in ct:
        np.testing.assert_array_equal(gt[rid], ct[rid], err_msg=f"rid {rid}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
