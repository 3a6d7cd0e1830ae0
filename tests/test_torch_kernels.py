"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On the CPU the port's dispatch (``repro_torch.kernels.backend``) runs each
kernel's plain PyTorch version; these tests feed it and the JAX Pallas
kernel (in interpret mode, as tests/test_kernels.py runs them) the same
numpy-seeded inputs.  Tolerances: integer routing/plan arrays exactly;
float results 1e-5 (float32 on both sides, different summation order).

The CUDA kernels themselves are checked against the plain versions on the
card by tests/test_torch_cuda.py.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ragged_dispatch as jrd
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.topk_router import topk_router as j_router
from repro_torch.kernels import _build, backend
from repro_torch.kernels import ragged_dispatch as trd
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention as t_flash
from repro_torch.kernels.topk_router import topk_router as t_router

ROOT = pathlib.Path(__file__).resolve().parents[1]


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got: torch.Tensor, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _logits(T, E, seed):
    return np.random.default_rng(seed).normal(size=(T, E)).astype(np.float32)


# ---------------------------------------------------------------- router

@pytest.mark.parametrize("T,E,k", [(64, 16, 1), (64, 16, 4), (96, 8, 2)])
def test_router_matches_pallas(T, E, k):
    logits = _logits(T, E, k)
    jw, jm, jc = j_router(jnp.asarray(logits), k, block_t=32, interpret=True)
    w, m, c = backend.router(t(logits), k)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    close(w, jw, 1e-6)


def test_router_ties_take_the_lowest_index():
    logits = np.zeros((4, 8), np.float32)             # all experts tied
    jw, jm, _ = j_router(jnp.asarray(logits), 3, interpret=True)
    w, m, _ = backend.router(t(logits), 3)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert m[:, :3].eq(1).all() and m[:, 3:].eq(0).all()


@pytest.mark.parametrize("max_k", [1, 2, 4])
def test_adaptive_router_matches_reference(max_k):
    T, E = 48, 8
    logits = _logits(T, E, 10 + max_k)
    k_tok = np.random.default_rng(max_k).integers(0, max_k + 1, T)
    jw, jm, jc = jref.adaptive_topk_router_ref(
        jnp.asarray(logits), jnp.asarray(k_tok, jnp.int32), max_k)
    w, m, c = tref.adaptive_topk_router_ref(t(logits), t(k_tok), max_k)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    close(w, jw, 1e-6)


# ---------------------------------------------------------------- flash

@pytest.mark.parametrize("H,KV,window", [(4, 4, 0), (4, 2, 0), (4, 4, 8),
                                         (4, 1, 8)])
def test_flash_matches_pallas(H, KV, window):
    rng = np.random.default_rng(H * 10 + KV + window)
    B, S, D = 2, 32, 16
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    v = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   window=window, block_q=16, block_k=16, interpret=True)
    # the port's dispatch takes the model layout (B, S, H, D)
    got = backend.flash_attention(*(t(a).transpose(1, 2) for a in (q, k, v)),
                                  window=window)
    close(got.transpose(1, 2).contiguous(), want)


def test_flash_plain_version_handles_ragged_length():
    """No block-divisibility rule in the port: a prime S runs as is and
    equals the JAX oracle."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(1, 2, 37, 16)).astype(np.float32)
               for _ in range(3))
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))
    close(tref.flash_attention_ref(t(q), t(k), t(v)), want)


# ---------------------------------------------------------------- ragged

def _router_outputs(T, E, k, seed, per_token=False):
    logits = _logits(T, E, seed)
    if per_token:
        k_tok = np.random.default_rng(seed).integers(0, k + 1, T)
        w, m, _ = jref.adaptive_topk_router_ref(
            jnp.asarray(logits), jnp.asarray(k_tok, jnp.int32), k)
        budget = int(k_tok.sum())
    else:
        w, m, _ = jref.topk_router_ref(jnp.asarray(logits), k)
        budget = T * k
    return np.asarray(w), np.asarray(m), budget


@pytest.mark.parametrize("T,E,k,per_token", [(32, 8, 2, False),
                                             (40, 4, 3, False),
                                             (24, 8, 4, True)])
def test_ragged_plan_matches_reference_exactly(T, E, k, per_token):
    w, m, budget = _router_outputs(T, E, k, T + E, per_token)
    jp = jrd.ragged_plan(jnp.asarray(m), jnp.asarray(w), budget=budget,
                         max_k=k)
    tp = trd.ragged_plan(t(m), t(w), budget=budget, max_k=k)
    for name in ("src", "valid", "block_expert", "rows"):
        got, want = getattr(tp, name), np.asarray(getattr(jp, name))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_array_equal(tp.wrank.numpy(), np.asarray(jp.wrank))


def _plan_inputs(seed):
    T, E, k, D, H, r = 24, 4, 2, 16, 32, 4
    rng = np.random.default_rng(seed)
    w, m, budget = _router_outputs(T, E, k, seed)
    plan = jrd.ragged_plan(jnp.asarray(m), jnp.asarray(w), budget=budget,
                           max_k=k)
    N = plan.src.shape[0]
    arrays = dict(
        x=rng.normal(size=(T, D)).astype(np.float32),
        xs=rng.normal(size=(N, D)).astype(np.float32),
        w=rng.normal(size=(E, D, H)).astype(np.float32),
        a=rng.normal(size=(E, D, r)).astype(np.float32),
        b=rng.normal(size=(E, r, H)).astype(np.float32),
        eo=rng.normal(size=(N, H)).astype(np.float32))
    return plan, arrays


# The Pallas ragged_gather / ragged_combine kernels call ``pl.load``, which
# the installed JAX no longer provides, so the interpreter cannot run them
# here; those two are held against the JAX package's plain reference (the
# path its reference backend takes).

def test_ragged_gather_matches_reference():
    plan, a = _plan_inputs(1)
    want = jref.ragged_gather_ref(jnp.asarray(a["x"]), plan.src, plan.valid)
    got = backend.ragged_gather(t(a["x"]), t(plan.src), t(plan.valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lora", [False, True])
def test_ragged_expert_matmul_matches_pallas(lora):
    plan, a = _plan_inputs(2)
    extra = (a["a"], a["b"]) if lora else ()
    want = jrd.ragged_expert_matmul(
        jnp.asarray(a["xs"]), plan.block_expert, jnp.asarray(a["w"]),
        *(jnp.asarray(e) for e in extra), scale=0.8, interpret=True)
    got = backend.ragged_expert_matmul(
        t(a["xs"]), t(plan.block_expert), t(a["w"]), *(t(e) for e in extra),
        scale=0.8)
    close(got, want)


def test_ragged_combine_matches_reference():
    plan, a = _plan_inputs(3)
    want = jref.ragged_combine_ref(jnp.asarray(a["eo"]), plan.rows,
                                   plan.wrank)
    got = backend.ragged_combine(t(a["eo"]), t(plan.rows), t(plan.wrank))
    close(got, want)


def test_ragged_rows_matches_reference():
    for budget, E in [(30, 64), (2048, 64), (1, 4), (17, 8)]:
        assert trd.ragged_rows(budget, E) == jrd.ragged_rows(budget, E)


# ---------------------------------------------------------------- dispatch

def test_cpu_dispatch_launches_no_kernel():
    before = dict(_build.LAUNCHES)
    backend.router(torch.randn(8, 4), 2)
    backend.ragged_gather(torch.randn(4, 8), torch.zeros(8, dtype=torch.int32),
                          torch.ones(8, dtype=torch.int32))
    assert _build.LAUNCHES == before


def _cpu_args():
    f = torch.randn(8, 16)
    i = torch.zeros(8, dtype=torch.int32)
    q = torch.randn(1, 2, 8, 32)
    return {
        "topk_router": lambda: t_router(f, 2),
        "flash_attention": lambda: t_flash(q, q, q),
        "ragged_gather": lambda: trd.ragged_gather(f, i, i),
        "ragged_expert_matmul": lambda: trd.ragged_expert_matmul(
            f, i[:1], torch.randn(2, 16, 4)),
        "ragged_combine": lambda: trd.ragged_combine(
            f, i.reshape(4, 2), torch.ones(4, 2)),
    }


@pytest.mark.parametrize("name", _build.KERNELS)
def test_cuda_wrapper_refuses_cpu_tensors(name):
    """A wrapper launches its kernel or raises: it never quietly runs
    something else for a tensor that is not on the card."""
    with pytest.raises(ValueError, match="CUDA"):
        _cpu_args()[name]()


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (path, mod)
