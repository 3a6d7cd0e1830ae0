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

import jax
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
from repro_torch.kernels.lora_matmul import lora_matmul as t_lora
from repro_torch.kernels.lora_matmul import \
    lora_matmul_experts as t_lora_experts
from repro_torch.kernels.topk_router import \
    adaptive_topk_router as t_adaptive_router
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


def _budgets(T, max_k, seed):
    """Per-token budgets with zeros and values above max_k (the kernel
    clamps to [0, max_k], as the reference's ``rank < k_tok`` does)."""
    k_tok = np.random.default_rng(seed).integers(0, max_k + 3, T)
    k_tok[:3] = (0, max_k, max_k + 2)
    return k_tok.astype(np.int32)


@pytest.mark.parametrize("E,max_k", [(8, 3), (60, 8), (64, 8), (64, 1)])
def test_adaptive_router_wrapper_matches_reference(E, max_k):
    T = 40
    logits = _logits(T, E, E + max_k)
    k_tok = _budgets(T, max_k, E)
    jw, jm, jc = jref.adaptive_topk_router_ref(
        jnp.asarray(logits), jnp.asarray(k_tok), max_k)
    w, m, c = backend.adaptive_router(t(logits), t(k_tok), max_k)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    close(w, jw, 1e-6)
    assert m[0].sum() == 0 and m[2].sum() == max_k       # 0 and above max_k


@pytest.mark.parametrize("T,E,k", [(64, 16, 4), (96, 8, 2), (32, 64, 8)])
def test_adaptive_router_uniform_budget_is_the_static_router(T, E, k):
    """Uniform k_tok == k gives the Pallas router's mask and counts
    (interpret mode) bit for bit and its weights within 1e-6 (XLA's and
    torch's exp differ in the last bit), and the static wrapper's output
    bit for bit."""
    logits = _logits(T, E, T + k)
    jw, jm, jc = j_router(jnp.asarray(logits), k, block_t=32, interpret=True)
    w, m, c = backend.adaptive_router(
        t(logits), torch.full((T,), k, dtype=torch.int32), k)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    close(w, jw, 1e-6)
    for got, want in zip((w, m, c), backend.router(t(logits), k)):
        assert torch.equal(got, want)


def _nonfinite_logits():
    """Rows with a NaN logit, a +inf logit, all -inf, a -inf among finite
    values, probabilities that underflow to 0 (so chosen experts tie at 0
    with the rest), and a finite row."""
    logits = _logits(6, 8, 3)
    logits[0, 5] = np.nan
    logits[1, 2] = np.inf
    logits[2, :] = -np.inf
    logits[3, 1] = -np.inf
    logits[4] = np.arange(8) * -200.0
    return logits


@pytest.mark.parametrize("router", ["static", "adaptive"])
def test_routers_nonfinite_rows_match_reference(router):
    """All-NaN softmax rows select expert 0 in every round, weights NaN,
    as the JAX reference's argmax does."""
    logits, k = _nonfinite_logits(), 3
    if router == "static":
        jout = jref.topk_router_ref(jnp.asarray(logits), k)
        out = backend.router(t(logits), k)
    else:
        k_tok = np.array([3, 2, 3, 1, 3, 0], np.int32)
        jout = jref.adaptive_topk_router_ref(jnp.asarray(logits),
                                             jnp.asarray(k_tok), k)
        out = backend.adaptive_router(t(logits), t(k_tok), k)
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, equal_nan=True)
    m = out[1]
    assert m[0, 0] == 3 and m[0, 1:].eq(0).all()
    assert m[4, 0] >= 2                  # underflow: expert 0 chosen again
    assert out[0][:3].isnan().all() and not out[0][3:].isnan().any()


def test_adaptive_router_grad_matches_jax_vjp():
    T, E, max_k = 24, 16, 4
    logits = _logits(T, E, 21)
    k_tok = _budgets(T, max_k, 22)
    cot = np.random.default_rng(23).normal(size=(T, E)).astype(np.float32)
    _, vjp = jax.vjp(lambda l: jref.adaptive_topk_router_ref(
        l, jnp.asarray(k_tok), max_k)[0], jnp.asarray(logits))
    (want,) = vjp(jnp.asarray(cot))
    lt = t(logits).requires_grad_(True)
    w, m, c = backend.adaptive_router(lt, t(k_tok), max_k)
    assert not m.requires_grad and not c.requires_grad
    (got,) = torch.autograd.grad(w, lt, t(cot))
    close(got, want, 1e-6)


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


def _skewed_plan_inputs(kind):
    """Plans whose runs the grouped matmul's tiles must follow:
    ``skewed`` — every token picks the same two of four experts, so each
    of their runs is 80 rows (longer than the tensor-core kernel's 64-row
    tile) and two experts are empty; ``empty_experts`` — tokens pick only
    experts 1, 5 and 6 of 8, so the last expert is empty and the trailing
    padding run stands alone."""
    D, H, r = 16, 32, 4
    rng = np.random.default_rng(17)
    if kind == "skewed":
        T, E, k = 80, 4, 2
        logits = np.tile(rng.normal(size=(1, E)), (T, 1)).astype(np.float32)
    else:
        T, E, k = 24, 8, 1
        logits = rng.normal(size=(T, E)).astype(np.float32)
        logits[:, [1, 5, 6]] += 8.0
    w, m, _ = jref.topk_router_ref(jnp.asarray(logits), k)
    plan = jrd.ragged_plan(m, w, budget=T * k, max_k=k)
    N = plan.src.shape[0]
    arrays = dict(
        xs=rng.normal(size=(N, D)).astype(np.float32),
        w=rng.normal(size=(E, D, H)).astype(np.float32),
        a=rng.normal(size=(E, D, r)).astype(np.float32),
        b=rng.normal(size=(E, r, H)).astype(np.float32))
    return plan, arrays


@pytest.mark.parametrize("lora,kind", [
    pytest.param(False, "random", id="False"),
    pytest.param(True, "random", id="True"),
    pytest.param(False, "skewed", id="skewed-False"),
    pytest.param(True, "skewed", id="skewed-True"),
    pytest.param(False, "empty_experts", id="empty_experts-False"),
    pytest.param(True, "empty_experts", id="empty_experts-True")])
def test_ragged_expert_matmul_matches_pallas(lora, kind):
    if kind == "random":
        plan, a = _plan_inputs(2)
    else:
        plan, a = _skewed_plan_inputs(kind)
        be = np.asarray(plan.block_expert)
        if kind == "skewed":     # two runs of 10 blocks, two empty experts
            assert np.bincount(be[:20], minlength=4).tolist().count(10) == 2
        else:                    # expert 7 takes only the trailing padding
            assert set(be.tolist()) == {1, 5, 6, 7}
            assert (be[-7:] == 7).all() and 7 not in be[:-7]
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


@pytest.mark.parametrize("op", ["gather", "combine"])
def test_ragged_gather_combine_nonfinite_match_reference(op):
    """inf and NaN in row 0, which padding rows and zero-weight ranks read
    and multiply by 0: NaN exactly where the JAX reference has NaN."""
    plan, a = _plan_inputs(4)
    key = "x" if op == "gather" else "eo"
    a[key][0, ::2], a[key][0, 1::2] = np.inf, np.nan
    if op == "gather":
        assert (np.asarray(plan.valid) == 0).any()
        want = jref.ragged_gather_ref(jnp.asarray(a["x"]), plan.src,
                                      plan.valid)
        got = backend.ragged_gather(t(a["x"]), t(plan.src), t(plan.valid))
    else:
        plan = plan._replace(wrank=plan.wrank.at[:, -1].set(0.0),
                             rows=plan.rows.at[:, -1].set(0))
        want = jref.ragged_combine_ref(jnp.asarray(a["eo"]), plan.rows,
                                       plan.wrank)
        got = backend.ragged_combine(t(a["eo"]), t(plan.rows),
                                     t(plan.wrank))
    assert np.isnan(np.asarray(want)).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5, equal_nan=True)


def test_ragged_rows_matches_reference():
    for budget, E in [(30, 64), (2048, 64), (1, 4), (17, 8)]:
        assert trd.ragged_rows(budget, E) == jrd.ragged_rows(budget, E)


# ---------------------------------------------------------------- dispatch

def test_cpu_dispatch_launches_no_kernel():
    before = dict(_build.LAUNCHES)
    backend.router(torch.randn(8, 4), 2)
    backend.adaptive_router(torch.randn(8, 4),
                            torch.full((8,), 2, dtype=torch.int32), 2)
    backend.ragged_gather(torch.randn(4, 8), torch.zeros(8, dtype=torch.int32),
                          torch.ones(8, dtype=torch.int32))
    backend.lora_matmul(torch.randn(4, 8), torch.randn(8, 3),
                        torch.randn(8, 2), torch.randn(2, 3), scale=0.5)
    backend.lora_matmul_experts(torch.randn(2, 4, 8), torch.randn(2, 8, 3),
                                torch.randn(2, 8, 2), torch.randn(2, 2, 3),
                                scale=0.5)
    assert _build.LAUNCHES == before


def _cpu_args():
    f = torch.randn(8, 16)
    i = torch.zeros(8, dtype=torch.int32)
    q = torch.randn(1, 2, 8, 32)
    return {
        "topk_router": lambda: t_router(f, 2),
        "adaptive_topk_router": lambda: t_adaptive_router(f, i, 2),
        "flash_attention": lambda: t_flash(q, q, q),
        "ragged_gather": lambda: trd.ragged_gather(f, i, i),
        "ragged_expert_matmul": lambda: trd.ragged_expert_matmul(
            f, i[:1], torch.randn(2, 16, 4)),
        "ragged_combine": lambda: trd.ragged_combine(
            f, i.reshape(4, 2), torch.ones(4, 2)),
        "lora_matmul": lambda: t_lora(f, torch.randn(16, 4),
                                      torch.randn(16, 2), torch.randn(2, 4),
                                      scale=1.0),
        "lora_matmul_experts": lambda: t_lora_experts(
            f[None], torch.randn(1, 16, 4), torch.randn(1, 16, 2),
            torch.randn(1, 2, 4), scale=1.0),
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
