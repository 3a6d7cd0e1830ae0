"""The port's Mamba-2 block (``repro_torch.models.mamba2``) against the
JAX package's (``repro.models.mamba2``), at float32 on the CPU.

One block of the ``mamba2-smoke`` config (d_model 256, 16 heads of 32,
d_state 32, chunk 64) at ``dtype="float32"``: weights from the port's
seeded ``init_mamba``, handed to both packages as numpy.  Tolerances:
paths without the SSD scan (the conv, the gated norm, the S = 1
recurrent step) within rtol/atol 1e-5; paths through the chunked scan
within 1e-4, because its per-chunk cumulative sums and the einsums'
contraction orders reorder fp32 additions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import KernelConfig
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro_torch.convert import config_from_jax, to_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba

JCFG = jreg.get_config("mamba2-780m", "smoke").replace(
    dtype="float32", kernels=KernelConfig(backend="reference"))
TCFG = config_from_jax(JCFG)
DIMS = tmamba.mamba_dims(TCFG)
SSD_TOL = 1e-4       # the chunked scan reorders fp32 additions
TOL = 1e-5           # everything else


def _block(seed=0):
    """One Mamba block's weights (numpy), from the port's initialiser."""
    stacked = tmamba.init_mamba(TCFG, 1, torch.Generator().manual_seed(seed),
                                "cpu")
    return {k: to_numpy(v)[0] for k, v in stacked.items()}


NP_P = _block()
TP = {k: torch.tensor(v) for k, v in NP_P.items()}
JP = {k: jnp.asarray(v) for k, v in NP_P.items()}


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(to_numpy(got) if torch.is_tensor(
        got) else got, np.float32), np.asarray(want, np.float32), rtol=tol,
        atol=tol)


def _x(B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, TCFG.d_model)).astype(np.float32)


def _tcache(c):
    return {k: torch.tensor(np.asarray(v)) for k, v in c.items()}


# ---------------------------------------------------------------- dims / init

def test_dims_init_and_cache_match_the_reference_layout():
    assert DIMS == jmamba.mamba_dims(JCFG)
    want = jax.eval_shape(lambda k: jmamba.init_mamba(k, JCFG),
                          jax.random.PRNGKey(0))
    assert {k: v.shape for k, v in NP_P.items()} == \
        {k: v.shape for k, v in want.items()}
    # bf16 model: projections, conv and norm in bf16; dt bias, A_log, D fp32
    bcfg = TCFG.replace(dtype="bfloat16")
    jb = jax.eval_shape(lambda k: jmamba.init_mamba(
        k, JCFG.replace(dtype="bfloat16")), jax.random.PRNGKey(0))
    tb = tmamba.init_mamba(bcfg, 1, torch.Generator().manual_seed(0), "cpu")
    for k, v in tb.items():
        assert str(v.dtype).split(".")[1] == jb[k].dtype.name, k
    # the reference's laws: dt = softplus(dt_bias) in [1e-3, 1e-1], -A in
    # [1, 16], D one, conv bias zero, norm one
    dt = torch.nn.functional.softplus(TP["dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 1e-1 * 1.001)).all())
    a = torch.exp(TP["A_log"])
    assert bool(((a >= 1.0) & (a <= 16.0)).all())
    assert bool((TP["D"] == 1).all()) and bool((TP["conv_b"] == 0).all())
    assert abs(float(TP["conv_w"].std()) - DIMS["conv_width"] ** -0.5) < 0.05
    tc = tmamba.init_mamba_cache(TCFG, 3, device="cpu")
    jc = jmamba.init_mamba_cache(JCFG, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == \
        {k: (v.shape, torch.float32) for k, v in jc.items()}


def test_gated_rms_norm_matches_jax():
    rng = np.random.default_rng(3)
    x, z = (rng.normal(size=(2, 5, 64)).astype(np.float32) for _ in range(2))
    s = rng.normal(size=(64,)).astype(np.float32)
    close(tlayers.gated_rms_norm(torch.tensor(s), torch.tensor(x),
                                 torch.tensor(z), 1e-6),
          jlayers.gated_rms_norm(jnp.asarray(s), jnp.asarray(x),
                                 jnp.asarray(z), 1e-6), TOL)


# ---------------------------------------------------------------- SSD scan

@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(with_state):
    rng = np.random.default_rng(int(with_state))
    B, S, H, P, N, L = 2, 96, 4, 8, 16, 32
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, (H,)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, H, N)).astype(np.float32)
              for _ in range(2))
    s0 = (rng.normal(size=(B, H, P, N)).astype(np.float32)
          if with_state else None)
    y, st = tmamba.ssd_chunked(*map(torch.tensor, (x, dt, A, Bm, Cm)), L,
                               None if s0 is None else torch.tensor(s0))
    jy, jst = jmamba.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), L,
                                 None if s0 is None else jnp.asarray(s0))
    close(y, jy, SSD_TOL)
    close(st, jst, SSD_TOL)
    # one chunk or many: the same function
    y1, st1 = tmamba.ssd_chunked(*map(torch.tensor, (x, dt, A, Bm, Cm)), S,
                                 None if s0 is None else torch.tensor(s0))
    close(y1, to_numpy(y), SSD_TOL)
    close(st1, to_numpy(st), SSD_TOL)


def test_ssd_gradient_is_finite_through_the_masked_segsum():
    """exp(-inf) above the diagonal: the masked entries pass a zero
    gradient, never NaN."""
    rng = np.random.default_rng(4)
    B, S, H, P, N = 1, 16, 2, 4, 8
    ins = [torch.tensor(rng.normal(size=s).astype(np.float32),
                        requires_grad=True)
           for s in ((B, S, H, P), (B, S, H), (H,), (B, S, H, N),
                     (B, S, H, N))]
    x, dt, A, Bm, Cm = ins
    y, st = tmamba.ssd_chunked(x, torch.nn.functional.softplus(dt),
                               -torch.exp(A), Bm, Cm, 8)
    (y.sum() + st.sum()).backward()
    for t in ins:
        assert torch.isfinite(t.grad).all()


# ---------------------------------------------------------------- conv

@pytest.mark.parametrize("S", [7, 2])     # with a state; S < W - 1
def test_causal_conv_with_state_matches_jax(S):
    rng = np.random.default_rng(S)
    C, W = 12, DIMS["conv_width"]
    x = rng.normal(size=(2, S, C)).astype(np.float32)
    w = rng.normal(size=(C, W)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    st = rng.normal(size=(2, C, W - 1)).astype(np.float32)
    for state in (None, st):
        out, ns = tmamba.causal_conv(
            torch.tensor(x), torch.tensor(w), torch.tensor(b),
            None if state is None else torch.tensor(state))
        jout, jns = jmamba.causal_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if state is None else jnp.asarray(state))
        close(out, jout, TOL)
        close(ns, jns, 0.0)
    if S < W - 1:       # the new state still holds the old state's tail
        np.testing.assert_array_equal(to_numpy(ns)[:, :, :W - 1 - S],
                                      st[:, :, S:])


# ---------------------------------------------------------------- the block

@pytest.mark.parametrize("S", [128, 129])   # 129: chunk 43, no divisor 64
def test_apply_mamba_prefill_matches_jax(S):
    x = _x(2, S, S)
    out, cache = tmamba.apply_mamba(TP, TCFG, torch.tensor(x),
                                    return_cache=True)
    jout, jcache = jmamba.apply_mamba(JP, JCFG, jnp.asarray(x),
                                      return_cache=True)
    close(out, jout, SSD_TOL)
    for leaf in ("conv", "ssm"):
        close(cache[leaf], jcache[leaf], SSD_TOL)
        assert cache[leaf].dtype == torch.float32


def test_continuation_and_decode_match_jax_and_the_full_prefill():
    """Prefill 100 tokens, continue with 20 (the chunked scan from a
    state), decode 8 one at a time: each piece against JAX, and the
    outputs together against one 128-token prefill."""
    x = _x(2, 128, 11)
    full, full_cache = tmamba.apply_mamba(TP, TCFG, torch.tensor(x),
                                          return_cache=True)
    out0, c = tmamba.apply_mamba(TP, TCFG, torch.tensor(x[:, :100]),
                                 return_cache=True)
    jout0, jc = jmamba.apply_mamba(JP, JCFG, jnp.asarray(x[:, :100]),
                                   return_cache=True)
    close(out0, jout0, SSD_TOL)
    out1, c = tmamba.apply_mamba(TP, TCFG, torch.tensor(x[:, 100:120]),
                                 cache=c, return_cache=True)
    jout1, jc = jmamba.apply_mamba(JP, JCFG, jnp.asarray(x[:, 100:120]),
                                   cache=jc, return_cache=True)
    close(out1, jout1, SSD_TOL)
    outs = [out0, out1]
    # the decode state as the pools hold it: conv in fp32
    c = {"conv": c["conv"].float(), "ssm": c["ssm"]}
    jstep = jax.jit(lambda p, xt, cc: jmamba.apply_mamba(p, JCFG, xt,
                                                         cache=cc))
    for t in range(120, 128):
        o, c = tmamba.apply_mamba(TP, TCFG, torch.tensor(x[:, t:t + 1]),
                                  cache=c)
        jo, jc = jstep(JP, jnp.asarray(x[:, t:t + 1]), jc)
        close(o, jo, SSD_TOL)
        assert c["conv"].dtype == torch.float32
        outs.append(o)
    close(torch.cat(outs, dim=1), to_numpy(full), SSD_TOL)
    for leaf in ("conv", "ssm"):
        close(c[leaf], to_numpy(full_cache[leaf]), SSD_TOL)


def test_recurrent_step_matches_jax_from_one_state():
    """The S = 1 update alone from a shared random state: no scan, 1e-5."""
    rng = np.random.default_rng(12)
    st = {"conv": rng.normal(size=(2, DIMS["conv_dim"],
                                   DIMS["conv_width"] - 1)).astype(np.float32),
          "ssm": rng.normal(size=(2, DIMS["n_heads"], DIMS["head_dim"],
                                  DIMS["d_state"])).astype(np.float32)}
    x = _x(2, 1, 13)
    o, c = tmamba.apply_mamba(TP, TCFG, torch.tensor(x), cache=_tcache(st))
    jo, jc = jmamba.apply_mamba(JP, JCFG, jnp.asarray(x),
                                cache={k: jnp.asarray(v)
                                       for k, v in st.items()})
    close(o, jo, TOL)
    for leaf in ("conv", "ssm"):
        close(c[leaf], jc[leaf], TOL)


def test_one_token_prompt_takes_the_chunked_path():
    x = _x(2, 1, 14)
    out, c = tmamba.apply_mamba(TP, TCFG, torch.tensor(x), return_cache=True)
    jout, jc = jmamba.apply_mamba(JP, JCFG, jnp.asarray(x), return_cache=True)
    close(out, jout, SSD_TOL)
    close(c["conv"], jc["conv"], TOL)
    close(c["ssm"], jc["ssm"], SSD_TOL)


def test_lora_gradients_through_in_and_out_proj_match_jax():
    rng = np.random.default_rng(15)
    r, scale = 4, TCFG.lora.scale
    lora = {name: {"a": rng.normal(0, d_in ** -0.5, (d_in, r)),
                   "b": rng.normal(0, 0.05, (r, d_out))}
            for name, d_in, d_out in (
                ("in_proj", TCFG.d_model, DIMS["in_dim"]),
                ("out_proj", DIMS["d_inner"], TCFG.d_model))}
    lora = {n: {k: v.astype(np.float32) for k, v in p.items()}
            for n, p in lora.items()}
    x = _x(2, 96, 16)
    g = rng.normal(size=(2, 96, TCFG.d_model)).astype(np.float32)

    tl = {n: {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
          for n, p in lora.items()}
    out, _ = tmamba.apply_mamba(TP, TCFG, torch.tensor(x), lora=tl,
                                lora_scale=scale)
    (out * torch.tensor(g)).sum().backward()

    def jloss(jl):
        o, _ = jmamba.apply_mamba(JP, JCFG, jnp.asarray(x), lora=jl,
                                  lora_scale=scale)
        return (o * jnp.asarray(g)).sum()

    jg = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, lora))
    for n in lora:
        for k in ("a", "b"):
            want = np.asarray(jg[n][k])
            got = to_numpy(tl[n][k].grad)
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= SSD_TOL, (n, k, rel)
