#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FLAME's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device, ``nvcc`` and
nothing else of the network or the filesystem.  Phases:

1. card and build — the card's name and power limit (``nvidia-smi``), then
   every ``src/repro_torch/kernels/csrc/*.cu`` compiled for ``sm_90a``
   (ptxas register/spill report on stderr);
2. kernels — each of the five CUDA kernels of the serving path held
   against its plain PyTorch version on the card, on seeded inputs at the
   path's shapes, with the tolerance stated beside each check; kernel,
   plain and (where one PyTorch call computes the same function) library
   times by CUDA events with the L2 flushed before every call, and
   each kernel's bound (bytes over 3.35 TB/s or FLOPs over the peak);
3. serving — OLMoE-1.3B/6.9B FULL (16 layers, bf16, random seeded weights)
   served by ``ServingEngine``: 8 slots at tiers (8,8,4,4,2,2,1,1), 16
   requests of 128/256-token prompts and 16 new tokens each; the launch
   counters are zeroed just before and read just after, and every kernel
   must have launched;
4. end to end — a 2-layer full-width model, prefill plus 4 paged decode
   steps for 4 requests, on the card (kernels) and on the CPU (plain
   versions) on the same weights: logits compared in float32 and bf16;
5. summary — a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero before the last
line.  Without a CUDA device it exits non-zero at once and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
F32_FLOPS = 67e12                # fp32 outside the tensor cores
REPS = 20


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ragged_dispatch import (ragged_combine,
                                                     ragged_expert_matmul,
                                                     ragged_gather,
                                                     ragged_plan, ragged_rows)
    from repro_torch.kernels.topk_router import topk_router
    from repro_torch.models import model as model_lib
    from repro_torch.serving import BlockPool, Request, ServingEngine

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------ 1. card and build
    card = card_line()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
          f", cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(cached={_build.BUILD_LOG.get('cached')})")
    for line in str(_build.BUILD_LOG.get("ptxas", "")).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(line.strip(), file=sys.stderr)

    # a 1 GiB write before each timed call evicts the 50 MB L2 (cold
    # caches, as on the path: every layer brings new weights) and keeps the
    # device busy (~0.3 ms) while the host enqueues the call, so the events
    # bracket the call's device time and not the host's launch latency
    flush = torch.empty(2 ** 28, dtype=torch.float32, device=dev)

    def time_ms(fn) -> float:
        """Mean device ms of one call over REPS calls, L2 flushed before
        each."""
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(REPS):
            flush.zero_()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / REPS

    def close_bf16(got, want, what):
        """bf16 outputs: one rounding each side -> |d| <= 1e-2·|want| + 1e-2."""
        g, w = got.float(), want.float()
        err = (g - w).abs()
        ok = bool((err <= 1e-2 * w.abs() + 1e-2).all())
        check(ok, f"{what}: max |kernel - plain| {err.max().item():.3e} "
                  "exceeds 1e-2*|plain| + 1e-2")
        return err.max().item()

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    rows = []

    def record(name, source, replaces, err, ms, plain_ms, nbytes, flops,
               peak, library_ms=None):
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": None,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        print(f"kernel {name}: max_abs_err {err:.3e}, {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, library "
              f"{'-' if library_ms is None else f'{library_ms:.4f}'} ms, "
              f"bound {b_ms:.4f} ms by {b_by})")

    src = "src/repro_torch/kernels/csrc/"
    tpu = "src/repro/kernels/"

    # ------------------------------------------------ 2a. router
    T, E, K_TOP = 256, 64, 8
    logits = randn(T, E, scale=0.5)
    w_k, m_k, c_k = topk_router(logits, K_TOP)
    w_p, m_p, c_p = ref.topk_router_ref(logits, K_TOP)
    check(torch.equal(m_k, m_p), "router mask differs from the plain version")
    check(torch.equal(c_k, c_p), "router counts differ from the plain version")
    err = (w_k - w_p).abs().max().item()
    check(err <= 1e-6, f"router weights: max err {err:.3e} > 1e-6 (fp32)")
    record("topk_router", src + "topk_router.cu",
           tpu + "topk_router.py:59", err,
           time_ms(lambda: topk_router(logits, K_TOP)),
           time_ms(lambda: ref.topk_router_ref(logits, K_TOP)),
           T * E * 2 + 2 * T * E * 4 + E * 4, 0.0, F32_FLOPS)

    # ------------------------------------------------ 2b. flash attention
    B, S, H, D = 2, 256, 16, 128
    for kv, window in ((16, 0), (4, 0), (16, 64)):
        q = randn(B, S, H, D)
        k = randn(B, S, kv, D)
        v = randn(B, S, kv, D)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        got = flash_attention(qt, kt, vt, window=window)
        want = ref.flash_attention_ref(qt, kt, vt, window=window)
        err = close_bf16(got, want, f"flash KV={kv} window={window}")
        print(f"flash check KV={kv} window={window}: max_abs_err {err:.3e}")
        if kv == 16 and window == 0:
            flash_err, fq, fk, fv = err, qt, kt, vt
    qc, kc, vc = (t.contiguous() for t in (fq, fk, fv))
    pairs = B * H * S * (S + 1) // 2            # causal band
    record("flash_attention", src + "flash_attention.cu",
           tpu + "flash_attention.py:92", flash_err,
           time_ms(lambda: flash_attention(fq, fk, fv)),
           time_ms(lambda: ref.flash_attention_ref(fq, fk, fv)),
           4 * B * H * S * D * 2, 4.0 * D * pairs, BF16_FLOPS,
           library_ms=time_ms(lambda: F.scaled_dot_product_attention(
               qc, kc, vc, is_causal=True)))

    # ------------------------------------------------ 2c. ragged trio
    DM, DE, R = 2048, 1024, 20
    x = randn(T, DM)
    w_r, m_r, _ = topk_router(randn(T, E, scale=0.5), K_TOP)
    plan = ragged_plan(m_r, w_r, budget=T * K_TOP, max_k=K_TOP)
    N = plan.src.shape[0]
    check(N == ragged_rows(T * K_TOP, E), "ragged plan size")
    xs = ragged_gather(x, plan.src, plan.valid)
    xs_p = ref.ragged_gather_ref(x, plan.src, plan.valid)
    check(torch.equal(xs, xs_p), "ragged_gather differs from the plain version")
    n_valid = int(plan.valid.sum())
    used_rows = int(torch.unique(plan.src[plan.valid.bool()]).numel())
    record("ragged_gather", src + "ragged_dispatch.cu",
           tpu + "ragged_dispatch.py:146", 0.0,
           time_ms(lambda: ragged_gather(x, plan.src, plan.valid)),
           time_ms(lambda: ref.ragged_gather_ref(x, plan.src, plan.valid)),
           used_rows * DM * 2 + N * 8 + N * DM * 2, 0.0, F32_FLOPS)

    w1 = randn(E, DM, DE, scale=DM ** -0.5)
    w2 = randn(E, DE, DM, scale=DE ** -0.5)
    la = randn(E, DM, R, scale=DM ** -0.5)
    lb = randn(E, R, DE, scale=0.1)
    be = plan.block_expert
    for what, args, kw in (("w1", (xs, be, w1), {}),
                           ("w1+lora", (xs, be, w1, la, lb), {"scale": 0.8}),
                           ("w2", (randn(N, DE), be, w2), {})):
        err = close_bf16(ragged_expert_matmul(*args, **kw),
                         ref.ragged_expert_matmul_ref(*args, **kw),
                         f"ragged_expert_matmul {what}")
        print(f"ragged_expert_matmul check {what}: max_abs_err {err:.3e}")
        if what == "w1":
            mm_err = err
    experts_used = int((m_r.sum(0) > 0).sum())
    record("ragged_expert_matmul", src + "ragged_dispatch.cu",
           tpu + "ragged_dispatch.py:189", mm_err,
           time_ms(lambda: ragged_expert_matmul(xs, be, w1)),
           time_ms(lambda: ref.ragged_expert_matmul_ref(xs, be, w1)),
           N * DM * 2 + experts_used * DM * DE * 2 + N * DE * 2,
           2.0 * n_valid * DM * DE, BF16_FLOPS)

    eo = randn(N, DM)
    got = ragged_combine(eo, plan.rows, plan.wrank)
    err = close_bf16(got, ref.ragged_combine_ref(eo, plan.rows, plan.wrank),
                     "ragged_combine")
    live = plan.rows[plan.wrank > 0]
    record("ragged_combine", src + "ragged_dispatch.cu",
           tpu + "ragged_dispatch.py:248", err,
           time_ms(lambda: ragged_combine(eo, plan.rows, plan.wrank)),
           time_ms(lambda: ref.ragged_combine_ref(eo, plan.rows, plan.wrank)),
           int(torch.unique(live).numel()) * DM * 2 + T * K_TOP * 8
           + T * DM * 2, 2.0 * live.numel() * DM, F32_FLOPS)

    # the decode step's shapes: 8 slots at tiers (8,8,4,4,2,2,1,1)
    slot_k = (8, 8, 4, 4, 2, 2, 1, 1)
    kt_ = torch.tensor(slot_k, device=dev)
    w_d, m_d, _ = ref.adaptive_topk_router_ref(randn(8, E, scale=0.5), kt_, 8)
    pd = ragged_plan(m_d, w_d, budget=sum(slot_k), max_k=8)
    x8 = randn(8, DM)
    xd = ragged_gather(x8, pd.src, pd.valid)
    hd_ = randn(pd.src.shape[0], DE)
    eod = randn(pd.src.shape[0], DM)
    dec = {
        "gather": time_ms(lambda: ragged_gather(x8, pd.src, pd.valid)),
        "matmul_w1": time_ms(lambda: ragged_expert_matmul(
            xd, pd.block_expert, w1)),
        "matmul_w2": time_ms(lambda: ragged_expert_matmul(
            hd_, pd.block_expert, w2)),
        "combine": time_ms(lambda: ragged_combine(eod, pd.rows, pd.wrank)),
    }
    print(f"decode-shape kernel ms (N={pd.src.shape[0]} rows, "
          f"{pd.block_expert.shape[0]} row blocks): "
          + ", ".join(f"{k} {v:.4f}" for k, v in dec.items()))
    del w1, w2, la, lb, xs, eo, x, flush
    torch.cuda.empty_cache()

    # ------------------------------------------------ 3. serving, FULL
    cfg = get_config("olmoe-1.3b-6.9b", "full")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serving: {cfg.name} {cfg.num_layers} layers, {n_params / 1e9:.3f} B "
          f"params bf16, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)

    def requests(n, lens, new):
        return [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, (lens[i % len(lens)],)).astype(np.int32),
                        max_new_tokens=new, k=slot_k[i % len(slot_k)])
                for i in range(n)]

    engine = ServingEngine(cfg, params, num_slots=8, slot_len=512,
                           slot_k=slot_k)
    engine.run(requests(8, (128, 256), 2))          # warm-up (cuBLAS, build)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    report = engine.run(requests(16, (128, 256), 16))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    summ = report.summary()
    check(summ["n_requests"] == 16 and summ["gen_tokens"] == 16 * 16,
          f"served {summ['n_requests']} requests / {summ['gen_tokens']} tokens")
    for c in report.completions:
        check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
              f"request {c.rid}: token ids out of range")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the serving run")
    n_prefill, n_decode = len(report.prefill_s), summ["decode_steps"]
    print(f"serving: {summ['gen_tokens']} tokens in {summ['wall_s']:.3f} s, "
          f"{summ['gen_tokens_per_s']:.1f} tokens/s, "
          f"TTFT p50 {summ['ttft_p50_ms']:.1f} ms, decode step p50 "
          f"{summ['decode_step_ms_p50']:.2f} ms (mean "
          f"{summ['decode_step_ms_mean']:.2f} ms, {n_decode} steps), "
          f"{n_prefill} prefill calls (p50 "
          f"{float(np.median(report.prefill_s)) * 1e3:.1f} ms), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"serving launches: {json.dumps(launches)}")
    for row in rows:
        row["launches"] = launches[row["name"]]
    del engine, params
    torch.cuda.empty_cache()

    # ------------------------------------------------ 4. end to end vs CPU
    cfg2 = cfg.replace(num_layers=2)
    p_cpu = model_lib.init_params(cfg2.replace(dtype="float32"),
                                  torch.Generator().manual_seed(1), "cpu")
    for dtype in (torch.float32, torch.bfloat16):
        pc = _cast(p_cpu, dtype, "cpu")
        pg = _cast(p_cpu, dtype, dev)
        c2 = cfg2.replace(dtype=str(dtype).split(".")[1])
        t0 = time.perf_counter()
        lg = _e2e_logits(model_lib, BlockPool, c2, pg, dev)
        t1 = time.perf_counter()
        lc = _e2e_logits(model_lib, BlockPool, c2, pc, "cpu")
        t2 = time.perf_counter()
        d = (lg - lc).abs()
        scale = lc.abs().max().item()
        row_rel = ((lg - lc).norm(dim=-1) / lc.norm(dim=-1)).flatten()
        agree = (lg.argmax(-1) == lc.argmax(-1)).float().mean().item()
        print(f"e2e {c2.dtype}: max |card - cpu| {d.max().item():.3e} "
              f"(max |cpu| {scale:.3f}), row rel err median "
              f"{row_rel.median().item():.3e} max {row_rel.max().item():.3e}, "
              f"argmax agreement {agree:.3f} over {row_rel.numel()} rows "
              f"(card {t1 - t0:.1f} s, cpu {t2 - t1:.1f} s)")
        if dtype == torch.float32:
            # fp32 both sides: only summation order differs
            check(d.max().item() <= 1e-4 * max(scale, 1.0),
                  "fp32 end-to-end logits differ by more than 1e-4·max|cpu|")
        else:
            # bf16: roundings differ at a few places per layer, and a
            # near-tied router choice may flip for a rare token, so the
            # bound is on the median row and on argmax agreement
            check(row_rel.median().item() <= 2e-2,
                  "bf16 end-to-end median row error above 2e-2")
            check(agree >= 0.9, "bf16 end-to-end argmax agreement below 0.9")

    # ------------------------------------------------ 5. summary
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _cast(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def _e2e_logits(model_lib, BlockPool, cfg, params, device):
    """Prefill 4 prompts of 32 tokens at k=8, then 4 teacher-forced paged
    decode steps at per-slot budgets (8, 4, 2, 1); returns the 5 logit rows
    per request as fp32 on the CPU, shape (5, 4, V)."""
    import torch
    rng = np.random.default_rng(2)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 32)),
                              device=device)
    forced = rng.integers(0, cfg.vocab_size, (4, 4))
    with torch.inference_mode():
        logits, piece = model_lib.prefill(cfg, params, prompts, k=8)
        out = [logits[:, 0].float().cpu()]
        pool = BlockPool(cfg, 4, 64, block_size=16, device=device)
        for s in range(4):
            pool.take(s)
            pool.reserve(s, 36)
        pool.write(range(4), piece, [32] * 4)
        active = torch.ones(4, device=device)
        for j in range(4):
            pool.prepare_decode(range(4))
            tok = torch.as_tensor(forced[:, j:j + 1], device=device)
            logits, _ = model_lib.decode_step(
                cfg, params, pool.cache, tok, pool.positions(),
                k=(8, 4, 2, 1), slot_mask=active,
                block_table=pool.tables(), page_span=pool.attn_len)
            pool.advance(range(4))
            out.append(logits[:, 0].float().cpu())
    return torch.stack(out)


if __name__ == "__main__":
    sys.exit(main())
