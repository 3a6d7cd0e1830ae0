#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FLAME — serving, the reference's default
federated training round, checkpoints and resume, the three baselines,
the serving engine's traffic layer, self-speculative decoding, LoRA
serving (the federated adapter unmerged), the registry's other archs,
the single-device train step, the device round driver, the
sliding-window ``swa`` variant, the SSM and hybrid families
(``mamba2-780m``, ``jamba-v0.1-52b``), audio codebooks (``musicgen-large``),
the attention logit softcap, the card mesh and its dry run — on one
NVIDIA GPU, and the mesh's multi-card steps with their activation modes
when four are visible.

    python3 chip_smoke.py           # every phase (one card)
    python3 chip_smoke.py --mesh    # the build and phases 21-22 alone

Run from the root of a checkout; it needs one CUDA device, ``nvcc`` and
nothing else of the network or the filesystem.  Phases:

1. card and build — the card's name and power limit (``nvidia-smi``), then
   every ``src/repro_torch/kernels/csrc/*.cu`` compiled for ``sm_90a``
   (ptxas register/spill report on stderr);
2. kernels — each of the seven CUDA kernels held against its plain
   PyTorch version on the card, on seeded inputs at its path's shapes
   (the serving path's for the router, flash and the ragged trio — the
   router's two entries: a static k at a prefill shape, per-token budgets
   at the decode step's and at T=256, and rows whose softmax is all NaN;
   the
   training round's for the two LoRA matmuls, plus ragged edges), with
   the tolerance stated beside each check — flash, the LoRA matmuls and
   the grouped ragged matmul in bf16 and fp16 (their tensor-core kernels)
   and float32 (their FMA kernels), the grouped matmul also with a LoRA
   rank above 64 (its FMA route); flash also checked with a window that
   is not a tile multiple (1000 at S = 2000) and checked and timed at the
   training round's shape, the expert kernel checked and timed at each
   tier, and the ragged trio checked (bf16, fp16; the gather and the
   combine also float32) and timed at the serving path's other shapes —
   the decode step, each prefill group of phase 4, and a skewed plan —
   beside each kernel's bound, ``torch._grouped_mm`` for the matmul and
   ``torch.index_select`` for the gather, and an empty kernel's time
   (the launch floor); kernel, plain and (where one PyTorch call
   computes the same function, or a yardstick close to it: the LoRA
   matmuls' base product, the gather without its zeroing; for the
   router a printed ``torch.topk`` of the softmax, not the same function)
   library
   times by CUDA events with the L2 flushed before every call, and each
   kernel's bound (bytes over 3.35 TB/s or FLOPs over the peak);
3. backward — gradients through the autograd wrappers (both LoRA
   matmuls, both router entries, flash, and the ragged trio on a plan at
   budgets (1, 2, 8, 0) with padding rows, the grouped matmul with a
   rank-20 adapter) against autograd through their plain versions,
   float32, b != 0; then a 2-layer full-width model's ``lm_loss``
   gradients (every trainable leaf) under ragged dispatch against dense
   dispatch on the card, relative L2 <= 1e-4;
4. serving — OLMoE-1.3B/6.9B FULL (16 layers, bf16, random seeded weights)
   served by ``ServingEngine``: 8 slots at tiers (8,8,4,4,2,2,1,1), 16
   requests of 128/256-token prompts and 16 new tokens each, one request
   per prefill call; the launch counters are zeroed just before and read
   just after, and every kernel of the path must have launched: the
   static router once per layer and prefill call, the per-token-budget
   router once per layer and decode step;
5. training — the reference's default FLAME round on the same FULL
   weights (``build_experiment`` + ``FederatedServer.run_round``, the
   batched cohort engine and host driver): 8 clients, two each at
   k = 8, 4, 2, 1 (four cohorts of two) with learnable rescalers, batch
   16 x 128 tokens, Adam; the counters are zeroed just before and read
   just after: the LoRA matmuls, router and flash must have launched and
   the ragged trio and the per-token-budget router not.  The start state
   is checkpointed (save and load timed, file size printed), and the
   looped engine, restored from it, runs the same round: participants,
   activation counts and launches equal, losses, rescalers and the
   aggregate within the tolerances stated there; then each engine once
   more from the checkpoint (looped, batched), for round times in the
   order batched, looped, looped, batched;
6. end to end — a 2-layer full-width model on the card (kernels) and on
   the CPU (plain versions) on the same weights: serving logits (prefill
   plus 4 paged decode steps) and the training loss with the gradient of
   every trainable leaf, compared in float32 and bf16;
7. resume — on the 2-layer full-width model, 2 default-engine rounds
   straight through against 1 round, ``save_checkpoint``, a fresh
   server's ``run(resume_from=...)``: the same participants and round
   index, state within one bf16 ulp;
8. baselines — one default-engine round each of ``trivial``, ``hlora``
   and ``flexlora`` on that model: finite losses, the server rank's
   shapes, trivial's zero components above r_min, FlexLoRA's product
   against the rank-r truncation of the mean ΔW;
9. round memory — a FLAME round's memory above its start on both
   engines at 8, 32 and 64 clients on that model (losses within 1e-6);
10. traffic — the serving engine's traffic layer: (a) OLMoE FULL with the
   serving phase's weights, 8 slots x 512 tokens at tiers
   (8,8,4,4,2,2,1,1), prefix cache (suffix-only prefill), per-tier TTFT
   targets (EDF) and preemption, with a tracer, a metrics registry and
   expert telemetry, on 24 requests of 192/320-token prompts that open
   with one of two 128-token system prompts (16 new tokens): a closed
   batch (launch counts zeroed just before and read just after: every
   serving kernel carried traffic, one router launch per layer and engine
   call), then Poisson arrivals at half its request rate; against a cold
   engine: prefix hits, fewer prompt tokens prefilled, the first token of
   every hit request, the suffix step's logits against a cold prefill
   (every row within 1e-3), a valid Chrome trace with every request's
   lifecycle, the metrics snapshot, expert counts that sum to the
   decode steps' budgets, pool invariants and every block freed;
   tokens/s with the observability off measures its overhead; then the
   suffix step's kernels at its shapes, every layer: three suffix groups
   of two rows through the engine's suffix call (flash over T = 192 and
   320 laid-out rows with zero prefix queries, a masked group on the
   per-token router), each wrapper call against its plain version and
   each layer's suffix attention against the plain
   ``verify_attention``; (b) forced preemption at FULL width (two
   slots, a 32-block pool): the swap's bytes and milliseconds, both
   requests' tokens equal to their solo runs; (c) a 2-layer full-width
   float32 model: the traffic engine token for token against the cold
   engine, and the suffix step's kernels checked as in (a);
11. speculative — self-speculative decoding (W = 4 drafts at k = 1, one
   full-k verify): (a) OLMoE FULL, bf16, the serving phase's engine shape
   and 16 requests, greedy: plain paged decode against speculative
   engines on the paged and the slotted pool — requests token-identical
   to plain decode, or the first divergence a near-tie (the plain top-2
   logit gap no larger than the largest |verify - plain| logit there);
   acceptance per tier, rounds, draft-window and verify ms, tokens/s
   against plain, hand-kernel launches per round against per plain
   decode step; every serving kernel launched by the speculative run
   (counts zeroed just before it, static router once per layer and
   prefill call or draft step, per-token router once per layer and
   verify step); (b) every kernel call of one round — the static router
   at T = 8, k = 1 in the draft steps, the per-token router at T = 40 in
   the verify step, the ragged trio at both — against its plain version
   at every layer, and layer 0's calls timed at both shapes beside their
   bounds; (c) sampled (top-p 0.9, temperature 0.8), plain and
   speculative: reproducible by seed, another seed other tokens, slotted
   against paged agreement; (d) the 2-layer full-width model in float32:
   greedy speculative tokens equal plain decode's on both layouts, k = 1
   slots accept every draft (or each miss is a near-tie), sampled tokens
   equal across layouts, the kernel calls of one round within 1e-5, and
   speculation with prefix cache and preemption on (b)'s forced-
   preemption shape token for token against the same engine without it;
12. LoRA serving — (a) OLMoE FULL, bf16, the serving phase's weights,
   engine shape and 16 requests, with a seeded rank-20 adapter on q/k/v/o
   and every expert's w1/w2/w3 (its LoRA term a tenth of the base
   product's rms on layer 0) served unmerged (``lora=``) against the
   engine on ``merge_into_params``: requests token-identical or the first
   divergence a near-tie (phase 11's rule); against the engine without
   the adapter most requests differ; counts zeroed just before the
   unmerged run: the grouped ragged matmul (its LoRA route) 3 and
   ``lora_matmul`` 4 launches per layer and engine call, hand-kernel
   launches per decode step against merged serving's, tokens/s and
   decode p50 of the three; (b) every kernel call of one prefill call
   (T = 256, k = 8) and one decode step (T = 8, the tiers) against its
   plain version at every layer, layer 0's LoRA calls timed beside their
   bounds and the library's base product; (c) the 2-layer full-width
   model in float32 with a random adapter: token for token unmerged
   against merged, ragged against dense and capacity (factor E),
   speculative against plain decode, prefix-cached against cold; under
   dense and capacity dispatch, at bf16 FULL and in (c): counts zeroed
   just before each run, ``lora_matmul_experts`` 3 and ``lora_matmul`` 4
   launches per layer and engine call and no ragged launch, and every
   kernel call of one prefill call (two 256-token prompts at k = 8: two
   routing groups under dense) and one decode step held against its plain
   version; dense at bf16 FULL against ragged by the near-tie rule; (d)
   phase 5's global adapter with one client's rescaler per tier served
   unmerged at FULL: every request complete, finite logits;
13. archs — the registry's dense-FFN archs and the shared-expert MoE
   (olmo-1.3b, qwen3-1.7b, phi4-mini-3.8b, qwen2-moe-a2.7b, granite-20b,
   chameleon-34b) at full width, bf16, random seeded weights, one model
   on the card at a time, each at the largest depth (up to FULL) at which
   its weights, an 8 x 512 KV pool and a 6 GiB reserve fit: the engine
   serves 8 requests of 128/256-token prompts, 16 new tokens each (tiers
   4,4,2,2,1,1,1,1 for the MoE, one tier for a dense arch), counts zeroed
   just before and read just after (a dense arch launches flash once per
   layer and prefill call and no router, ragged or LoRA kernel; the MoE
   the serving path's five kernels once per layer and engine call);
   every kernel call of one prefill call (T = 256) and one decode step
   held against its plain version; layer 0's flash (GQA 24/8 on
   phi4-mini, MQA 48/1 on granite) and the MoE's router and ragged trio
   at E = 60, k = 4 timed beside their bounds and library calls; then
   OLMo-1.3B FULL runs one HLoRA round of 4 clients at the dense rank
   grid (40/24/16/12) with the FFN adapters, and ``lora_matmul`` is held
   and timed at its FFN shapes (2048 <-> 8192, r = 40, M = 2048) with its
   fp32 backward timed;
14. train step — ``launch/steps.py`` ``build_train`` on OLMo-1.3B FULL
   at train_4k's sequence length (4096) with the global batch cut to 8:
   the knobs it chose, s/step, tokens/s, peak memory, a finite loss and
   Adam's step at 1; at batch 1 with and without layer checkpointing on
   the same batch: the same loss within bf16 tolerance and a lower peak
   with it; flash at S = 4096 timed; ``build_prefill`` and
   ``build_serve`` once at a small shape in fp32, logits and caches
   against the plain versions on the card;
15. device round driver — ``round_driver="device"`` on OLMoE FULL
   (phase 5's ``FederatedConfig`` at participation 0.75, 3 rounds,
   ``checkpoint_every=2``: a 2-round and a 1-round segment, a checkpoint
   at each end) against the host driver from the same seeded start: the
   global LoRA, every rescaler, per-client losses and frequencies within
   rtol 2e-5 / atol 1e-6, and whether they are bit-equal; s/round and
   launches per round on each driver, the host syncs inside each
   segment's rounds under ``torch.cuda.set_sync_debug_mode("warn")``,
   the checkpoint's round index;
16. swa — ``get_config("olmoe-1.3b-6.9b", "swa")`` (window 8192) on the
   same weights: 4 requests of 8,180 / 9,000 / 10,240 / 12,288-token
   prompts (32 new tokens, tiers 8, 4, 2, 1) on 8,192-token ring caches,
   paged then slotted: tokens equal or near-ties, every request complete,
   launch counts, every kernel call of a decode step against its plain
   version, layer 0's flash of the 12,288-token prefill against its plain
   version and timed beside its bound and SDPA with a band mask, TTFT of
   the longest prompt and decode p50;
17. SSM and hybrid — (a) ``mamba2-780m`` FULL (48 layers, attention-free)
   on the slotted pool (a paged request falls back to it): 8 requests of
   128/256-token prompts x 16 new tokens with no hand kernel launched
   (the projections are plain products and the SSD plain PyTorch, as the
   reference's are jnp), then with a seeded rank-16 adapter unmerged:
   ``lora_matmul`` twice per layer and engine call, every call of one
   prefill call and one decode step against its plain version; one HLoRA
   round of 4 clients at ranks 16/10/6/5, batch 16 x 128; ``lora_matmul``
   at 1536 -> 6448 (r = 16 and 5, an N that ends in a partial tile) and
   3072 -> 1536 held and timed; (b) ``jamba-v0.1-52b`` at full width at
   the largest whole-period depth that fits beside a 16 GiB reserve
   (printed; 16 of 32 layers on an 80 GB card): the paged engine on 8
   requests at tiers 2,2,1,1,1,1,1,1, a
   slotted repeat (tokens equal or near-ties by phase 11's rule), launch
   counts per attention and MoE layer, every kernel call of one prefill
   and one decode step against its plain version, the router at E = 16,
   flash at GQA 32/8 and the ragged trio at 4096 <-> 14,336 timed beside
   their bounds and library calls; one FLAME round of 4 clients at k =
   2,1,1,1, batch 16 x 128, at the depth that fits beside a 40 GiB
   training reserve (8 layers); ``lora_matmul`` at 4096 -> 16,768 and 8192
   -> 4096 and ``lora_matmul_experts`` at E = 16, C = 320, 4096 ->
   14,336 held and timed; both: tokens/s, decode and prefill p50,
   s/round, peak memory, the SSM state rows' bytes and the plain SSD's
   time per layer at prefill;
19. audio codebooks and the logit softcap — ``musicgen-large`` FULL (48
   layers, d_model 2048, MHA 32/32 at head_dim 64, d_ff 8192, 4 codebooks
   of 2048 tokens; 3.255 B parameters, uncut): (b) ``launch/steps.py``
   ``build_train`` at train_4k's 4096 tokens, the global batch cut from
   256 to 8, on (B, S, 4) codebook tokens: knobs, loss at step 0 near
   ln 2048, s/step, tokens/s, peak against the chooser's estimate; (c) on
   a 4-codebook corpus at V = 2048: one FLAME round (8 clients, batch 16 x
   128) on the host and on the device round driver, bit-equal, and one
   HLoRA round at ranks 16/10/6/5 (s/step, s/round, peak); (d) 2 layers
   at full width in float32: the codebook loss and every adapter leaf's
   gradient on the card against the CPU's plain path (relative L2); (e)
   OLMoE at full width and 2 layers with ``attn_logit_softcap`` = 50 and
   its QK norms' gains times 8 (scores of tens, so the cap acts), bf16:
   served on the paged and the slotted pool (8 requests, tokens equal,
   flash once per layer and prefill call) and without the cap (other tokens); every
   kernel call of one prefill call and one decode step against its plain
   version (each flash call also missing the uncapped plain version); in
   float32 a prefill through the kernels against the plain versions,
   greedy speculative and plain decode equal on both pools, and one
   request's engine tokens equal greedy by whole prefills; (a) flash at
   MHA 32/32, D = 64 (B = 16, S = 128 and the train step's microbatch at
   S = 4096) without and with a cap of 50, at row 2's shape and row 2W's
   window with the cap, and at the capped serve's prefill call, and
   ``lora_matmul`` at M = 2048 for 2048 -> 2048, 2048 -> 8192 and 8192 ->
   2048 at r = 16 and 5, each held against its plain version and timed
   beside its bound and the library call (SDPA; compiled
   ``flex_attention`` with a tanh ``score_mod`` for a cap or a window;
   the LoRA matmul's base product); launches from the run that gave the
   shape, 0 where no path launches it;
21. the card mesh (after 19; ``launch/mesh.py``, ``launch/sharding.py``,
   ``launch/steps.py`` with ``mesh=``) — the parent frees its cached
   memory and spawns one NCCL worker a card (``launch.mesh.spawn``; a
   worker's failed check fails the phase): on one card a world of one,
   mesh (1, 1): ``qwen3-moe-235b-a22b``, ``llama3-405b``, ``mamba2-780m``,
   ``musicgen-large``, ``phi4-mini-3.8b`` and ``granite-20b`` at full
   width cut to 2 layers and ``jamba-v0.1-52b`` to one period of 8, the
   mesh train step (B = 2,
   S = 2048, n_micro 2, the
   adapters' ``b`` off zero, rescalers at 0.7) bit-equal to the
   single-device ``build_train`` on the same weights and batch (loss,
   counts, adapters, Adam's moments), launch counts, every kernel call of
   one mesh forward (the router at E = 128, k = 8 and E = 16, k = 2,
   flash at 64/4, 128/8, 32/8, 32/32, 24/8 and 48/1 heads,
   ``lora_matmul`` at q/k/v/o, the FFNs and the Mamba block's in/out
   projections, ``lora_matmul_experts`` at 128 and 16 experts) against
   its plain version within close_16bit and layer 0's timed beside bound,
   plain and library; the mesh prefill and decode step of qwen3, mamba2,
   jamba, phi4-mini and granite bit-equal to the single-device steps.
   With four cards visible (``--mesh`` on a four-card machine): the
   2-layer qwen3 on (1, 4), (2, 2) and (2, 1, 2) against rank 0's
   one-card run (loss and adapters within close_16bit, the counts' total
   equal and at most 2% of routes moved, decoded tokens equal or
   near-ties); mamba2-780m (48 layers, also prefill and 4 decode steps)
   and musicgen-large (48 layers, train only) FULL on (2, 2) against one
   card, alike; phi4-mini-3.8b (32 layers: 6/2 heads a rank, its
   prefill's own KV heads redistributed by sequence) and granite-20b (52:
   MQA) at ``deepest_fit``'s depth served on (1, 4), the decode cache
   split by sequence and every rank's partial softmax merged: a prefill
   of 8 x 4096 tokens and 8 decode steps fed rank 0's one-card tokens,
   each row's logits within 5e-2 relative L2 of the one card's (bf16's
   rounded partial sums compound over the depth; close_16bit's verdict
   printed) and each argmax equal or a near-tie; qwen3 and llama3 at the
   deepest whole-period cut the knob chooser's estimate fits on (2, 2)
   in "batch", jamba at ``deepest_fit``'s (the card's memory less 8
   GiB): two train steps at 4096 tokens (train_4k's batch cut to 8:
   loss, s/step, tokens/s, peak per rank against the estimate, the
   collectives' calls, bytes and ms), a prefill of 8 x 4096 tokens and 8
   decode steps; every kernel call of one microbatch's forward (S =
   4096, a row a rank) of mamba2 and musicgen (2 layers) and jamba (one
   period) on (2, 2) and of phi4-mini and granite (2 layers) on (1, 4)
   against its plain version; then the kernels at (2, 2)'s per-rank
   shapes timed on rank 0, and at a 16-way rank's, which only the dry run
   runs (flash at phi4-mini's 2/1 and granite's 3/1 heads, phi4-mini's q
   from the gathered ``wq`` columns);
22. ``act_mode`` and the dry run (with 21; ``models/parallel.py``
   ``split_to`` / ``gather_from``, ``launch/dryrun.py``,
   ``launch/roofline.py``) — the dry run of each (arch, step, mesh,
   act_mode) the cards run here goes to subprocesses of its own (a
   process that has started NCCL cannot start torch's ``fake`` backend),
   started once the card workers have returned, so it never runs beside
   a timed window: every pair traced once as rank 0 of a fake
   world of the same shape on ``meta`` tensors, at the same knobs.  On
   one card: the (1, 1) pairs of phase 21 (their estimated peak beside
   the measured one; a world of one has no collectives).  With four
   cards, after phase 21's deep runs: qwen3-moe and llama3 at phase 21's
   depths on (2, 2) (4096 tokens, batch 8), phase 21's weights and first
   batch, its ``n_micro``, ``num_groups`` and ``remat_chunk`` passed
   explicitly: one train step with ``act_mode`` "batch", "dmodel" and
   "sp" each — dmodel and sp bit-equal to batch (loss, counts, adapters,
   Adam's moments), s/step, peak per rank, the collectives by kind,
   launch counts — and every kernel call of one microbatch's forward in
   dmodel and sp (the 2-layer cut, S = 4096) against its plain version
   within close_16bit; the depth ``deepest_fit`` gives with the dmodel
   fallback beside phase 21's; then each dry-run pair's collective calls
   and bytes by kind equal to what the cards counted (the 2-layer qwen3
   on (2, 2) and (1, 4), mamba2 and musicgen FULL on (2, 2), phi4-mini
   and granite's (1, 4) prefill and decode steps, the deep runs' train,
   prefill and decode steps, dmodel and sp), its estimated
   peak beside the measured one and its
   roofline terms beside the measured s/step and collective ms; one
   16 x 16 pair (qwen3-moe x train_4k) traced, its wall time printed;
20. summary — a ``{"kernels": [...]}`` line, then the last line
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


def _kernel_tools(torch, dev, flush):
    """The kernel checks' rules and timer: ``close16`` (bf16 / fp16 within
    an ulp each side), ``close`` (``close16``, or float32 within
    1e-4·max(max|plain|, 1)), ``router`` (mask and counts exact, weights
    within 1e-6, NaN where the plain version has NaN) and ``time_ms``
    (mean device ms of one call over REPS calls, a 1 GiB write before
    each: ``flush[0]``, or a new buffer when ``flush`` is empty)."""

    def time_ms(fn) -> float:
        buf = flush[0] if flush else torch.empty(
            2 ** 28, dtype=torch.float32, device=dev)
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(REPS):
            buf.zero_()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / REPS

    def close_16bit(got, want, what):
        """bf16 / fp16 outputs: one rounding each side, at most an ulp
        apart -> |d| <= tol·|want| + tol, tol 1e-2 (bf16) or 2e-3 (fp16)."""
        tol = 2e-3 if got.dtype == torch.float16 else 1e-2
        g, w = got.float(), want.float()
        err = (g - w).abs()
        ok = bool((err <= tol * w.abs() + tol).all())
        check(ok, f"{what}: max |kernel - plain| {err.max().item():.3e} "
                  f"exceeds {tol:g}*|plain| + {tol:g}")
        return err.max().item()

    def close_any(got, want, what):
        """close_16bit for bf16 / fp16; float32 both sides differs in
        summation order only: |d| <= 1e-4·max(max|plain|, 1)."""
        if got.dtype != torch.float32:
            return close_16bit(got, want, what)
        err = (got - want).abs().max().item()
        check(err <= 1e-4 * max(want.abs().max().item(), 1.0),
              f"{what}: max |kernel - plain| {err:.3e} > 1e-4·max|plain|")
        return err

    def router_check(got, want, what):
        check(torch.equal(got[1], want[1]), f"{what}: mask differs from the "
              "plain version")
        check(torch.equal(got[2], want[2]), f"{what}: counts differ from the "
              "plain version")
        fin = ~want[0].isnan()
        same_nan = torch.equal(got[0].isnan(), ~fin)
        err = ((got[0] - want[0])[fin].abs().max().item()
               if bool(fin.any()) else 0.0)
        check(same_nan and err <= 1e-6,
              f"{what}: weights max err {err:.3e} > 1e-6 or NaN differs")
        return err

    return {"time_ms": time_ms, "close16": close_16bit, "close": close_any,
            "router": router_check}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, backend, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lora_matmul import (lora_matmul,
                                                 lora_matmul_experts)
    from repro_torch.kernels.ragged_dispatch import (ragged_combine,
                                                     ragged_expert_matmul,
                                                     ragged_gather,
                                                     ragged_plan, ragged_rows)
    from repro_torch.kernels.topk_router import (adaptive_topk_router,
                                                 topk_router)
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
    if "--mesh" in sys.argv[1:]:
        # phases 21-22 alone (the four-card run)
        print(json.dumps({"kernels": mesh_phase(torch)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # a 1 GiB write before each timed call evicts the 50 MB L2 (cold
    # caches, as on the path: every layer brings new weights) and keeps the
    # device busy (~0.3 ms) while the host enqueues the call, so the events
    # bracket the call's device time and not the host's launch latency
    # (held through the kernel phase; later phases take it back per call)
    flush = [torch.empty(2 ** 28, dtype=torch.float32, device=dev)]

    tools = _kernel_tools(torch, dev, flush)
    time_ms, close_16bit, close_any, router_check = (
        tools["time_ms"], tools["close16"], tools["close"], tools["router"])

    # the floor under any kernel's time: an empty kernel, timed alike
    floor_ms = time_ms(lambda: _build.empty_launch(flush[0]))
    print(f"empty kernel (launch floor, timed as the kernels): "
          f"{floor_ms:.4f} ms")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    rows = []

    def record(name, source, replaces, err, ms, plain_ms, nbytes, flops,
               peak, library_ms=None, library_what=None):
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": None,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        lib = "-" if library_ms is None else f"{library_ms:.4f}"
        if library_what:
            lib += f" ({library_what})"
        print(f"kernel {name}: max_abs_err {err:.3e}, {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, library {lib} ms, "
              f"bound {b_ms:.4f} ms by {b_by})")

    src = "src/repro_torch/kernels/csrc/"
    tpu = "src/repro/kernels/"

    # ------------------------------------------------ 2a. router
    # masks and counts exactly, fp32 weights within 1e-6 (NaN where the
    # plain version has NaN); the static entry at T=256 k=8 (a prefill
    # group), the per-token-budget entry at the decode step's shape (8
    # slots at tiers 8,8,4,4,2,2,1 and a free slot at 0) and at T=256
    T, E, K_TOP = 256, 64, 8
    slot_k = (8, 8, 4, 4, 2, 2, 1, 1)

    def router_bytes(n_tok, with_budgets=False):
        """bf16 logits read, fp32 weights and mask written, counts; the
        budgets read once."""
        return (n_tok * E * 2 + 2 * n_tok * E * 4 + E * 4
                + (4 * n_tok if with_budgets else 0))

    logits = randn(T, E, scale=0.5)
    err = router_check(topk_router(logits, K_TOP),
                       ref.topk_router_ref(logits, K_TOP), "topk_router")
    record("topk_router", src + "topk_router.cu",
           tpu + "topk_router.py:59", err,
           time_ms(lambda: topk_router(logits, K_TOP)),
           time_ms(lambda: ref.topk_router_ref(logits, K_TOP)),
           router_bytes(T), 0.0, F32_FLOPS)
    # a yardstick only: softmax and torch.topk compute neither the
    # renormalised weights nor the mask and counts
    print(f"router yardstick (not the same function: no renormalisation, "
          f"no mask, no counts) torch.topk(torch.softmax(l.float(), -1), 8)"
          f" at 256x64: {time_ms(lambda: torch.topk(torch.softmax(logits.float(), -1), K_TOP)):.4f} ms")

    k_dec = torch.tensor((8, 8, 4, 4, 2, 2, 1, 0), dtype=torch.int32,
                         device=dev)
    k_256 = torch.tensor(slot_k, dtype=torch.int32, device=dev).repeat(T // 8)
    l_dec = randn(8, E, scale=0.5)
    for what, lg, kt in (("decode T=8", l_dec, k_dec),
                         ("T=256", logits, k_256)):
        err = router_check(adaptive_topk_router(lg, kt, K_TOP),
                           ref.adaptive_topk_router_ref(lg, kt, K_TOP),
                           f"adaptive_topk_router {what}")
        uni = torch.full_like(kt, K_TOP)
        check(all(torch.equal(a, b) for a, b in zip(
            adaptive_topk_router(lg, uni, K_TOP), topk_router(lg, K_TOP))),
              f"adaptive_topk_router {what}: uniform budgets differ from "
              "the static entry")
        ms_ = time_ms(lambda: adaptive_topk_router(lg, kt, K_TOP))
        plain_ = time_ms(lambda: ref.adaptive_topk_router_ref(lg, kt, K_TOP))
        if what.startswith("decode"):
            record("adaptive_topk_router", src + "topk_router.cu",
                   tpu + "topk_router.py:59", err, ms_, plain_,
                   router_bytes(8, True), 0.0, F32_FLOPS)
        else:
            print(f"adaptive_topk_router at {what}: max_abs_err {err:.3e}, "
                  f"{ms_:.4f} ms (plain {plain_:.4f} ms, bound "
                  f"{bound_ms(router_bytes(T, True), 0.0, F32_FLOPS)[0]:.4f}"
                  f" ms)")
    # rows whose softmax is all NaN (a NaN, a +inf, all -inf) select
    # expert 0 in every round, as the reference's argmax does
    bad = randn(T, E, scale=0.5)
    bad[1, 3], bad[2, 5], bad[3] = float("nan"), float("inf"), float("-inf")
    router_check(topk_router(bad, K_TOP), ref.topk_router_ref(bad, K_TOP),
                 "topk_router non-finite rows")
    router_check(adaptive_topk_router(bad, k_256, K_TOP),
                 ref.adaptive_topk_router_ref(bad, k_256, K_TOP),
                 "adaptive_topk_router non-finite rows")
    check(bool((topk_router(bad, K_TOP)[1][1:4, 0] == K_TOP).all()),
          "non-finite rows do not select expert 0 in every round")
    print("router checks: static and per-token-budget entries equal the "
          "plain versions (decode, T=256, non-finite rows); uniform budgets "
          "equal the static entry bit for bit")
    del bad, l_dec

    # ------------------------------------------------ 2b. flash attention
    # bf16 and fp16 run the tensor-core kernel, float32 the FMA kernel
    B, S, H, D = 2, 256, 16, 128
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        dn = str(dtype).split(".")[1]
        for kv, window in ((16, 0), (4, 0), (16, 64)):
            q = randn(B, S, H, D, dtype=dtype)
            k = randn(B, S, kv, D, dtype=dtype)
            v = randn(B, S, kv, D, dtype=dtype)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            got = flash_attention(qt, kt, vt, window=window)
            want = ref.flash_attention_ref(qt, kt, vt, window=window)
            what = f"flash {dn} KV={kv} window={window}"
            if dtype == torch.float32:
                # fp32 both sides: summation order only
                err = (got - want).abs().max().item()
                check(err <= 1e-4, f"{what}: max |kernel - plain| {err:.3e}"
                                   " > 1e-4")
            else:
                err = close_16bit(got, want, what)
            print(f"flash check {dn} KV={kv} window={window}: max_abs_err "
                  f"{err:.3e}")
            if dtype == torch.bfloat16 and kv == 16 and window == 0:
                flash_err, fq, fk, fv = err, qt, kt, vt
    # the swa path's band: a window that is not a tile multiple at a
    # sequence that is not one either (key tiles before a query block's
    # window skipped, the band's edge masked inside a tile)
    Sw, Ww = 2000, 1000
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        dn = str(dtype).split(".")[1]
        q = randn(1, Sw, H, D, dtype=dtype).transpose(1, 2)
        k, v = (randn(1, Sw, 4, D, dtype=dtype).transpose(1, 2)
                for _ in range(2))
        err = close_any(flash_attention(q, k, v, window=Ww),
                        ref.flash_attention_ref(q, k, v, window=Ww),
                        f"flash {dn} S={Sw} window={Ww}")
        print(f"flash check {dn} S={Sw} KV=4 window={Ww}: max_abs_err "
              f"{err:.3e}")
    del q, k, v
    qc, kc, vc = (t.contiguous() for t in (fq, fk, fv))
    pairs = B * H * S * (S + 1) // 2            # causal band
    record("flash_attention", src + "flash_attention.cu",
           tpu + "flash_attention.py:92", flash_err,
           time_ms(lambda: flash_attention(fq, fk, fv)),
           time_ms(lambda: ref.flash_attention_ref(fq, fk, fv)),
           4 * B * H * S * D * 2, 4.0 * D * pairs, BF16_FLOPS,
           library_ms=time_ms(lambda: F.scaled_dot_product_attention(
               qc, kc, vc, is_causal=True)))
    # the training round's shape: B=16 sequences of S=128, 96 calls a round
    Bt, St = 16, 128
    qt_, kt_, vt_ = (randn(Bt, St, H, D).transpose(1, 2) for _ in range(3))
    qtc, ktc, vtc = (t.contiguous() for t in (qt_, kt_, vt_))
    err = close_16bit(flash_attention(qt_, kt_, vt_),
                      ref.flash_attention_ref(qt_, kt_, vt_),
                      "flash bf16 at the training shape")
    print(f"flash check bf16 B={Bt} S={St}: max_abs_err {err:.3e}")
    tb_ms, tb_by = bound_ms(4 * Bt * H * St * D * 2,
                            4.0 * D * Bt * H * St * (St + 1) // 2, BF16_FLOPS)
    print(f"flash at the training shape (B={Bt} S={St} H={H} D={D} bf16): "
          f"{time_ms(lambda: flash_attention(qt_, kt_, vt_)):.4f} ms, SDPA "
          f"{time_ms(lambda: F.scaled_dot_product_attention(qtc, ktc, vtc, is_causal=True)):.4f}"
          f" ms, bound {tb_ms:.4f} ms by {tb_by}")
    del qt_, kt_, vt_, qtc, ktc, vtc

    # ------------------------------------------------ 2c. ragged trio
    DM, DE, R = 2048, 1024, 20

    def gather_cost(pl):
        """Bytes the gather must move: each used x row read once, src and
        valid, every output row written once."""
        n_rows = pl.src.shape[0]
        used = int(torch.unique(pl.src[pl.valid.bool()]).numel())
        return used * DM * 2 + n_rows * 8 + n_rows * DM * 2, 0.0

    def combine_cost(pl):
        """(bytes, FLOPs) of the combine: each live eo row read once, rows
        and wrank, every output row written once; a multiply and an add
        per live rank and column."""
        live = pl.rows[pl.wrank > 0]
        return (int(torch.unique(live).numel()) * DM * 2 + pl.rows.numel() * 8
                + pl.rows.shape[0] * DM * 2, 2.0 * live.numel() * DM)

    x = randn(T, DM)
    w_r, m_r, _ = topk_router(randn(T, E, scale=0.5), K_TOP)
    plan = ragged_plan(m_r, w_r, budget=T * K_TOP, max_k=K_TOP)
    N = plan.src.shape[0]
    check(N == ragged_rows(T * K_TOP, E), "ragged plan size")
    xs = ragged_gather(x, plan.src, plan.valid)
    xs_p = ref.ragged_gather_ref(x, plan.src, plan.valid)
    check(torch.equal(xs, xs_p), "ragged_gather differs from the plain version")
    # yardstick: index_select moves the same bytes but leaves padding rows
    # as copies of x[0] where the kernel writes x[0]·0
    record("ragged_gather", src + "ragged_dispatch.cu",
           tpu + "ragged_dispatch.py:146", 0.0,
           time_ms(lambda: ragged_gather(x, plan.src, plan.valid)),
           time_ms(lambda: ref.ragged_gather_ref(x, plan.src, plan.valid)),
           *gather_cost(plan), F32_FLOPS,
           library_ms=time_ms(lambda: torch.index_select(x, 0, plan.src)),
           library_what="torch.index_select, no zeroing of padding rows")

    w1 = randn(E, DM, DE, scale=DM ** -0.5)
    w2 = randn(E, DE, DM, scale=DE ** -0.5)
    la = randn(E, DM, R, scale=DM ** -0.5)
    lb = randn(E, R, DE, scale=0.1)
    be = plan.block_expert

    def matmul_checks():
        """The grouped matmul at T=256 k=8 in each dtype: bf16 / fp16 run
        the tensor-core kernel (LoRA r <= 64 included), float32 and a LoRA
        rank above 64 the FMA kernel.  Returns bf16 w1's error."""
        h2 = randn(N, DE)
        errs = {}
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            dn = str(dtype).split(".")[1]
            c = [t.to(dtype) for t in (xs, w1, la, lb, h2, w2)]
            for what, args, kw in (
                    ("w1", (c[0], be, c[1]), {}),
                    ("w1+lora r20", (c[0], be, c[1], c[2], c[3]),
                     {"scale": 0.8}),
                    ("w2", (c[4], be, c[5]), {})):
                got = ragged_expert_matmul(*args, **kw)
                want = ref.ragged_expert_matmul_ref(*args, **kw)
                if dtype == torch.float32:
                    # fp32 both sides: summation order only (K <= 2048)
                    err = (got - want).abs().max().item()
                    check(err <= 1e-4 * max(want.abs().max().item(), 1.0),
                          f"ragged_expert_matmul {dn} {what}: max |kernel - "
                          f"plain| {err:.3e} > 1e-4·max|plain|")
                else:
                    err = close_16bit(got, want,
                                      f"ragged_expert_matmul {dn} {what}")
                print(f"ragged_expert_matmul check {dn} {what}: max_abs_err "
                      f"{err:.3e}")
                errs[dn, what] = err
        la80 = randn(E, DM, 80, scale=DM ** -0.5)
        lb80 = randn(E, 80, DE, scale=0.1)
        err = close_16bit(
            ragged_expert_matmul(xs, be, w1, la80, lb80, scale=0.8),
            ref.ragged_expert_matmul_ref(xs, be, w1, la80, lb80, 0.8),
            "ragged_expert_matmul bf16 w1+lora r80 (FMA route)")
        print(f"ragged_expert_matmul check bfloat16 w1+lora r80 (FMA route): "
              f"max_abs_err {err:.3e}")
        return errs["bfloat16", "w1"]

    mm_err = matmul_checks()

    def grouped_mm_ms(xs_, be_, w_):
        """torch._grouped_mm over the same segments (the yardstick: one
        PyTorch call, no LoRA), or None where this torch lacks it."""
        bm_ = xs_.shape[0] // be_.shape[0]
        ends = (torch.cumsum(torch.bincount(be_.long(), minlength=E), 0)
                * bm_).to(torch.int32)
        if not hasattr(torch, "_grouped_mm"):
            return None
        return time_ms(lambda: torch._grouped_mm(xs_, w_, offs=ends))

    def matmul_cost(pl, K, H):
        """(bytes, FLOPs) the grouped matmul must move and do: every xs row
        read and every output row written once, each expert that a row
        block names (the trailing padding's included) read once, the
        products of the valid rows."""
        n_rows = pl.src.shape[0]
        n_exp = int(torch.unique(pl.block_expert).numel())
        return ((n_rows * K + n_exp * K * H + n_rows * H) * 2,
                2.0 * int(pl.valid.sum()) * K * H)

    mm_lib = grouped_mm_ms(xs, be, w1)
    record("ragged_expert_matmul", src + "ragged_dispatch.cu",
           tpu + "ragged_dispatch.py:189", mm_err,
           time_ms(lambda: ragged_expert_matmul(xs, be, w1)),
           time_ms(lambda: ref.ragged_expert_matmul_ref(xs, be, w1)),
           *matmul_cost(plan, DM, DE), BF16_FLOPS, library_ms=mm_lib,
           library_what="torch._grouped_mm, no LoRA")

    eo = randn(N, DM)
    got = ragged_combine(eo, plan.rows, plan.wrank)
    err = close_16bit(got, ref.ragged_combine_ref(eo, plan.rows, plan.wrank),
                     "ragged_combine")
    record("ragged_combine", src + "ragged_dispatch.cu",
           tpu + "ragged_dispatch.py:248", err,
           time_ms(lambda: ragged_combine(eo, plan.rows, plan.wrank)),
           time_ms(lambda: ref.ragged_combine_ref(eo, plan.rows, plan.wrank)),
           *combine_cost(plan), F32_FLOPS)
    del xs, eo, x, la, lb

    # the serving path's other shapes, each with the trio held against its
    # plain version (the matmul in bf16 and fp16, the gather and the
    # combine also in float32) and timed (bf16): the decode step (8
    # slots at tiers 8,8,4,4,2,2,1,1), each prefill group of the serving
    # phase (one request per call, checked there: T = 128 or 256 prompt
    # tokens at k = 8, 4, 2, 1), and a skewed plan where every token picks
    # the same 8 experts (runs of 256 rows, 56 experts empty)
    prompt_lens = (128, 256)
    shapes = [("decode", 8, None)]
    shapes += [(f"prefill T={L} k={kk}", L, kk) for L in prompt_lens
               for kk in sorted(set(slot_k), reverse=True)]
    shapes += [("skewed T=256 k=8", 256, "skewed")]

    def ragged_shape(name, Ts, kk):
        """The trio at one shape: checked in bf16 and fp16 (the gather
        and the combine also in float32), timed in bf16, one line of kernel
        ms, bounds, torch._grouped_mm and torch.index_select ms."""
        if kk is None:
            w_s, m_s, _ = ref.adaptive_topk_router_ref(
                randn(Ts, E, scale=0.5), torch.tensor(slot_k, device=dev), 8)
            pl = ragged_plan(m_s, w_s, budget=sum(slot_k), max_k=8)
            Tk = sum(slot_k)
        else:
            lg = randn(Ts, E, scale=0.5)
            if kk == "skewed":
                lg = lg[:1].expand(Ts, E).contiguous()
                kk = 8
            w_s, m_s, _ = topk_router(lg, kk)
            pl = ragged_plan(m_s, w_s, budget=Ts * kk, max_k=kk)
            Tk = Ts * kk
        n_rows = pl.src.shape[0]
        xt = randn(Ts, DM)
        xs_s = ragged_gather(xt, pl.src, pl.valid)
        hs = randn(n_rows, DE)
        eos = randn(n_rows, DM)
        errs = []
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            dn = str(dtype).split(".")[1]
            x_ = xt.to(dtype)
            check(torch.equal(ragged_gather(x_, pl.src, pl.valid),
                              ref.ragged_gather_ref(x_, pl.src, pl.valid)),
                  f"ragged_gather {dn} {name} differs from the plain version")
            if dtype != torch.float32:
                for what, xin, wt in (("w1/w3", xs_s, w1), ("w2", hs, w2)):
                    a_ = (xin.to(dtype), pl.block_expert, wt.to(dtype))
                    errs.append(close_16bit(
                        ragged_expert_matmul(*a_),
                        ref.ragged_expert_matmul_ref(*a_),
                        f"ragged_expert_matmul {dn} {what} {name}"))
            e_ = eos.to(dtype)
            errs.append(close_any(
                ragged_combine(e_, pl.rows, pl.wrank),
                ref.ragged_combine_ref(e_, pl.rows, pl.wrank),
                f"ragged_combine {dn} {name}"))
        ms = {"gather": time_ms(lambda: ragged_gather(xt, pl.src, pl.valid)),
              "w1/w3": time_ms(lambda: ragged_expert_matmul(
                  xs_s, pl.block_expert, w1)),
              "w2": time_ms(lambda: ragged_expert_matmul(
                  hs, pl.block_expert, w2)),
              "combine": time_ms(lambda: ragged_combine(eos, pl.rows,
                                                        pl.wrank))}
        lib_ = {"w1/w3": grouped_mm_ms(xs_s, pl.block_expert, w1),
                "w2": grouped_mm_ms(hs, pl.block_expert, w2),
                "gather": time_ms(lambda: torch.index_select(xt, 0, pl.src)),
                "combine": None}
        bnd = {"w1/w3": bound_ms(*matmul_cost(pl, DM, DE), BF16_FLOPS)[0],
               "w2": bound_ms(*matmul_cost(pl, DE, DM), BF16_FLOPS)[0],
               "gather": bound_ms(*gather_cost(pl), F32_FLOPS)[0],
               "combine": bound_ms(*combine_cost(pl), F32_FLOPS)[0]}
        lib_name = {"w1/w3": "grouped_mm", "w2": "grouped_mm",
                    "gather": "index_select", "combine": "library"}
        n_exp = int(torch.unique(pl.block_expert).numel())
        print(f"ragged shape {name} (T·k={Tk}, N={n_rows} rows, "
              f"{pl.block_expert.shape[0]} row blocks, {n_exp} experts): "
              f"max_abs_err {max(errs):.3e}; ms: "
              + ", ".join(
                  f"{k} {v:.4f} (bound {bnd[k]:.4f}, {lib_name[k]} "
                  + ("none" if lib_[k] is None else f"{lib_[k]:.4f}") + ")"
                  for k, v in ms.items())
              + f"; empty kernel {floor_ms:.4f}")

    for name, Ts, kk in shapes:
        ragged_shape(name, Ts, kk)
    del w1, w2

    # ------------------------------------------------ 2d. LoRA matmuls
    # ragged edges (odd M, C = 41, r in {4, 20}, scale != 1) in fp32 (the
    # FMA kernel), bf16 and fp16 (the tensor-core kernel), then the
    # training round's shapes at OLMoE FULL: the attention
    # projections (M = 16·128 tokens, K = N = 2048, r = 20) and the expert
    # w1/w3 (2048 -> 1024) and w2 (1024 -> 2048) at k = 8 (C = 328)
    def lora_ops(lead, M, K, N, r, dtype, a_scale=1.0):
        return (randn(*lead, M, K, dtype=dtype),
                randn(*lead, K, N, scale=K ** -0.5, dtype=dtype),
                randn(*lead, K, r, scale=K ** -0.5, dtype=dtype),
                randn(*lead, r, N, scale=0.5 * a_scale, dtype=dtype))

    lora_errs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype).split(".")[1]
        for M, K, N, r, sc in ((37, 100, 77, 4, 1.7), (2047, 2048, 2048, 20,
                                                       0.8),
                               (2048, 2048, 2048, 20, 1.25)):
            ops = lora_ops((), M, K, N, r, dtype)
            err = close_any(lora_matmul(*ops, scale=sc),
                            ref.lora_matmul_ref(*ops, sc),
                            f"lora_matmul {dn} {M}x{K}x{N} r{r}")
            print(f"lora_matmul check {dn} M={M} K={K} N={N} r={r} "
                  f"scale={sc}: max_abs_err {err:.3e}")
            lora_errs[("lora_matmul", dn, M)] = err
        for E_, C, K, N, r, sc in ((3, 41, 100, 70, 4, 0.6),
                                   (64, 41, 1024, 2048, 20, 1.25),
                                   (64, 328, 2048, 1024, 20, 1.25)):
            ops = lora_ops((E_,), C, K, N, r, dtype)
            err = close_any(lora_matmul_experts(*ops, scale=sc),
                            ref.lora_matmul_experts_ref(*ops, sc),
                            f"lora_matmul_experts {dn} E{E_} C{C} {K}->{N}")
            print(f"lora_matmul_experts check {dn} E={E_} C={C} K={K} N={N} "
                  f"r={r} scale={sc}: max_abs_err {err:.3e}")
            lora_errs[("lora_matmul_experts", dn, C)] = err

    R_ = 20
    xq, wq_, aq, bq = lora_ops((), 2048, DM, DM, R_, torch.bfloat16)
    record("lora_matmul", src + "lora_matmul.cu",
           tpu + "lora_matmul.py:63", lora_errs[("lora_matmul", "bfloat16",
                                                 2048)],
           time_ms(lambda: lora_matmul(xq, wq_, aq, bq, scale=1.25)),
           time_ms(lambda: ref.lora_matmul_ref(xq, wq_, aq, bq, 1.25)),
           2 * (2 * 2048 * DM + DM * DM + DM * R_ + R_ * DM),
           2.0 * 2048 * DM * (DM + 2 * R_), BF16_FLOPS,
           library_ms=time_ms(lambda: torch.matmul(xq, wq_)),
           library_what="torch.matmul(x, W), base product only")
    del xq, wq_, aq, bq
    xe, we, ae, be_ = lora_ops((E,), 328, DM, DE, R_, torch.bfloat16)
    record("lora_matmul_experts", src + "lora_matmul.cu",
           tpu + "lora_matmul.py:101",
           lora_errs[("lora_matmul_experts", "bfloat16", 328)],
           time_ms(lambda: lora_matmul_experts(xe, we, ae, be_, scale=1.25)),
           time_ms(lambda: ref.lora_matmul_experts_ref(xe, we, ae, be_,
                                                       1.25)),
           2 * E * (328 * DM + DM * DE + DM * R_ + R_ * DE + 328 * DE),
           2.0 * E * 328 * (DM * DE + DM * R_ + R_ * DE), BF16_FLOPS,
           library_ms=time_ms(lambda: torch.bmm(xe, we)),
           library_what="torch.bmm(x, W), base product only")
    del xe, we, ae, be_
    # the expert kernel at each tier's capacity (k = 8, 4, 2, 1 at 2048
    # tokens): w1/w3 (2048 -> 1024) and w2 (1024 -> 2048), for the
    # training phase's share estimate
    def expert_bound(C, K, N, r):
        return bound_ms(2 * E * (C * K + K * N + K * r + r * N + C * N),
                        2.0 * E * C * (K * N + K * r + r * N), BF16_FLOPS)

    expert_ms = {}
    for kk, C in ((8, 328), (4, 168), (2, 88), (1, 48)):
        t13 = lora_ops((E,), C, DM, DE, R_, torch.bfloat16)
        t2 = lora_ops((E,), C, DE, DM, R_, torch.bfloat16)
        errs = [close_16bit(lora_matmul_experts(*t, scale=1.25),
                            ref.lora_matmul_experts_ref(*t, 1.25),
                            f"lora_matmul_experts bf16 k={kk} C={C} {what}")
                for what, t in (("w1/w3", t13), ("w2", t2))]
        print(f"lora_matmul_experts check bf16 k={kk} C={C}: max_abs_err "
              f"w1/w3 {errs[0]:.3e}, w2 {errs[1]:.3e}")
        expert_ms[kk] = (time_ms(lambda: lora_matmul_experts(*t13,
                                                             scale=1.25)),
                         time_ms(lambda: lora_matmul_experts(*t2,
                                                             scale=1.25)))
        del t13, t2
    print("lora_matmul_experts ms by tier (k: C, w1/w3 ms (bound), w2 ms "
          "(bound)): " + ", ".join(
              f"k={kk}: C={C} {expert_ms[kk][0]:.4f} "
              f"({expert_bound(C, DM, DE, R_)[0]:.4f}) {expert_ms[kk][1]:.4f} "
              f"({expert_bound(C, DE, DM, R_)[0]:.4f})"
              for kk, C in ((8, 328), (4, 168), (2, 88), (1, 48))))
    flush.clear()
    torch.cuda.empty_cache()

    # ------------------------------------------------ 3. backward wrappers
    backward_phase(torch, backend, ref, dev, check)
    ragged_loss_grads(torch, dev, check)

    # ------------------------------------------------ 4. serving, FULL
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
    engine.run(requests(8, prompt_lens, 2))         # warm-up (cuBLAS, build)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    report = engine.run(requests(16, prompt_lens, 16))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    summ = report.summary()
    check(summ["n_requests"] == 16 and summ["gen_tokens"] == 16 * 16,
          f"served {summ['n_requests']} requests / {summ['gen_tokens']} tokens")
    for c in report.completions:
        check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
              f"request {c.rid}: token ids out of range")
    # the serving path's five kernels; the LoRA matmuls belong to training
    # (serving here carries no adapters)
    for name, n in launches.items():
        if name.startswith("lora"):
            check(n == 0, f"the serving run launched {name}")
        else:
            check(n > 0, f"kernel {name} was not launched by the serving run")
    n_prefill, n_decode = len(report.prefill_s), summ["decode_steps"]
    # every prefill call took one request, so the kernel phase's prefill
    # shapes (T = 128 or 256 prompt tokens at each tier) were this run's
    check(n_prefill == summ["n_requests"],
          f"{n_prefill} prefill calls for {summ['n_requests']} requests")
    # each MoE layer routes once per call: prefill at its static k, every
    # decode step at per-slot budgets (no plain router on the card)
    L = cfg.num_layers
    check(launches["topk_router"] == L * n_prefill,
          f"topk_router launched {launches['topk_router']} times for "
          f"{n_prefill} prefill calls x {L} layers")
    check(launches["adaptive_topk_router"] == L * n_decode,
          f"adaptive_topk_router launched "
          f"{launches['adaptive_topk_router']} times for {n_decode} decode "
          f"steps x {L} layers")
    print(f"serving: {summ['gen_tokens']} tokens in {summ['wall_s']:.3f} s, "
          f"{summ['gen_tokens_per_s']:.1f} tokens/s, "
          f"TTFT p50 {summ['ttft_p50_ms']:.1f} ms, decode step p50 "
          f"{summ['decode_step_ms_p50']:.2f} ms (mean "
          f"{summ['decode_step_ms_mean']:.2f} ms, {n_decode} steps), "
          f"{n_prefill} prefill calls (p50 "
          f"{float(np.median(report.prefill_s)) * 1e3:.1f} ms), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    print(f"serving launches: {json.dumps(launches)}")
    del engine
    torch.cuda.empty_cache()

    # ------------------------------------------------ 5. training, FULL
    train_launches, fed_adapter = training_phase(
        torch, cfg, params, dev, check, expert_ms,
        {r["name"]: r["ms"] for r in rows})
    # launches: the router's two entries, flash and the ragged trio from
    # the serving run (their path), the LoRA matmuls from the training
    # round (theirs); both runs' counters are printed
    for row in rows:
        row["launches"] = (train_launches if row["name"].startswith("lora")
                           else launches)[row["name"]]
    torch.cuda.empty_cache()

    # ------------------------------------------------ 6. end to end vs CPU
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
    del pc, pg, lg, lc

    train_e2e_phase(torch, cfg2, dev, check)

    # ------------------------------------------------ 7-9. resume, baselines,
    #                                                    round memory
    p2 = model_lib.init_params(cfg2, torch.Generator(device=dev).manual_seed(7),
                               dev)
    resume_phase(torch, cfg2, p2, dev, check)
    baselines_phase(torch, cfg2, p2, dev, check)
    memory_phase(torch, cfg2, p2, dev, check)
    del p2
    torch.cuda.empty_cache()

    # ------------------------------------------------ 10. traffic
    t0 = time.perf_counter()
    kc = {"close": close_any, "router": router_check, "time_ms": time_ms}
    traffic_launches, n_prefill, n_decode = traffic_phase(
        torch, cfg, params, dev, check, kc)
    # the serving path's kernels carried the traffic: flash for every
    # prefill call (cold, and suffix over the attached pages), the static
    # router for prefill, the per-token-budget router for decode (and for
    # suffix groups whose rows differ in length), and the ragged trio;
    # every layer attended and routed once per engine call
    for name, n in traffic_launches.items():
        if name.startswith("lora"):
            check(n == 0, f"the traffic run launched {name}")
        else:
            check(n > 0, f"kernel {name} was not launched by the traffic run")
    check(traffic_launches["flash_attention"] == L * n_prefill,
          f"traffic: flash_attention launched "
          f"{traffic_launches['flash_attention']} times for {n_prefill} "
          f"prefill calls (cold and suffix) x {L} layers")
    check(traffic_launches["topk_router"]
          + traffic_launches["adaptive_topk_router"]
          == L * (n_prefill + n_decode),
          f"traffic: {traffic_launches['topk_router']} static + "
          f"{traffic_launches['adaptive_topk_router']} per-token router "
          f"launches for {n_prefill} prefill calls and {n_decode} decode "
          f"steps x {L} layers")
    for row in rows:
        row["traffic_launches"] = traffic_launches[row["name"]]
    preemption_phase(torch, cfg, params, dev, check)
    traffic_fp32_phase(torch, cfg2, dev, check, kc)
    print(f"traffic phase: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------ 11. speculative
    t0 = time.perf_counter()
    spec_launches, _ = speculative_phase(torch, cfg, params, dev, check, kc)
    # the speculative path's kernels: the static router for prefill and
    # every draft step (k = 1), the per-token-budget router for every
    # verify step, flash for prefill, the ragged trio throughout
    for row in rows:
        row["spec_launches"] = spec_launches[row["name"]]
    speculative_fp32_phase(torch, cfg2, dev, check, kc)
    print(f"speculative phase: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------ 12. LoRA serving
    t0 = time.perf_counter()
    lora_launches, lt, lora_err, onehot_launches = lora_serving_phase(
        torch, cfg, params, dev, check, kc, fed_adapter)
    del params, fed_adapter
    torch.cuda.empty_cache()
    # the two LoRA routes of the serving path, timed at layer 0 of the
    # decode step (their launches: the unmerged run's, every one of them
    # with the adapter); the prefill step's times are printed beside
    for part in ("decode", "prefill"):
        print(f"lora kernel times, {part} step layer 0 (bf16): " + "; ".join(
            f"{n} {ms:.4f} ms (plain {pl:.4f}, bound "
            f"{bound_ms(nb, fl, BF16_FLOPS)[0]:.4f} by "
            f"{bound_ms(nb, fl, BF16_FLOPS)[1]}, library "
            f"{'none' if lib is None else f'{lib:.4f}'})"
            for n, (ms, pl, nb, fl, lib) in lt[part].items()))
    for name, key, replaces, kname, what in (
            ("ragged_expert_matmul (LoRA route, decode)", "ragged w1",
             "ragged_dispatch.py:175", "ragged_expert_matmul",
             "torch._grouped_mm, base product only"),
            ("lora_matmul (serving, decode M=8)", "lora_matmul",
             "lora_matmul.py:63", "lora_matmul",
             "torch.matmul(x, W), base product only")):
        ms, pl, nb, fl, lib = lt["decode"][key]
        record(name, src + ("ragged_dispatch.cu" if "ragged" in kname
                            else "lora_matmul.cu"), tpu + replaces,
               lora_err[kname], ms, pl, nb, fl, BF16_FLOPS, library_ms=lib,
               library_what=what)
        rows[-1]["launches"] = lora_launches[kname]
    # lora_matmul_experts at the one-hot modes' serving shapes (layer 0's
    # w1); the row's launches: the bf16 dense run's
    for key in ("dense prefill", "dense decode", "capacity prefill",
                "capacity decode"):
        ms, pl, nb, fl, lib = lt[key]
        b_ms, b_by = bound_ms(nb, fl, BF16_FLOPS)
        print(f"lora_matmul_experts, {key} step layer 0 w1 (bf16): "
              f"{ms:.4f} ms (plain {pl:.4f}, bound {b_ms:.4f} by {b_by}, "
              f"library torch.bmm {lib:.4f})")
    ms, pl, nb, fl, lib = lt["dense decode"]
    record("lora_matmul_experts (serving, dense decode)",
           src + "lora_matmul.cu", tpu + "lora_matmul.py:101",
           lora_err["dense lora_matmul_experts"], ms, pl, nb, fl, BF16_FLOPS,
           library_ms=lib, library_what="torch.bmm(x, W), base product only")
    rows[-1]["launches"] = onehot_launches["dense"]
    rows[-1]["capacity_launches"] = onehot_launches["capacity"]
    lora_fp32_phase(torch, cfg2, dev, check, kc)
    print(f"LoRA serving phase: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------ 13. archs
    t0 = time.perf_counter()
    rows += archs_phase(torch, dev, check, kc)
    print(f"archs phase: {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------ 14. train step
    rows.append(train_step_phase(torch, dev, check, kc))

    # ------------------------------------------------ 15-16. device round
    #                                    driver, sliding-window swa variant
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    device_driver_phase(torch, cfg, params, dev, check)
    cfg_swa = get_config("olmoe-1.3b-6.9b", "swa")
    check(cfg_swa == cfg.replace(attention_window=8192),
          "the swa variant is not FULL with an 8192-token window")
    rows.append(swa_phase(torch, cfg_swa, params, dev, check, kc))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------ 17. SSM and hybrid
    rows += ssm_phase(torch, dev, check, kc)

    # ------------------------------------------------ 19. audio codebooks,
    #                                                    logit softcap
    gc.collect()
    torch.cuda.empty_cache()
    rows += audio_softcap_phase(torch, dev, check, kc)

    # ------------------------------------------------ 21-22. the card mesh,
    #                                     act_mode and the dry run
    rows += mesh_phase(torch)

    # ------------------------------------------------ 20. summary
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


ARCH_ORDER = ("olmo-1.3b", "qwen3-1.7b", "phi4-mini-3.8b", "qwen2-moe-a2.7b",
              "granite-20b", "chameleon-34b")
ARCH_MOE_SLOTS = (4, 4, 2, 2, 1, 1, 1, 1)
ARCH_RESERVE = 6 * 2 ** 30       # activations, workspaces, a flush buffer


def _row(name, source, replaces, err, ms, plain_ms, bound, library_ms,
         launches, library_what=None):
    """A ``kernels`` line entry, printed as ``record`` prints one;
    ``bound``: ``bound_ms``'s (ms, "bytes" | "operations")."""
    b_ms, b_by = bound
    lib = "-" if library_ms is None else f"{library_ms:.4f}"
    if library_what:
        lib += f" ({library_what})"
    print(f"kernel {name}: max_abs_err {err:.3e}, {ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms, library {lib} ms, bound {b_ms:.4f} ms by "
          f"{b_by}), {launches} launches")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + source,
            "replaces": "src/repro/kernels/" + replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def _fit_depth(torch, cfg, num_slots, slot_len, reserve=ARCH_RESERVE):
    """The largest depth <= num_layers, in whole periods of the layer
    pattern, at which the weights, the KV pool (``num_slots`` x
    ``slot_len`` tokens of K/V at each attention layer, a state row per
    slot at each Mamba layer) and ``reserve`` fit in the card's free
    memory; (depth, bytes a period, bytes outside the stack)."""
    from repro_torch.launch.steps import abstract_params, state_bytes
    from repro_torch.models.mamba2 import mamba_dims
    P = cfg.pattern_period
    one = state_bytes(abstract_params(cfg.replace(num_layers=P)))
    per_period = state_bytes(abstract_params(
        cfg.replace(num_layers=2 * P))) - one
    n_attn = sum(cfg.layer_kind(j) == "attn" for j in range(P))
    cache = n_attn * 2 * num_slots * slot_len * cfg.n_kv_heads \
        * cfg.head_dim_ * 2
    if n_attn < P:
        d = mamba_dims(cfg)
        cache += (P - n_attn) * num_slots * 4 * (
            d["conv_dim"] * (d["conv_width"] - 1)
            + d["n_heads"] * d["head_dim"] * d["d_state"])
    free, _ = torch.cuda.mem_get_info()
    fit = int((free - reserve - (one - per_period)) // (per_period + cache))
    return min(cfg.num_layers, fit * P), per_period, one - per_period


def _ragged_mm_plain(torch, xs, be, w, *lora, **kw):
    """``ref.ragged_expert_matmul_ref`` over runs of at most 1 GiB of fp32
    gathered weights: the plain version forms one fp32 copy of an
    expert's W per row block, 17.5 GiB for a 256-token prefill at Jamba's
    4096 x 14,336 experts.  Row blocks are independent, so the chunks
    concatenate to the plain version's output."""
    from repro_torch.kernels import ref
    nb = be.shape[0]
    bm = xs.shape[0] // nb
    step = max(1, 2 ** 30 // (w.shape[1] * w.shape[2] * 4))
    return torch.cat([ref.ragged_expert_matmul_ref(
        xs[i * bm:(i + step) * bm], be[i:i + step], w, *lora, **kw)
        for i in range(0, nb, step)])


def _arch_requests(cfg, tiers, n=8, new=16, seed=0):
    """8 requests of 128/256-token prompts in turn at the tiers in turn
    (no budget for a dense arch), ``new`` new tokens, seeded."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, ((128, 256)[i % 2],)).astype(np.int32),
        max_new_tokens=new, k=tiers[i % len(tiers)] if tiers else None)
        for i in range(n)]


def _arch_step_calls(torch, cfg, params, tiers, check, what, lora=None):
    """Every kernel call of one prefill call (one 256-token prompt) and of
    one decode step (8 busy slots) on the engine of the archs phase
    (serving ``lora`` unmerged when given).  Returns (prefill calls,
    decode calls)."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import ServingReport
    eng = ServingEngine(cfg, params, lora=lora, num_slots=8, slot_len=512,
                        slot_k=tiers, block_size=16)
    report = ServingReport(completions=[])
    eng._t0 = time.perf_counter()
    reqs = _arch_requests(cfg, tiers, n=8, new=4, seed=5)
    check(reqs[1].prompt_len == 256, f"{what}: request 1 not 256 tokens")
    with torch.inference_mode():
        eng.scheduler.add(reqs[1])
        _, pre = _recorded(torch, lambda: eng._admit(report))
        for r in reqs[:1] + reqs[2:]:
            eng.scheduler.add(r)
        eng._admit(report)
        check(eng.n_active == 8, f"{what}: {eng.n_active} slots busy")
        _, dec = _recorded(torch, lambda: eng._decode_once(report))
        while eng.n_active:
            eng._decode_once(report)
    if eng.paged:
        eng.pool.check_invariants()
        check(eng.pool.blocks_in_use == 0,
              f"{what}: blocks held after the run")
    return pre, dec


def _check_arch_calls(torch, cfg, calls, check, kc, what, prefill, T,
                      n_lora=0):
    """Each recorded call of one engine call against its plain version at
    every layer: flash once per attention layer at prefill; an MoE
    layer's router (static at prefill, per-token at decode) at ``T``
    tokens and the ragged trio once (the grouped matmul three times);
    ``n_lora`` ``lora_matmul`` calls (an unmerged adapter's projections);
    a Mamba layer or a dense FFN none.  Routers exact (weights within
    1e-6), the gather exact, the rest within ``kc["close"]``.  Returns
    {name: max err}."""
    from repro_torch.kernels import ref
    close = kc["close"]
    L = cfg.num_layers
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(L))
    n_moe = sum(cfg.layer_is_moe(i) for i in range(L))
    names = [c[0] for c in calls]
    want_n = {"flash_attention": n_attn if prefill else 0}
    if cfg.moe.enabled:
        want_n.update({("router" if prefill else "adaptive_router"): n_moe,
                       "ragged_gather": n_moe, "ragged_combine": n_moe,
                       "ragged_expert_matmul": 3 * n_moe})
    if n_lora:
        want_n["lora_matmul"] = n_lora
    for name, n in want_n.items():
        check(names.count(name) == n, f"{what}: {names.count(name)} {name} "
              f"calls, not {n}")
    check(len(names) == sum(want_n.values()), f"{what}: other calls "
          f"{sorted(set(names) - set(want_n))}")
    worst = {}
    for name, a, kw, out in calls:
        tag = f"{what} {name}"
        if name == "flash_attention":
            q, k, v = (t.transpose(1, 2) for t in a)
            check(q.shape[1] == cfg.n_heads and k.shape[1] == cfg.n_kv_heads,
                  f"{tag}: heads {q.shape[1]}/{k.shape[1]}")
            err = close(out, ref.flash_attention_ref(
                q, k, v, causal=kw["causal"], window=kw["window"],
                softcap=kw["softcap"]).transpose(1, 2), tag)
        elif name in ("router", "adaptive_router"):
            check(a[0].shape == (T, cfg.moe.num_experts),
                  f"{tag} at {tuple(a[0].shape)}")
            plain = (ref.topk_router_ref if name == "router"
                     else ref.adaptive_topk_router_ref)
            err = kc["router"](out, plain(*a), tag)
        elif name == "ragged_gather":
            check(torch.equal(out, ref.ragged_gather_ref(*a)),
                  f"{tag} differs from the plain version")
            err = 0.0
        elif name == "ragged_expert_matmul":
            err = close(out, _ragged_mm_plain(torch, *a, **kw), tag)
        elif name == "lora_matmul":
            err = close(out, ref.lora_matmul_ref(*a, kw["scale"]), tag)
        else:
            err = close(out, ref.ragged_combine_ref(*a), tag)
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


_FLEX = {}


def _flex_call(torch, q, k, v, causal, window, softcap):
    """torch's ``flex_attention``, compiled at fixed shapes, on (B, H, S, D)
    inputs: the cap as a ``score_mod`` (``softcap·tanh(s / softcap)`` after
    the scale), the causal band as a ``block_mask``.  The library call that
    computes a capped or windowed flash.  Returns it without arguments."""
    from torch.nn.attention import flex_attention as fa
    if "fn" not in _FLEX:
        import torch._inductor.config as inductor
        inductor.compile_threads = 1      # no compile workers to outlive us
        _FLEX["fn"] = torch.compile(fa.flex_attention, dynamic=False)
    S = q.shape[2]

    def band(b, h, qi, ki):
        keep = qi >= ki
        return keep & (qi - ki < window) if window > 0 else keep

    def cap(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    mask = (fa.create_block_mask(band, None, None, S, S, device=q.device)
            if causal else None)
    gqa = k.shape[1] != q.shape[1]
    return lambda: _FLEX["fn"](q, k, v, score_mod=cap if softcap > 0
                               else None, block_mask=mask, enable_gqa=gqa)


def _time_flash(torch, call, kc):
    """A recorded flash call ((B, S, H, D) model layout): (ms, plain ms,
    bytes, FLOPs, library ms, library name).  The FLOPs: 4·D on the tensor
    cores for each (query, key) pair the causal mask and the window keep,
    and with a cap its two fp32 operations a pair at their bf16-peak
    equivalent.  The library: SDPA on contiguous (B, H, S, D) copies, or
    with a cap or a window compiled ``flex_attention``, first held
    against the plain version (``kc["close"]``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import backend, ref
    t = kc["time_ms"]
    (q, k, v), kw = call[1], call[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    B, H, S, D = qt.shape
    KV = kt.shape[1]
    w, cap = kw.get("window", 0), kw.get("softcap", 0.0)
    pairs = (S * (S + 1) // 2 if w <= 0 or w >= S
             else w * (w + 1) // 2 + (S - w) * w)
    flops = 4.0 * D * B * H * pairs
    if cap > 0:
        flops += 2.0 * B * H * pairs * BF16_FLOPS / F32_FLOPS
    qc, kc_, vc = (x.contiguous() for x in (qt, kt, vt))
    if cap > 0 or 0 < w < S:
        lib = _flex_call(torch, qc, kc_, vc, kw.get("causal", True), w, cap)
        what = (f"flex_attention, compiled{'; tanh score_mod' if cap else ''}"
                f"{'; band block_mask' if 0 < w < S else '; causal block_mask'}")
        kc["close"](lib(), ref.flash_attention_ref(qt, kt, vt, **kw),
                    f"{what} B={B} S={S} H={H} D={D}")
    else:
        what = "scaled_dot_product_attention"

        def lib():
            return F.scaled_dot_product_attention(
                qc, kc_, vc, is_causal=True, enable_gqa=KV != H)
    return (t(lambda: backend.flash_attention(q, k, v, **kw)),
            t(lambda: ref.flash_attention_ref(qt, kt, vt, **kw)),
            (2 * B * H * S * D + 2 * B * KV * S * D) * q.element_size(),
            flops, t(lib), what)


def _lora_shape_rows(torch, dev, kc, what, shapes, launches, seed,
                     scale, backward=False):
    """``lora_matmul`` at training shapes ``(M, K, N, r, name)``, bf16:
    held against its plain version (close_16bit), timed beside its bound
    and the library's base product, and with ``backward`` its training
    backward (dx, dA, dB, the reference's fp32 rules) timed.  Returns the
    rows, each with ``launches``."""
    from repro_torch.kernels import backend, ref
    t = kc["time_ms"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows, sc = [], scale

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    for M, K, N, r, name in shapes:
        x, w = randn(M, K), randn(K, N, scale=K ** -0.5)
        a, b = randn(K, r, scale=K ** -0.5), randn(r, N, scale=0.5)
        err = kc["close"](backend.lora_matmul(x, w, a, b, scale=sc),
                          ref.lora_matmul_ref(x, w, a, b, sc),
                          f"lora_matmul {what} {name} {K}->{N} r={r}")
        if backward:
            xg, ag, bg = (u.clone().requires_grad_(True) for u in (x, a, b))
            y = backend.lora_matmul(xg, w, ag, bg, scale=sc)
            g = randn(M, N)
            bwd = t(lambda: torch.autograd.grad(y, (xg, ag, bg), g,
                                                retain_graph=True))
            print(f"lora_matmul backward {K}->{N} r={r} M={M} (dx, dA, dB; "
                  f"the reference's fp32 rules, plain PyTorch): {bwd:.4f} ms")
            del xg, ag, bg, y, g
        rows.append(_row(
            f"lora_matmul ({what} {name} {K}->{N}, r={r}, M={M})",
            "lora_matmul.cu", "lora_matmul.py:63", err,
            t(lambda: backend.lora_matmul(x, w, a, b, scale=sc)),
            t(lambda: ref.lora_matmul_ref(x, w, a, b, sc)),
            bound_ms(2 * (M * K + K * N + K * r + r * N + M * N),
                     2.0 * M * (K * N + K * r + r * N), BF16_FLOPS),
            t(lambda: torch.matmul(x, w)), launches,
            "torch.matmul(x, W), base product only"))
        del x, w, a, b
    return rows


def _arch_train_round(torch, cfg, params, dev, check):
    """OLMo-1.3B FULL: one HLoRA round (the dense rank grid) of 4 clients
    with the FFN adapters, the default batched engine; returns the
    round's launch counts."""
    from repro_torch.configs import FederatedConfig, TrainConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.federated import client as client_lib
    from repro_torch.federated.server import DENSE_BUDGET_RANKS
    from repro_torch.federated.simulation import build_experiment
    from repro_torch.kernels import _build
    fed = FederatedConfig(num_clients=4, rounds=1, method="hlora")
    tc = TrainConfig()
    exp = build_experiment(cfg, fed=fed, tc=tc,
                           data=DataConfig(vocab_size=512, n_examples=200,
                                           seq_len=128),
                           base_params=params, device=dev)
    server = exp.server
    check([c.rank for c in server.clients] == list(
        DENSE_BUDGET_RANKS.values()), "client ranks are not 40/24/16/12")
    ffn = server.global_lora["blocks"]["pos0"]["ffn"]
    check(set(ffn) == {"w1", "w2", "w3"}, "no FFN adapters")
    steps = sum(client_lib.make_batch_plan(c, tc, fed.seed * 1000).n_steps
                for c in server.clients)
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = server.run_round(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(all(np.isfinite(res.client_losses)),
          f"OLMo round losses {res.client_losses}")
    check(launches["lora_matmul"] > 0 and launches["flash_attention"] > 0,
          f"OLMo round launches {launches}")
    for name, n in launches.items():
        if name not in ("lora_matmul", "flash_attention"):
            check(n == 0, f"the dense round launched {name}")
    print(f"archs olmo-1.3b training: one HLoRA round, clients (rank, "
          f"examples) " + ", ".join(f"({c.rank}, {c.dataset_size})"
                                     for c in server.clients)
          + f", {steps} steps in {dt:.3f} s ({dt / max(steps, 1):.3f} s/"
          f"step), losses {[round(x, 4) for x in res.client_losses]}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"{json.dumps(launches)}")
    del exp, server
    return launches


def _arch_kernel_rows(torch, arch, cfg, params, tiers, launches, check,
                      kc):
    """Every kernel call of one prefill call and one decode step of an
    arch held against its plain version; the first attention layer's
    flash timed, and the first MoE layer's routers and ragged trio.
    Returns the ``kernels`` line's rows of the new shapes: flash at GQA
    24/8 (phi4-mini), MQA 48/1 (granite) and GQA 32/8 (jamba), the two
    router entries and the ragged trio of an MoE arch (E = 60, k = 4 on
    qwen2-moe; E = 16, k = 2 at 4096 <-> 14,336 on jamba), with the
    serving run's ``launches``."""
    pre, dec = _arch_step_calls(torch, cfg, params, tiers, check, arch)
    worst = {"prefill": _check_arch_calls(torch, cfg, pre, check, kc,
                                          f"{arch} prefill", True, 256),
             "decode": _check_arch_calls(torch, cfg, dec, check, kc,
                                         f"{arch} decode", False, 8)}
    print(f"archs {arch}: every kernel call of one prefill call (T=256) "
          f"and one decode step (8 slots), {cfg.num_layers} layers, against "
          "its plain version; max |kernel - plain|: " + "; ".join(
              f"{part} " + (", ".join(f"{n} {e:.3e}" for n, e in w.items())
                            or "no kernel") for part, w in worst.items()))
    rows = []
    f_ms, f_pl, f_nb, f_fl, f_lib, f_what = _time_flash(
        torch, next(c for c in pre if c[0] == "flash_attention"), kc)
    shape = f"H={cfg.n_heads} KV={cfg.n_kv_heads} S=256 B=1 D={cfg.head_dim_}"
    kind = {"phi4-mini-3.8b": "GQA 3", "granite-20b": "MQA",
            "jamba-v0.1-52b": "GQA 4"}.get(arch)
    if kind:
        rows.append(_row(f"flash_attention ({kind}, {arch} prefill, {shape})",
                         "flash_attention.cu", "flash_attention.py:92",
                         worst["prefill"]["flash_attention"], f_ms, f_pl,
                         bound_ms(f_nb, f_fl, BF16_FLOPS), f_lib,
                         launches["flash_attention"], f_what))
    else:
        print(f"archs {arch}: flash layer 0 ({shape}) {f_ms:.4f} ms (plain "
              f"{f_pl:.4f}, SDPA {f_lib:.4f}, bound "
              f"{bound_ms(f_nb, f_fl, BF16_FLOPS)[0]:.4f})")
    if not cfg.moe.enabled:
        return rows
    times = {"prefill": _time_layer0(
                 torch, [c for c in pre if c[0] != "flash_attention"][:6], kc),
             "decode": _time_layer0(torch, dec[:6], kc)}
    E, kk = cfg.moe.num_experts, cfg.moe.top_k
    for part, key, kname, replaces, what in (
            ("prefill", "router", "topk_router", "topk_router.py:59",
             f"T=256 k={kk}"),
            ("decode", "adaptive_router", "adaptive_topk_router",
             "topk_router.py:59", "T=8"),
            ("prefill", "ragged_gather", "ragged_gather",
             "ragged_dispatch.py:146", f"k={kk}"),
            ("prefill", "ragged_expert_matmul w1/w3", "ragged_expert_matmul",
             "ragged_dispatch.py:189",
             f"k={kk}, w1 {cfg.d_model}->{cfg.moe.d_expert}"),
            ("prefill", "ragged_combine", "ragged_combine",
             "ragged_dispatch.py:248", f"k={kk}")):
        ms, pl, b_ms, b_by, lib = times[part][key]
        rows.append(_row(f"{kname} (E={E}, {arch} {part} {what})",
                         "topk_router.cu" if "router" in key
                         else "ragged_dispatch.cu", replaces,
                         worst[part][key.split()[0]], ms, pl, (b_ms, b_by),
                         lib, launches[kname]))
    w2 = times["prefill"]["ragged_expert_matmul w2"]
    print(f"archs {arch}: grouped w2 ({cfg.moe.d_expert}->{cfg.d_model}) "
          f"{w2[0]:.4f} ms (bound {w2[2]:.4f}, grouped_mm "
          f"{'-' if w2[4] is None else f'{w2[4]:.4f}'})")
    return rows


def archs_phase(torch, dev, check, kc):
    """Phase 13: the registry's dense-FFN archs and the shared-expert MoE
    at full width, bf16, random seeded weights, one model on the card at a
    time.  Returns the new kernel rows."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as model_lib
    from repro_torch.serving import ServingEngine
    # earlier phases' engines and servers sit in reference cycles that
    # hold OLMoE's weights (and phase 12's merged copy) until collected
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    print(f"archs: {base / 2 ** 30:.2f} GiB allocated at the start")
    rows = []
    for i, arch in enumerate(ARCH_ORDER):
        t_arch = time.perf_counter()
        held = torch.cuda.memory_allocated() - base
        check(held < 2 ** 28, f"{arch}: {held / 2 ** 30:.2f} GiB more than "
              "at the phase's start still allocated before its model is "
              "built")
        full = get_config(arch, "full")
        depth, per_layer, outside = _fit_depth(torch, full, 8, 512)
        check(depth >= 1, f"{arch}: not one layer fits")
        cfg = full.replace(num_layers=depth)
        t0 = time.perf_counter()
        params = model_lib.init_params(
            cfg, torch.Generator(device=dev).manual_seed(100 + i), dev)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in _leaves(params))
        print(f"archs {arch}: depth {depth} of {full.num_layers} (a layer "
              f"{per_layer / 1e9:.3f} GB, embedding and head "
              f"{outside / 1e9:.3f} GB), {n_params / 1e9:.3f} B params "
              f"bf16, init {time.perf_counter() - t0:.1f} s")
        tiers = ARCH_MOE_SLOTS if cfg.moe.enabled else None
        eng = ServingEngine(cfg, params, num_slots=8, slot_len=512,
                            slot_k=tiers)
        eng.run(_arch_requests(cfg, tiers, n=2, new=2, seed=9))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        report = eng.run(_arch_requests(cfg, tiers))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        summ = report.summary()
        check(summ["n_requests"] == 8 and summ["gen_tokens"] == 8 * 16,
              f"{arch}: served {summ['n_requests']} requests / "
              f"{summ['gen_tokens']} tokens")
        for c in report.completions:
            check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size))
                       .all()), f"{arch} request {c.rid}: ids out of range")
        n_pre, n_dec, L = len(report.prefill_s), summ["decode_steps"], depth
        check(launches["flash_attention"] == L * n_pre,
              f"{arch}: flash launched {launches['flash_attention']} times "
              f"for {n_pre} prefill calls x {L} layers")
        if cfg.moe.enabled:
            check(launches["topk_router"] == L * n_pre and
                  launches["adaptive_topk_router"] == L * n_dec,
                  f"{arch}: router launches {launches}")
            for name in ("ragged_gather", "ragged_combine"):
                check(launches[name] == L * (n_pre + n_dec),
                      f"{arch}: {name} launched {launches[name]} times")
            check(launches["ragged_expert_matmul"] == 3 * L * (n_pre + n_dec),
                  f"{arch}: ragged_expert_matmul launches {launches}")
        for name, n in launches.items():
            if name.startswith("lora") or (not cfg.moe.enabled
                                           and name != "flash_attention"):
                check(n == 0, f"{arch}: the serving run launched {name}")
        print(f"archs {arch} serving: {summ['gen_tokens']} tokens in "
              f"{summ['wall_s']:.3f} s, {summ['gen_tokens_per_s']:.1f} "
              f"tokens/s, TTFT p50 {summ['ttft_p50_ms']:.1f} ms, decode step "
              f"p50 {summ['decode_step_ms_p50']:.2f} ms ({n_dec} steps), "
              f"{n_pre} prefill calls (p50 "
              f"{float(np.median(report.prefill_s)) * 1e3:.1f} ms), peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"launches {json.dumps(launches)}")
        del eng
        rows += _arch_kernel_rows(torch, arch, cfg, params, tiers, launches,
                                  check, kc)
        if arch == "olmo-1.3b":
            lm_launches = _arch_train_round(torch, cfg, params, dev, check)
            # OLMo-1.3B's FFN shapes in a training step (M = 16 x 128
            # tokens, r = 40) with the fp32 backward timed
            rows += _lora_shape_rows(
                torch, dev, kc, "OLMo-1.3B", [(2048, 2048, 8192, 40, "FFN"),
                                              (2048, 8192, 2048, 40, "FFN")],
                lm_launches["lora_matmul"], seed=11, scale=0.4, backward=True)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"archs {arch}: {time.perf_counter() - t_arch:.1f} s")
    return rows


def _plain_versions(torch, fn):
    """``fn()`` with every wrapper of ``kernels.backend`` running its plain
    version on the card (the device test sees no CUDA tensor)."""
    from repro_torch.kernels import backend
    orig = backend._on_cuda
    backend._on_cuda = lambda t: False
    try:
        return fn()
    finally:
        backend._on_cuda = orig


def train_step_phase(torch, dev, check, kc):
    """Phase 14: ``launch/steps.py`` on OLMo-1.3B FULL at train_4k's
    sequence length.  Returns the flash row at S = 4096."""
    import gc

    from repro_torch.configs import INPUT_SHAPES, ShapeConfig, get_config
    from repro_torch.core import lora as lora_lib
    from repro_torch.kernels import _build, backend
    from repro_torch.launch import steps
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adam
    t_phase = time.perf_counter()
    cfg = get_config("olmo-1.3b", "full")
    S = INPUT_SHAPES["train_4k"].seq_len
    B = 8
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(21), dev)
    lora = lora_lib.init_lora(torch.Generator(device=dev).manual_seed(22),
                              cfg, params)
    # b drawn off zero, so every adapter factor gets a gradient
    gen = torch.Generator(device=dev).manual_seed(23)
    for _, pair in _pairs(lora):
        pair["b"] = (torch.randn(pair["b"].shape, generator=gen, device=dev)
                     * 0.01).to(pair["b"].dtype)
    batch_gen = torch.Generator(device=dev).manual_seed(24)

    def run(bundle, shape):
        trainable = {"lora": lora}
        opt = adam.init(trainable)
        batch = synthetic_batch(cfg, shape, batch_gen, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        new_tr, new_opt, m = bundle.fn(params, trainable, opt, *batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        return (loss, new_opt, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(), dict(_build.LAUNCHES))

    one = ShapeConfig("train_4k_b1", S, 1, "train")
    on = steps.build_train(cfg, one, device=dev)
    off = steps.build_train(cfg, one, remat=False, remat_chunk=0, device=dev)
    run(on, one)                                   # warm-up
    batch_gen.manual_seed(24)
    l_off, _, t_off, p_off, _ = run(off, one)
    batch_gen.manual_seed(24)                      # the same batch
    l_on, _, t_on, p_on, _ = run(on, one)
    print(f"train step remat, B=1 S={S}: loss on {l_on:.6f} / off "
          f"{l_off:.6f}; peak on {p_on / 2 ** 30:.2f} GiB (chunk "
          f"{on.meta['remat_chunk']}) / off {p_off / 2 ** 30:.2f} GiB; "
          f"{t_on:.3f} / {t_off:.3f} s")
    check(abs(l_on - l_off) <= 1e-2 * abs(l_off),
          "remat changes the loss beyond bf16 tolerance")
    check(p_on < p_off, "remat does not lower the peak")

    shape = ShapeConfig("train_4k_cut", S, B, "train")
    bundle = steps.build_train(cfg, shape, device=dev)
    print(f"train step: {cfg.name} FULL, S={S}, global batch {B} (train_4k "
          f"takes 256), knobs {bundle.meta}, act budget "
          f"{bundle.meta['act_budget'] / 2 ** 30:.2f} GiB, estimated "
          f"{bundle.meta['act_bytes'] / 2 ** 30:.2f} GiB a microbatch")
    loss, opt, dt, peak, launches = run(bundle, shape)
    check(np.isfinite(loss), f"train step loss {loss}")
    check(opt.step == 1, f"Adam step {opt.step} after one step")
    check(launches["lora_matmul"] > 0 and launches["flash_attention"] > 0,
          f"train step launches {launches}")
    print(f"train step: loss {loss:.4f}, {dt:.3f} s/step, "
          f"{B * S / dt:.1f} tokens/s, peak {peak / 2 ** 30:.2f} GiB "
          f"(parameters {bundle.meta['param_bytes'] / 2 ** 30:.2f} GiB), "
          f"launches {json.dumps(launches)}")

    # flash at S = 4096, a microbatch of one sequence
    gen = torch.Generator(device=dev).manual_seed(25)
    q, k, v = ((torch.randn((1, S, cfg.n_heads, cfg.head_dim_),
                            generator=gen, device=dev)).to(torch.bfloat16)
               for _ in range(3))
    call = ("flash_attention", (q, k, v), {"causal": True, "window": 0})
    err = kc["close"](backend.flash_attention(q, k, v, causal=True,
                                              window=0),
                      _plain_versions(torch, lambda: backend.flash_attention(
                          q, k, v, causal=True, window=0)),
                      "flash S=4096")
    f_ms, f_pl, f_nb, f_fl, f_lib, f_what = _time_flash(torch, call, kc)
    row = _row(f"flash_attention (S={S}, OLMo-1.3B train step, B=1 H=16 "
               f"D=128)", "flash_attention.cu", "flash_attention.py:92", err,
               f_ms, f_pl, bound_ms(f_nb, f_fl, BF16_FLOPS), f_lib,
               launches["flash_attention"], f_what)
    del q, k, v, call

    # build_prefill / build_serve at a small shape, the card's kernels
    # against the plain versions, fp32 (summation order only)
    c32 = cfg.replace(dtype="float32")
    p32 = _cast(params, torch.float32, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    tr32 = {"lora": _cast(lora, torch.float32, dev)}
    pre = steps.build_prefill(c32, ShapeConfig("p", 64, 2, "prefill"))
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=batch_gen,
                        device=dev, dtype=torch.int32)
    lg, cache = pre.fn(p32, tr32, tok)
    lg_p, cache_p = _plain_versions(torch, lambda: pre.fn(p32, tr32, tok))
    srv = steps.build_serve(c32, ShapeConfig("d", 128, 2, "decode"))
    full = model_lib.init_cache(c32, 2, 128, device=dev)
    for leaf in ("k", "v"):
        full["pos0"]["attn"][leaf][:, :, :64] = cache["pos0"]["attn"][leaf]
    full_p = _clone(full)
    nxt = lg.argmax(-1).to(torch.int32)
    pos = torch.tensor(64, dtype=torch.int32, device=dev)
    ld, _ = srv.fn(p32, tr32, full, nxt, pos)
    ld_p, _ = _plain_versions(torch, lambda: srv.fn(p32, tr32, full_p, nxt,
                                                    pos))
    errs = []
    for what, got, want in (("prefill logits", lg, lg_p),
                            ("prefill cache k",
                             cache["pos0"]["attn"]["k"],
                             cache_p["pos0"]["attn"]["k"]),
                            ("serve logits", ld, ld_p),
                            ("serve cache v", full["pos0"]["attn"]["v"],
                             full_p["pos0"]["attn"]["v"])):
        err = (got - want).abs().max().item()
        check(err <= 1e-4 * max(want.abs().max().item(), 1.0),
              f"steps {what}: max |kernels - plain| {err:.3e}")
        errs.append(f"{what} {err:.3e}")
    print(f"steps build_prefill (B=2 S=64) / build_serve (one token at "
          f"position 64 of a 128-deep cache), OLMo FULL fp32, kernels "
          f"against plain versions: " + ", ".join(errs)
          + f"; meta {pre.meta} / {srv.meta}")
    del p32, tr32, lora, full, full_p, cache, cache_p
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train step phase: {time.perf_counter() - t_phase:.1f} s")
    return row


def device_driver_phase(torch, cfg, params, dev, check) -> None:
    """Phase 15: the device round driver (``round_driver="device"``) at
    OLMoE FULL, bf16, against the host driver from the same seeded start:
    phase 5's ``FederatedConfig`` (8 clients, two per tier k = 8, 4, 2, 1,
    learnable rescalers, batch 16 x 128) at participation 0.75 (6 clients
    a round, so cohorts run short and padding slots occur), 3 rounds,
    ``checkpoint_every=2`` (a 2-round segment, then a 1-round one, a
    checkpoint streamed at each end).  The two agree within rtol 2e-5 /
    atol 1e-6 (the reference's ``tests/test_round_driver.py`` tolerance):
    the global LoRA, every rescaler, per-client losses and frequencies.
    Printed: bit-equality, s/round and launches per round on each driver
    (checkpoint saves timed apart), the host syncs counted inside each
    segment's rounds (and each host-driver round) under
    ``torch.cuda.set_sync_debug_mode("warn")``, the checkpoint's round."""
    import dataclasses
    import gc
    import warnings

    from repro_torch.configs import FederatedConfig, TrainConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.federated import client as client_lib
    from repro_torch.federated.simulation import build_experiment
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    fed = FederatedConfig(num_clients=8, rounds=3, method="flame",
                          rescaler="learnable", participation=0.75,
                          checkpoint_every=2)
    tc = TrainConfig()
    data = DataConfig(vocab_size=512, n_examples=320, seq_len=128)
    ckpt = ROOT / "build" / "chip_smoke" / "driver.npz"
    runs = {}
    for driver in ("device", "host"):
        exp = build_experiment(cfg, fed=dataclasses.replace(
            fed, round_driver=driver), tc=tc, data=data, base_params=params,
            device=dev)
        srv = exp.server
        if driver == "device":
            # warm-up off the clock: one step of a 2-row batch
            c0 = srv.clients[0]
            plan = client_lib.make_batch_plan(c0, tc, 10_000)
            client_lib.local_update(
                cfg, params, {"lora": srv.global_lora,
                              "rescaler": c0.rescaler},
                plan.tokens[:1, :2], plan.labels[:1, :2],
                plan.mask[:1, :2], plan.valid[:1], k=c0.k, tc=tc,
                rescaler_trainable=True)
        saves, syncs = [], []
        save = srv.save_checkpoint

        def timed_save(path, save=save, saves=saves, srv=srv):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save(path)
            saves.append((len(srv.history), time.perf_counter() - t0))

        # the device driver's rounds inside a segment; the host driver's
        # whole rounds (their host reads included)
        name = "_device_round" if driver == "device" else "run_round"
        orig = getattr(srv, name)

        def counted(*a, orig=orig, syncs=syncs, **kw):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = orig(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            # the mode's one-time notice is no sync
            syncs.append(sum("called a synchronizing CUDA operation"
                             in str(w.message) for w in caught))
            return out

        srv.save_checkpoint = timed_save
        setattr(srv, name, counted)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        hist = srv.run(checkpoint_to=str(ckpt))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        meta = json.loads(ckpt.with_name(ckpt.name + ".meta.json")
                          .read_text())
        save_s = sum(s for _, s in saves)
        per_round = (wall - save_s) / len(hist)
        runs[driver] = (srv, hist)
        print(f"driver {driver}: {len(hist)} rounds in {wall:.3f} s "
              f"({per_round:.3f} s/round without the {len(saves)} "
              f"checkpoint saves at rounds {[n for n, _ in saves]}, "
              f"{save_s:.3f} s); participants "
              f"{[r.participating for r in hist]}; launches per round "
              f"{json.dumps({k: v / len(hist) for k, v in launches.items()})}"
              f"; host syncs per "
              f"{'round inside its segment' if driver == 'device' else 'round'}"
              f" {syncs}; checkpoint round_idx {meta['round_idx']}")
        check(len(hist) == 3 and meta["round_idx"] == 3,
              f"driver {driver}: {len(hist)} rounds, checkpoint at round "
              f"{meta['round_idx']}")
        check(all(len(r.participating) == 6 for r in hist),
              f"driver {driver}: not 6 participants a round")
        if driver == "device":
            check([n for n, _ in saves] == [2, 3],
                  f"device driver checkpointed after rounds {saves}")
            # two clients a tier: a round without both of a tier's clients
            # runs that cohort short (a padding slot)
            ks = [[srv.clients[i].k for i in r.participating] for r in hist]
            check(any(row.count(k) < 2 for row in ks for k in (8, 4, 2, 1)),
                  f"device driver: no cohort ran short ({ks})")
        for kname in ("lora_matmul", "lora_matmul_experts", "topk_router",
                      "flash_attention"):
            check(launches[kname] > 0, f"driver {driver}: no {kname}")
        for kname in ("ragged_gather", "ragged_expert_matmul",
                      "ragged_combine", "adaptive_topk_router"):
            check(launches[kname] == 0, f"driver {driver} launched {kname}")
        runs[driver] += (launches,)
        del exp
    ckpt.unlink()
    ckpt.with_name(ckpt.name + ".meta.json").unlink()

    (ds, dh, dl), (hs, hh, hl) = runs["device"], runs["host"]
    check(dl == hl, f"device and host drivers differ in launches: {dl} / {hl}")
    worst, bits = 0.0, True

    def agree(a, b, what):
        nonlocal worst, bits
        a, b = a.float(), b.float()
        d = (a - b).abs()
        bits = bits and torch.equal(a, b)
        ok = bool((d <= 2e-5 * b.abs() + 1e-6).all())
        check(ok, f"device vs host driver: {what} max |d| "
                  f"{d.max().item():.3e} beyond rtol 2e-5 / atol 1e-6")
        worst = max(worst, d.max().item())

    for (path, a), (_, b) in zip(_paths(ds.global_lora),
                                 _paths(hs.global_lora)):
        agree(a, b, "global LoRA " + "/".join(path))
    for c_d, c_h in zip(ds.clients, hs.clients):
        agree(c_d.rescaler["pos0"], c_h.rescaler["pos0"],
              f"client {c_d.client_id}'s rescaler")
    for rd, rh in zip(dh, hh):
        check(rd.participating == rh.participating,
              f"round {rd.round_idx}: participants differ")
        agree(torch.tensor(rd.client_losses), torch.tensor(rh.client_losses),
              f"round {rd.round_idx} client losses")
        for fd, fh in zip(rd.client_freqs, rh.client_freqs):
            agree(torch.from_numpy(np.asarray(fd["pos0"])),
                  torch.from_numpy(np.asarray(fh["pos0"])),
                  f"round {rd.round_idx} frequencies")
    check(all(np.isfinite(r.client_losses).all() for r in dh),
          "device driver: a loss is not finite")
    print(f"driver device vs host: global LoRA, rescalers, losses and "
          f"frequencies within rtol 2e-5 / atol 1e-6 (max |d| {worst:.3e}); "
          f"bit-equal: {bits} ({time.perf_counter() - t_phase:.1f} s)")
    del ds, hs, dh, hh, runs
    gc.collect()
    torch.cuda.empty_cache()


SWA_LENS = (8180, 9000, 10240, 12288)
SWA_TIERS = (8, 4, 2, 1)
SWA_NEW = 32
SWA_SLOT_LEN = 12352


def swa_phase(torch, cfg, params, dev, check, kc):
    """Phase 16: ``cfg``, the ``swa`` variant of OLMoE-1.3B/6.9B (window
    8192), at full width, bf16, on ``params``: 4 requests of 8,180 / 9,000 / 10,240 /
    12,288-token prompts, 32 new tokens each, tiers 8, 4, 2, 1, slot_len
    12,352 (a ring of 8,192 per slot, 4 GiB), on the paged layout and
    then the slotted one: three prompts exceed the window (prefill skips
    key tiles, the cache is the rolled ring) and the first prompt's ring
    wraps during decode.  Tokens equal across layouts or the first
    divergence a near-tie (phase 11's rule); every request complete with
    finite logits; counts zeroed just before each run (flash and the
    static router once per layer and prefill call, the per-token router
    once per layer and decode step); every kernel call of one decode step
    against its plain version; layer 0's flash call of the 12,288-token
    prefill against its plain version (close_16bit) and timed beside its
    bound (4·H·D·Σ_q min(q + 1, w) FLOPs) and SDPA with a boolean band
    mask.  Returns the kernel row 2W."""
    import gc

    import torch.nn.functional as F

    from repro_torch.kernels import _build, backend, ref
    from repro_torch.serving import Request, ServingEngine

    t_phase = time.perf_counter()
    w = cfg.attention_window
    check(SWA_LENS[0] < w < SWA_LENS[0] + SWA_NEW,
          "the first prompt's ring does not wrap during decode")
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in SWA_LENS]

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=SWA_NEW,
                        k=SWA_TIERS[i]) for i, p in enumerate(prompts)]

    L = cfg.num_layers
    runs, layer0, dec_calls = {}, {}, {}
    orig_flash = backend.flash_attention

    def flash_rec(q, k, v, **kw):
        out = orig_flash(q, k, v, **kw)
        if q.shape[1] == SWA_LENS[-1] and "call" not in layer0:
            layer0["call"] = (q, k, v, kw, out)
        return out

    for layout in ("paged", "slotted"):
        eng = ServingEngine(cfg, params, num_slots=4, slot_len=SWA_SLOT_LEN,
                            slot_k=SWA_TIERS, kv_layout=layout)
        check(eng.pool.attn_len == w, f"swa {layout}: ring of "
              f"{eng.pool.attn_len}")
        if layout == "paged":
            check(eng.pool.blocks_per_slot == w // eng.pool.block_size,
                  "swa paged: blocks per slot not capped by the ring")
        rec = _SpecRecorder(eng)
        decode = eng._decode_once

        def first_decode(report, decode=decode, layout=layout):
            if layout in dec_calls:
                return decode(report)
            _, dec_calls[layout] = _recorded(torch, lambda: decode(report))

        eng._decode_once = first_decode
        backend.flash_attention = flash_rec
        try:
            torch.cuda.synchronize()
            _build.reset_launches()
            rep = eng.run(requests())
            torch.cuda.synchronize()
        finally:
            backend.flash_attention = orig_flash
            rec.close()
        launches = dict(_build.LAUNCHES)
        s = rep.summary()
        n_pre, n_dec = len(rep.prefill_s), s["decode_steps"]
        for c in rep.completions:
            check(c.n_generated == SWA_NEW and not c.truncated,
                  f"swa {layout}: request {c.rid} generated "
                  f"{c.n_generated} tokens (truncated {c.truncated})")
        check(all(np.isfinite(r).all() for r in rec.rows.values()
                  if not isinstance(r, tuple)),
              f"swa {layout}: a logit row is not finite")
        check(launches["flash_attention"] == L * n_pre
              and launches["topk_router"] == L * n_pre
              and launches["adaptive_topk_router"] == L * n_dec,
              f"swa {layout}: launches {launches} for {n_pre} prefill calls "
              f"and {n_dec} decode steps")
        for kname, n in launches.items():
            check((n == 0) if kname.startswith("lora") else (n > 0),
                  f"swa {layout}: {kname} launched {n} times")
        ttft = {c.rid: c.ttft for c in rep.completions}
        print(f"swa {layout} (window {w}, ring {eng.pool.attn_len}, "
              f"prompts {SWA_LENS}, tiers {SWA_TIERS}): {s['gen_tokens']} "
              f"tokens in {s['wall_s']:.3f} s, TTFT of the "
              f"{SWA_LENS[-1]}-token prompt {ttft[3] * 1e3:.1f} ms (its "
              f"prefill call {rep.prefill_s[-1] * 1e3:.1f} ms; prefill "
              f"calls {[round(x * 1e3, 1) for x in rep.prefill_s]} ms), "
              f"decode step p50 {s['decode_step_ms_p50']:.2f} ms "
              f"({n_dec} steps), peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"launches {json.dumps(launches)}")
        runs[layout] = (rep.tokens_by_rid(), rec, launches)
        del eng
    (pt, prec, pl), (st, srec, _) = runs["paged"], runs["slotted"]
    div = _first_divergences(prec, pt, srec, st)
    for rid, t, gap, d in div:
        check(gap <= d, f"swa: request {rid} differs across layouts at "
              f"position {t}, where the paged top-2 gap {gap:.3e} exceeds "
              f"max |slotted - paged| {d:.3e} (not a near-tie)")
    print(f"swa slotted vs paged: {4 - len(div)}/4 requests token-identical"
          + ("" if not div else " (first divergences: " + "; ".join(
              f"rid {r} at {t}: gap {g:.3e} <= {d:.3e}"
              for r, t, g, d in div) + ")"))
    for layout, calls in dec_calls.items():
        worst = _check_arch_calls(torch, cfg, calls, check, kc,
                                  f"swa {layout} decode step", False,
                                  len(SWA_TIERS))
        print(f"swa {layout} decode step, every kernel call vs plain at "
              f"every layer: max err {json.dumps(worst)}")
    del runs, prec, srec, dec_calls
    gc.collect()
    torch.cuda.empty_cache()

    # layer 0's flash call of the 12,288-token prefill (paged run)
    q, k, v, kw, out = layer0.pop("call")
    check(kw == {"causal": True, "window": w, "softcap": 0.0},
          f"swa prefill flash called with {kw}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    B, H, S, D = qt.shape
    KV = kt.shape[1]
    err = kc["close"](out, ref.flash_attention_ref(qt, kt, vt, causal=True,
                                                   window=w).transpose(1, 2),
                      "swa layer-0 flash S=12288 w=8192")
    t = kc["time_ms"]
    ms = t(lambda: backend.flash_attention(q, k, v, **kw))
    plain_ms = t(lambda: ref.flash_attention_ref(qt, kt, vt, **kw))
    qc, kc_, vc = (x.contiguous() for x in (qt, kt, vt))
    pos = torch.arange(S, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)
    sdpa = F.scaled_dot_product_attention(qc, kc_, vc, attn_mask=band,
                                          enable_gqa=KV != H)
    sdpa_err = (sdpa.float() - out.transpose(1, 2).float()).abs().max().item()
    lib_ms = t(lambda: F.scaled_dot_product_attention(
        qc, kc_, vc, attn_mask=band, enable_gqa=KV != H))
    pairs = w * (w + 1) // 2 + (S - w) * w       # Σ_q min(q + 1, w)
    bound = bound_ms((2 * B * H * S * D + 2 * B * KV * S * D)
                     * q.element_size(), 4.0 * D * B * H * pairs, BF16_FLOPS)
    print(f"swa flash layer 0 (B={B} H={H} KV={KV} S={S} D={D} w={w}): "
          f"SDPA with the band mask max |d| to the kernel {sdpa_err:.3e}")
    row = _row(f"flash_attention (swa prefill, S={S}, window {w})",
               "flash_attention.cu", "flash_attention.py:92", err, ms,
               plain_ms, bound, lib_ms, pl["flash_attention"],
               library_what="SDPA, boolean band mask")
    del q, k, v, out, qt, kt, vt, qc, kc_, vc, band, sdpa
    gc.collect()
    torch.cuda.empty_cache()
    print(f"swa phase: {time.perf_counter() - t_phase:.1f} s")
    return row


SSM_TIERS = (2, 2, 1, 1, 1, 1, 1, 1)
# serving's prefill transients, the kernel checks' fp32 plain versions
SSM_RESERVE = 16 * 2 ** 30
# a FLAME round at batch 16 x 128 keeps every layer's activations (no
# layer checkpointing in the client step): ~1.2 GB a Jamba Mamba layer
# (the SSD's (H, L, L) fp32 terms, B and C broadcast to 128 heads), the
# one-hot dispatch of the MoE layers, and the LoRA backward's fp32 copy
# of a stacked expert matrix (3.8 GB); 16 layers did not fit
SSM_TRAIN_RESERVE = 40 * 2 ** 30


def _ssm_run(torch, cfg, params, tiers, layout, lora=None):
    """A warm-up, then 8 requests (128/256-token prompts, 16 new tokens)
    on an 8 x 512 engine, counts zeroed just before and read just after.
    Returns (engine, report, recorder, launches)."""
    from repro_torch.kernels import _build
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(cfg, params, lora=lora, num_slots=8, slot_len=512,
                        slot_k=tiers, kv_layout=layout)
    eng.run(_arch_requests(cfg, tiers, n=2, new=2, seed=9))
    rec = _SpecRecorder(eng)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        rep = eng.run(_arch_requests(cfg, tiers))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        rec.close()
    return eng, rep, rec, launches


def _ssm_report(torch, cfg, eng, rep, rec, check, what):
    """Every request complete with finite logits and ids in range; one
    printed line: tokens/s, decode and prefill p50, peak memory, the pool's
    bytes and the SSM state rows' bytes.  Returns (prefill calls, decode
    steps)."""
    s = rep.summary()
    check(s["n_requests"] == 8 and s["gen_tokens"] == 8 * 16,
          f"{what}: served {s['n_requests']} requests / {s['gen_tokens']} "
          "tokens")
    for c in rep.completions:
        check(c.n_generated == 16 and not c.truncated and bool(
            ((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
            f"{what}: request {c.rid} incomplete or out of range")
    check(all(np.isfinite(r).all() for r in rec.rows.values()
              if not isinstance(r, tuple)), f"{what}: a logit row is not "
          "finite")
    n_pre, n_dec = len(rep.prefill_s), s["decode_steps"]
    print(f"{what}: {s['gen_tokens']} tokens in {s['wall_s']:.3f} s, "
          f"{s['gen_tokens_per_s']:.1f} tokens/s, decode step p50 "
          f"{s['decode_step_ms_p50']:.2f} ms ({n_dec} steps), prefill p50 "
          f"{float(np.median(rep.prefill_s)) * 1e3:.1f} ms ({n_pre} calls), "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, pool "
          f"{eng.pool.kv_bytes() / 2 ** 20:.1f} MiB of which SSM state rows "
          f"{eng.pool.row_bytes() / 2 ** 20:.1f} MiB "
          f"({eng.pool.row_bytes() / 8 / cfg.num_layers / 2 ** 20:.3f} MiB a "
          f"slot and layer on average)")
    return n_pre, n_dec


def _ssd_times(torch, cfg, params, dev, kc, what):
    """The plain SSD (``mamba2.ssd_chunked``) and the whole Mamba block of
    the first Mamba position at a 256-token prefill (B = 1) and at a
    decode step (B = 8), CUDA events, L2 flushed.  Printed; returns the
    SSD ms."""
    from repro_torch.models import mamba2
    from repro_torch.models.model import _index
    key = next(f"pos{j}" for j in range(cfg.pattern_period)
               if cfg.layer_kind(j) == "ssm")
    p = _index(params["blocks"][key]["ssm"], 0)
    d = mamba2.mamba_dims(cfg)
    H, P, N = d["n_heads"], d["head_dim"], d["d_state"]
    gen = torch.Generator(device=dev).manual_seed(17)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    S = 256
    x, Bm, Cm = rn(1, S, H, P), rn(1, S, H, N), rn(1, S, H, N)
    dt = torch.nn.functional.softplus(rn(1, S, H) - 4.0)
    A = -torch.exp(p["A_log"].float())
    t = kc["time_ms"]
    with torch.no_grad():
        ssd = t(lambda: mamba2.ssd_chunked(x, dt, A, Bm, Cm,
                                           min(cfg.ssm.chunk_size, S)))
        h = rn(1, S, cfg.d_model).to(cfg.torch_dtype)
        blk = t(lambda: mamba2.apply_mamba(p, cfg, h))
        h8 = rn(8, 1, cfg.d_model).to(cfg.torch_dtype)
        c8 = mamba2.init_mamba_cache(cfg, 8, device=dev)
        dec = t(lambda: mamba2.apply_mamba(p, cfg, h8, cache=c8))
    print(f"{what}: plain SSD per layer at prefill (B=1 S={S} H={H} P={P} "
          f"N={N}, chunk {min(cfg.ssm.chunk_size, S)}, fp32) {ssd:.4f} ms; "
          f"the whole Mamba block {blk:.4f} ms at that prefill, "
          f"{dec:.4f} ms at a decode step (B=8)")
    return ssd


def _ssm_round(torch, cfg, params, dev, check, method, want):
    """One federated round of 4 clients (``method``; budgets ``want`` as
    (k, rank) per client), batch 16 x 128, the default batched engine on
    the host driver; counts zeroed just before and read just after.
    Returns the launches."""
    from repro_torch.configs import FederatedConfig, TrainConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.federated import client as client_lib
    from repro_torch.federated.simulation import build_experiment
    from repro_torch.kernels import _build
    fed = FederatedConfig(num_clients=4, rounds=1, method=method)
    tc = TrainConfig()
    exp = build_experiment(cfg, fed=fed, tc=tc,
                           data=DataConfig(vocab_size=512, n_examples=200,
                                           seq_len=128),
                           base_params=params, device=dev)
    server = exp.server
    got = [(c.k, c.rank) for c in server.clients]
    check(got == list(want), f"{cfg.name} {method}: clients {got}")
    steps = sum(client_lib.make_batch_plan(c, tc, fed.seed * 1000).n_steps
                for c in server.clients)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = server.run_round(0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(all(np.isfinite(res.client_losses)),
          f"{cfg.name} round losses {res.client_losses}")
    check(all(np.isfinite(x.float().cpu().numpy()).all()
              for x in _leaves(server.global_lora)),
          f"{cfg.name}: the aggregated adapter is not finite")
    resc = sorted(server.clients[0].rescaler or {})
    print(f"ssm {cfg.name} training: one {method} round, clients (k, rank, "
          f"examples) " + ", ".join(f"({c.k}, {c.rank}, {c.dataset_size})"
                                     for c in server.clients)
          + f", {steps} steps in {dt:.3f} s ({dt / max(steps, 1):.3f} s/"
          f"step; s/round {dt:.3f}), losses "
          f"{[round(x, 4) for x in res.client_losses]}, rescalers at "
          f"{resc or 'none'}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"{json.dumps(launches)}")
    del exp, server
    return launches


def ssm_phase(torch, dev, check, kc):
    """Phase 17: the SSM and hybrid families at full width, bf16, random
    seeded weights.  (a) ``mamba2-780m`` FULL (48 layers, attention-free):
    the engine on the slotted pool (a paged request falls back to it),
    8 requests of 128/256-token prompts x 16 new tokens; no hand kernel on
    that path (the projections are plain products, the SSD plain
    PyTorch, as the reference's are jnp) unless an adapter is served:
    the same requests with a seeded rank-16 adapter unmerged launch
    ``lora_matmul`` twice per layer and engine call, and every call of one
    prefill call and one decode step is held against its plain version;
    one HLoRA round of 4 clients at ranks 16/10/6/5, batch 16 x 128.
    (b) ``jamba-v0.1-52b`` at full width at the largest whole-period depth
    that fits beside a 16 GiB reserve (serving) or a 40 GiB one (the
    round, whose client step keeps every layer's activations): the paged
    engine (8 requests,
    tiers 2,2,1,1,1,1,1,1), a slotted repeat whose tokens equal the paged
    run's or diverge first at a near-tie (phase 11's rule), launch counts
    (flash per attention layer, the router and the ragged trio per MoE
    layer), every kernel call of one prefill and one decode step against
    its plain version; one FLAME round of 4 clients at k = 2,1,1,1, batch
    16 x 128.  Both: tokens/s, decode and prefill p50, s/round, peak
    memory, the SSM state rows' bytes and the plain SSD's time per layer
    at prefill; the new kernel rows (launches from the run that carries
    each kernel).  Returns the rows."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import backend, ref
    from repro_torch.models import model as model_lib
    t = kc["time_ms"]
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    rows = []

    # ------------------------------------------------ (a) mamba2-780m FULL
    cfg = get_config("mamba2-780m", "full")
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(170), dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"ssm {cfg.name}: {cfg.num_layers} layers (FULL), "
          f"{n_params / 1e9:.3f} B params bf16, init "
          f"{time.perf_counter() - t0:.1f} s")
    L = cfg.num_layers
    eng, rep, rec, launches = _ssm_run(torch, cfg, params, None, "paged")
    check(not eng.paged, "mamba2: the engine did not fall back to the "
          "slotted pool")
    check(all(n == 0 for n in launches.values()),
          f"mamba2 base serving launched a hand kernel: {launches}")
    _ssm_report(torch, cfg, eng, rep, rec, check,
                "ssm mamba2-780m serving (slotted, no adapter)")
    base_tokens = rep.tokens_by_rid()
    del eng, rec
    lora, ratios = _serving_adapter(torch, cfg, params, dev, seed=171)
    print(f"ssm mamba2-780m adapter: rank {cfg.lora.rank} on in_proj and "
          f"out_proj, layer-0 LoRA term / base rms "
          + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    eng, rep, rec, lora_launches = _ssm_run(torch, cfg, params, None,
                                            "slotted", lora=lora)
    n_pre, n_dec = _ssm_report(
        torch, cfg, eng, rep, rec, check,
        "ssm mamba2-780m serving (slotted, rank-16 adapter unmerged)")
    check(lora_launches["lora_matmul"] == 2 * L * (n_pre + n_dec)
          and sum(lora_launches.values()) == lora_launches["lora_matmul"],
          f"mamba2 LoRA serving launches {lora_launches} for {n_pre} "
          f"prefill calls and {n_dec} decode steps x {L} layers")
    differ = sum(not np.array_equal(t, base_tokens[r])
                 for r, t in rep.tokens_by_rid().items())
    print(f"ssm mamba2-780m: {differ}/8 requests differ from the base "
          f"model's tokens; launches {json.dumps(lora_launches)}")
    del eng, rec
    pre, dec = _arch_step_calls(torch, cfg, params, None, check,
                                "mamba2 lora", lora=lora)
    worst = {"prefill": _check_arch_calls(torch, cfg, pre, check, kc,
                                          "mamba2 prefill", True, 256,
                                          n_lora=2 * L),
             "decode": _check_arch_calls(torch, cfg, dec, check, kc,
                                         "mamba2 decode", False, 8,
                                         n_lora=2 * L)}
    print(f"ssm mamba2-780m: every lora_matmul call of one prefill call "
          f"(T=256) and one decode step (8 slots) against its plain "
          f"version, {L} layers x 2: max err {json.dumps(worst)}")
    for part, calls in (("decode", dec), ("prefill", pre)):
        for j, name in ((0, "in_proj"), (1, "out_proj")):
            x, w, a, b = calls[j][1]
            sc = calls[j][2]["scale"]
            M, K = x.shape
            N, r = w.shape[1], a.shape[1]
            ms = t(lambda: backend.lora_matmul(x, w, a, b, scale=sc))
            pl = t(lambda: ref.lora_matmul_ref(x, w, a, b, sc))
            lib = t(lambda: torch.matmul(x, w))
            bnd = bound_ms(2 * (M * K + K * N + K * r + r * N + M * N),
                           2.0 * M * (K * N + K * r + r * N), BF16_FLOPS)
            if part == "decode" and name == "in_proj":
                rows.append(_row(
                    f"lora_matmul (mamba2 serving decode {name} "
                    f"{K}->{N}, r={r}, M={M})", "lora_matmul.cu",
                    "lora_matmul.py:63", worst["decode"]["lora_matmul"],
                    ms, pl, bnd, lib, lora_launches["lora_matmul"],
                    "torch.matmul(x, W), base product only"))
            else:
                print(f"ssm mamba2 lora_matmul {part} {name} ({K}->{N}, "
                      f"r={r}, M={M}): {ms:.4f} ms (plain {pl:.4f}, "
                      f"bound {bnd[0]:.4f} by {bnd[1]}, library {lib:.4f})")
    del pre, dec, lora
    _ssd_times(torch, cfg, params, dev, kc, "ssm mamba2-780m")
    m_launches = _ssm_round(torch, cfg, params, dev, check, "hlora",
                            [(0, 16), (0, 10), (0, 6), (0, 5)])
    check(m_launches["lora_matmul"] > 0 and sum(m_launches.values())
          == m_launches["lora_matmul"],
          f"mamba2 HLoRA round launches {m_launches}")
    rows += _lora_shape_rows(
        torch, dev, kc, "mamba2 train",
        [(2048, 1536, 6448, 16, "in_proj"), (2048, 1536, 6448, 5, "in_proj"),
         (2048, 3072, 1536, 16, "out_proj")],
        m_launches["lora_matmul"], seed=172, scale=2.0)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------ (b) jamba, full width
    full = get_config("jamba-v0.1-52b", "full")
    depth, per_period, outside = _fit_depth(torch, full, 8, 512,
                                            reserve=SSM_RESERVE)
    check(depth >= full.pattern_period, "jamba: not one period fits")
    cfg = full.replace(num_layers=depth)
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(173), dev)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    L = depth
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(L))
    n_moe = sum(cfg.layer_is_moe(i) for i in range(L))
    print(f"ssm {cfg.name}: depth {depth} of {full.num_layers} "
          f"({depth // full.pattern_period} of "
          f"{full.num_layers // full.pattern_period} periods of "
          f"{full.pattern_period}; a period {per_period / 1e9:.3f} GB, "
          f"embedding and head {outside / 1e9:.3f} GB), {n_attn} attention, "
          f"{L - n_attn} Mamba, {n_moe} MoE layers, {n_params / 1e9:.3f} B "
          f"params bf16, init {time.perf_counter() - t0:.1f} s")
    runs = {}
    for layout in ("paged", "slotted"):
        eng, rep, rec, ln = _ssm_run(torch, cfg, params, SSM_TIERS, layout)
        check(eng.paged == (layout == "paged"), f"jamba {layout} layout")
        n_pre, n_dec = _ssm_report(torch, cfg, eng, rep, rec, check,
                                   f"ssm jamba serving ({layout})")
        check(ln["flash_attention"] == n_attn * n_pre
              and ln["topk_router"] == n_moe * n_pre
              and ln["adaptive_topk_router"] == n_moe * n_dec
              and ln["ragged_gather"] == n_moe * (n_pre + n_dec)
              and ln["ragged_combine"] == n_moe * (n_pre + n_dec)
              and ln["ragged_expert_matmul"] == 3 * n_moe * (n_pre + n_dec)
              and ln["lora_matmul"] == ln["lora_matmul_experts"] == 0,
              f"jamba {layout}: launches {ln} for {n_pre} prefill calls and "
              f"{n_dec} decode steps ({n_attn} attention, {n_moe} MoE "
              "layers)")
        print(f"ssm jamba {layout} launches {json.dumps(ln)}")
        runs[layout] = (rep.tokens_by_rid(), rec, ln)
        del eng, rec
    (pt, prec, j_launches), (st, srec, _) = runs["paged"], runs["slotted"]
    div = _first_divergences(prec, pt, srec, st)
    for rid, pos, gap, d in div:
        check(gap <= d, f"jamba: request {rid} differs across layouts at "
              f"position {pos}, where the paged top-2 gap {gap:.3e} exceeds "
              f"max |slotted - paged| {d:.3e} (not a near-tie)")
    print(f"ssm jamba slotted vs paged: {8 - len(div)}/8 requests "
          "token-identical" + ("" if not div else " (first divergences: "
                               + "; ".join(f"rid {r} at {p}: gap {g:.3e} "
                                           f"<= {d:.3e}"
                                           for r, p, g, d in div) + ")"))
    del runs, prec, srec
    rows += _arch_kernel_rows(torch, "jamba-v0.1-52b", cfg, params,
                              SSM_TIERS, j_launches, check, kc)
    _ssd_times(torch, cfg, params, dev, kc, "ssm jamba")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - base
    check(held < per_period, f"jamba: {held / 2 ** 30:.2f} GiB of the "
          "serving model still allocated before the round's is built")
    depth, _, _ = _fit_depth(torch, full, 8, 512, reserve=SSM_TRAIN_RESERVE)
    check(depth >= full.pattern_period, "jamba: not one period fits a round")
    cfg = full.replace(num_layers=depth)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(173), dev)
    print(f"ssm {cfg.name} training: depth {depth} of {full.num_layers} "
          f"(the largest whole-period depth beside a "
          f"{SSM_TRAIN_RESERVE / 2 ** 30:.0f} GiB training reserve; "
          f"{held / 2 ** 30:.2f} GiB more than at the phase's start still "
          "allocated)")
    f_launches = _ssm_round(torch, cfg, params, dev, check, "flame",
                            [(2, 16), (1, 16), (1, 16), (1, 16)])
    for name in ("lora_matmul", "lora_matmul_experts", "topk_router",
                 "flash_attention"):
        check(f_launches[name] > 0, f"jamba FLAME round launched no {name}")
    for name in ("adaptive_topk_router", "ragged_gather",
                 "ragged_expert_matmul", "ragged_combine"):
        check(f_launches[name] == 0, f"jamba FLAME round launched {name}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rows += _lora_shape_rows(
        torch, dev, kc, "jamba train",
        [(2048, 4096, 16768, 16, "in_proj"), (2048, 8192, 4096, 16,
                                               "out_proj")],
        f_launches["lora_matmul"], seed=174, scale=2.0)
    # the experts at the k = 2 client's capacity (2048 tokens, E = 16,
    # factor 1.25): C = 320; w1 (4096 -> 14,336)
    gen = torch.Generator(device=dev).manual_seed(175)
    E, C, K, N, r = 16, 320, 4096, 14336, 16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    x, w = randn(E, C, K), randn(E, K, N, scale=K ** -0.5)
    a, b = randn(E, K, r, scale=K ** -0.5), randn(E, r, N, scale=0.5)
    err = kc["close"](backend.lora_matmul_experts(x, w, a, b, scale=2.0),
                      ref.lora_matmul_experts_ref(x, w, a, b, 2.0),
                      "lora_matmul_experts jamba E=16 C=320 w1")
    rows.append(_row(
        f"lora_matmul_experts (jamba train E={E}, C={C}, w1 {K}->{N}, "
        f"r={r})", "lora_matmul.cu", "lora_matmul.py:101", err,
        t(lambda: backend.lora_matmul_experts(x, w, a, b, scale=2.0)),
        t(lambda: ref.lora_matmul_experts_ref(x, w, a, b, 2.0)),
        bound_ms(2 * E * (C * K + K * N + K * r + r * N + C * N),
                 2.0 * E * C * (K * N + K * r + r * N), BF16_FLOPS),
        t(lambda: torch.bmm(x, w)), f_launches["lora_matmul_experts"],
        "torch.bmm(x, W), base product only"))
    del x, w, a, b
    gc.collect()
    torch.cuda.empty_cache()
    print(f"ssm phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


AUDIO_CAP = 50.0        # Gemma 2's attn_logit_softcapping
AUDIO_TRAIN_BATCH = 8   # train_4k's global batch of 256 cut, as phase 14's


def _audio_train_step(torch, cfg, params, dev, check):
    """(b) ``launch/steps.py`` ``build_train`` on ``musicgen-large`` FULL at
    train_4k's 4096 tokens, the global batch cut from 256 to 8, (B, S, 4)
    codebook tokens: after a one-sequence warm-up, one step with the counts
    zeroed just before and read just after.  Returns (the launches, the
    microbatch the step gives flash)."""
    from repro_torch.configs import INPUT_SHAPES, ShapeConfig
    from repro_torch.core import lora as lora_lib
    from repro_torch.kernels import _build
    from repro_torch.launch import steps
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.optim import adam
    S, B = INPUT_SHAPES["train_4k"].seq_len, AUDIO_TRAIN_BATCH
    lora = lora_lib.init_lora(torch.Generator(device=dev).manual_seed(32),
                              cfg, params)
    gen = torch.Generator(device=dev).manual_seed(33)
    for _, pair in _pairs(lora):          # b off zero: every factor moves
        pair["b"] = (torch.randn(pair["b"].shape, generator=gen, device=dev)
                     * 0.01).to(pair["b"].dtype)
    batch_gen = torch.Generator(device=dev).manual_seed(34)
    one = ShapeConfig("train_4k_b1", S, 1, "train")
    warm = steps.build_train(cfg, one, device=dev)
    tr = {"lora": lora}
    warm.fn(params, tr, adam.init(tr), *synthetic_batch(cfg, one, batch_gen,
                                                        dev))
    shape = ShapeConfig("train_4k_cut", S, B, "train")
    bundle = steps.build_train(cfg, shape, device=dev)
    meta = bundle.meta
    estimate = (meta["param_bytes"] + 4 * meta["trainable_bytes"]
                + meta["act_bytes"])
    batch = synthetic_batch(cfg, shape, batch_gen, dev)
    check(tuple(batch[0].shape) == (B, S, cfg.num_codebooks)
          and tuple(batch[2].shape) == (B, S),
          f"audio train batch shapes {[tuple(t.shape) for t in batch]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    _, opt, m = bundle.fn(params, tr, adam.init(tr), *batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # random weights: the logits are Gaussian with variance 0.02²·d_model
    # (the head's N(0, 0.02) weights on unit-rms hidden states), so the
    # loss expected at step 0 is ln V plus half that variance
    ln_v = float(np.log(cfg.vocab_size))
    want = ln_v + 0.02 ** 2 * cfg.d_model / 2
    print(f"audio train step: {cfg.name} FULL ({cfg.num_layers} layers), "
          f"S={S}, global batch {B} (train_4k takes 256), K="
          f"{cfg.num_codebooks} codebooks; knobs {json.dumps(meta)}")
    print(f"audio train step: loss {loss:.4f} at step 0 (ln {cfg.vocab_size}"
          f" = {ln_v:.4f}, + 0.02²·d_model/2 = {want:.4f}), {dt:.3f} s/step, {B * S / dt:.1f} tokens/s, peak "
          f"{peak / 2 ** 30:.2f} GiB against the chooser's estimate "
          f"{estimate / 2 ** 30:.2f} GiB (parameters "
          f"{meta['param_bytes'] / 2 ** 30:.2f}, adapters with their "
          f"gradient sum and Adam moments "
          f"{4 * meta['trainable_bytes'] / 2 ** 30:.2f}, a microbatch's "
          f"activations {meta['act_bytes'] / 2 ** 30:.2f}), launches "
          f"{json.dumps(launches)}")
    check(np.isfinite(loss) and abs(loss - want) <= 0.01 * want,
          f"audio train step loss {loss} not within 1% of {want:.4f}")
    check(opt.step == 1, f"Adam step {opt.step} after one step")
    for name, n in launches.items():
        used = name in ("lora_matmul", "flash_attention")
        check((n > 0) if used else (n == 0),
              f"audio train step launches {launches}")
    return launches, B // meta["n_micro"]


def _audio_rounds(torch, cfg, params, dev, check):
    """(c) Federated rounds at FULL on a 4-codebook corpus at V = 2048:
    one FLAME round (8 clients, batch 16 x 128) on the host and on the
    device round driver from the same start, bit-equal (global adapter and
    client losses); one HLoRA round of 4 clients at ranks 16/10/6/5.
    Counts zeroed just before each run and read just after.  Returns the
    host FLAME run's and the HLoRA run's launches."""
    import dataclasses

    from repro_torch.configs import FederatedConfig, TrainConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.federated import client as client_lib
    from repro_torch.federated.simulation import build_experiment
    from repro_torch.kernels import _build
    tc = TrainConfig()
    data = DataConfig(vocab_size=cfg.vocab_size, n_examples=320,
                      seq_len=128, num_codebooks=cfg.num_codebooks)
    runs = {}
    for what, fed in (
            ("flame host", FederatedConfig(num_clients=8, rounds=1)),
            ("flame device", FederatedConfig(num_clients=8, rounds=1,
                                             round_driver="device")),
            ("hlora", FederatedConfig(num_clients=4, rounds=1,
                                      method="hlora"))):
        exp = build_experiment(cfg, fed=fed, tc=tc, data=data,
                               base_params=params, device=dev)
        srv = exp.server
        c0 = srv.clients[0]
        check(c0.shard.tokens.shape[1:] == (128, cfg.num_codebooks),
              f"audio corpus shape {c0.shard.tokens.shape}")
        if fed.method == "hlora":
            got = [c.rank for c in srv.clients]
            check(got == [16, 10, 6, 5], f"audio HLoRA ranks {got}")
        steps = sum(client_lib.make_batch_plan(c, tc, fed.seed * 1000)
                    .n_steps for c in srv.clients)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        hist = srv.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        losses = hist[0].client_losses
        check(len(hist) == 1 and all(np.isfinite(losses)),
              f"audio {what} round losses {losses}")
        check(all(np.isfinite(x.float().cpu().numpy()).all()
                  for x in _leaves(srv.global_lora)),
              f"audio {what}: the aggregated adapter is not finite")
        for name, n in launches.items():
            used = name in ("lora_matmul", "flash_attention")
            check((n > 0) if used else (n == 0),
                  f"audio {what} launches {launches}")
        print(f"audio {what} round: clients (rank, examples) "
              + ", ".join(f"({c.rank}, {c.dataset_size})"
                          for c in srv.clients)
              + f", {steps} steps in {dt:.3f} s ({dt / max(steps, 1):.3f} "
              f"s/step; s/round {dt:.3f}), losses "
              f"{[round(x, 4) for x in losses]}, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"launches {json.dumps(launches)}")
        runs[what] = (srv, losses, launches)
        del exp
    (hs, hl, hn), (ds, dl, dn) = runs["flame host"], runs["flame device"]
    check(hn == dn, f"audio drivers differ in launches: {hn} / {dn}")
    check(hl == dl, f"audio drivers' client losses differ: {hl} / {dl}")
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(_paths(hs.global_lora), _paths(ds.global_lora)))
    check(same, "audio device driver's global adapter is not bit-equal to "
          "the host driver's")
    print("audio flame device vs host driver: client losses and the global "
          "adapter bit-equal")
    out = runs["flame host"][2], runs["hlora"][2]
    del runs, hs, ds
    return out


def _audio_e2e(torch, cfg, dev, check):
    """(d) ``musicgen-large`` at full width and 2 layers, float32: the
    codebook loss and every adapter leaf's gradient on the card against
    the CPU's plain path, same weights, adapter (b off zero) and (B, S, K)
    batch."""
    from repro_torch.core import lora as lora_lib
    from repro_torch.models import model as model_lib
    c32 = cfg.replace(num_layers=2, dtype="float32")
    params = model_lib.init_params(c32, torch.Generator().manual_seed(35),
                                   "cpu")
    lora = lora_lib.init_lora(torch.Generator().manual_seed(36), c32, params)
    gen = torch.Generator().manual_seed(37)
    for path, leaf in _paths(lora):
        if path[-1] == "b":
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 0.02)
    rng = np.random.default_rng(38)
    tok = torch.as_tensor(rng.integers(0, c32.vocab_size,
                                       (2, 64, c32.num_codebooks)))
    lab = torch.roll(tok, -1, dims=1)
    msk = torch.as_tensor((rng.random((2, 64)) > 0.2).astype(np.float32))

    def fresh(tree, device):
        """Leaf copies on ``device`` that require grad (never the CPU
        originals themselves, which ``.to`` would return unchanged)."""
        if isinstance(tree, dict):
            return {k: fresh(v, device) for k, v in tree.items()}
        return tree.detach().to(device).requires_grad_(True)

    def run(device):
        p = _cast(params, torch.float32, device)
        tr = {"lora": fresh(lora, device)}
        leaves = [t for _, t in _paths(tr)]
        loss, _ = model_lib.lm_loss(c32, p, tok.to(device), lab.to(device),
                                    msk.to(device), trainable=tr)
        grads = torch.autograd.grad(loss, leaves)
        return loss.item(), [g.float().cpu() for g in grads]

    l_gpu, g_gpu = run(dev)
    l_cpu, g_cpu = run("cpu")
    rel = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for a, b in zip(g_gpu, g_cpu)]
    print(f"audio e2e float32 (2 layers, full width, B=2 S=64 K="
          f"{c32.num_codebooks}): card loss {l_gpu:.6f} vs cpu {l_cpu:.6f} "
          f"(|d| {abs(l_gpu - l_cpu):.3e}); {len(rel)} adapter leaves: grad "
          f"rel L2 median {float(np.median(rel)):.3e} max {max(rel):.3e}")
    # fp32 on both sides, only the summation order differs (sums over up
    # to 8192 terms)
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu),
          "audio e2e loss differs by more than 1e-5 relative")
    check(max(rel) <= 1e-4, "audio e2e gradients differ by more than 1e-4 "
          "relative L2")


def _softcap_serve(torch, dev, check, kc):
    """(e) OLMoE at full width and 2 layers with ``attn_logit_softcap`` =
    50 and the QK norms' gains times 8 (scores of tens, so the cap acts),
    bf16: 8
    requests (128/256-token prompts, 16 new tokens, tiers 8,8,4,4,2,2,1,1)
    on the paged and the slotted pool, tokens equal, flash launched once
    per layer and prefill call (counts zeroed just before each run and
    read just after), and the same requests without the cap give other
    tokens; every kernel call of one prefill call and one decode step
    against its plain version (close_16bit), each flash call also against
    the uncapped plain version, which it must miss.  Then float32, the
    same weights: one prefill's logits through the kernels (flash's FMA
    kernel with the cap) against the plain versions; greedy speculative
    engines (verify with the cap) equal plain decode on both pools; one
    request's engine tokens (capped decode) equal greedy by whole
    prefills.  Returns (the paged run's launches, the recorded prefill's
    flash call)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.models import model as model_lib
    from repro_torch.serving import ServingEngine, SpeculativeConfig
    cfg = get_config("olmoe-1.3b-6.9b", "full").replace(
        num_layers=2, attn_logit_softcap=AUDIO_CAP)
    free_cfg = cfg.replace(attn_logit_softcap=0.0)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(39), dev)
    # OLMoE normalises q and k per head: their norms' gains, not wq and
    # wk, set the scores' scale; times 8 each puts them in the tens
    check(cfg.qk_norm, "softcap serve: OLMoE without its QK norm")
    for leaf in ("q_norm", "k_norm"):
        params["blocks"]["pos0"]["attn"][leaf].mul_(8.0)
    tiers = (8, 8, 4, 4, 2, 2, 1, 1)
    toks, out = {}, {}
    for what, c, layout in (("paged", cfg, "paged"),
                            ("slotted", cfg, "slotted"),
                            ("no cap", free_cfg, "paged")):
        eng = ServingEngine(c, params, num_slots=8, slot_len=512,
                            slot_k=tiers, kv_layout=layout)
        eng.run(_arch_requests(c, tiers, n=2, new=2, seed=9))
        torch.cuda.synchronize()
        _build.reset_launches()
        rep = eng.run(_arch_requests(c, tiers))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        s = rep.summary()
        n_pre = len(rep.prefill_s)
        check(s["n_requests"] == 8 and s["gen_tokens"] == 8 * 16,
              f"softcap {what}: {s['n_requests']} requests")
        for comp in rep.completions:
            check(bool(((comp.tokens >= 0) & (comp.tokens < c.vocab_size))
                       .all()), f"softcap {what}: ids out of range")
        check(launches["flash_attention"] == c.num_layers * n_pre,
              f"softcap {what}: flash launched "
              f"{launches['flash_attention']} times for {n_pre} prefill "
              f"calls x {c.num_layers} layers")
        print(f"softcap serve (OLMoE full width, 2 layers, QK gains x8, "
              f"{what}): {s['gen_tokens_per_s']:.1f} tokens/s, decode p50 "
              f"{s['decode_step_ms_p50']:.2f} ms, {n_pre} prefill calls; "
              f"launches {json.dumps(launches)}")
        toks[what] = rep.tokens_by_rid()
        out[what] = launches
        del eng

    def n_same(a, b):
        return sum(np.array_equal(toks[a][r], toks[b][r]) for r in toks[a])
    same, free = n_same("paged", "slotted"), n_same("paged", "no cap")
    print(f"softcap serve: paged vs slotted {same}/8 requests "
          f"token-identical; capped vs uncapped {free}/8")
    check(same == 8, "softcap serve: paged and slotted tokens differ")
    check(free < 8, "softcap serve: the cap changes no token")
    pre, dec = _arch_step_calls(torch, cfg, params, tiers, check, "softcap")
    worst = {"prefill": _check_arch_calls(torch, cfg, pre, check, kc,
                                          "softcap prefill", True, 256),
             "decode": _check_arch_calls(torch, cfg, dec, check, kc,
                                         "softcap decode", False, 8)}
    miss = []
    for name, a, kw, o in pre:
        if name == "flash_attention":
            q, k, v = (t.transpose(1, 2) for t in a)
            d = (o.float() - ref.flash_attention_ref(
                q, k, v, causal=True, window=kw["window"]).transpose(1, 2)
                 .float()).abs()
            miss.append(d.max().item())
            check(not bool((d <= 1e-2 * o.float().abs() + 1e-2).all()),
                  "softcap prefill flash: the uncapped plain version is "
                  "within close_16bit of the capped kernel")
    print("softcap bf16 (QK gains x8): every kernel call of one prefill "
          "call (T=256) and one decode step (8 slots) against its plain "
          "version; max |kernel - plain|: " + "; ".join(
              f"{part} " + ", ".join(f"{n} {e:.3e}" for n, e in w.items())
              for part, w in worst.items())
          + "; flash against the uncapped plain version: max |d| "
          + ", ".join(f"{m:.3e}" for m in miss))
    flash_call = next(c for c in pre if c[0] == "flash_attention")

    # float32, the same weights: kernels against plain versions in
    # summation order only, so tokens compare exactly
    reqs = _arch_requests(cfg, tiers)
    prompt = torch.as_tensor(reqs[1].prompt, device=dev)[None]
    c32 = cfg.replace(dtype="float32")
    p32 = _cast(params, torch.float32, dev)
    del params, pre, dec
    with torch.inference_mode():
        got, _ = model_lib.prefill(c32, p32, prompt, k=8)
        want, _ = _plain_versions(torch, lambda: model_lib.prefill(
            c32, p32, prompt, k=8))
        nocap, _ = _plain_versions(torch, lambda: model_lib.prefill(
            c32.replace(attn_logit_softcap=0.0), p32, prompt, k=8))
    rel = ((got - want).norm() / want.norm()).item()
    effect = ((nocap - want).norm() / want.norm()).item()
    print(f"softcap float32: a {prompt.shape[1]}-token prefill's logits, "
          f"kernels vs plain versions: rel L2 {rel:.3e}; the cap moves "
          f"them by {effect:.3e}")
    check(rel <= 1e-4, "softcap prefill logits: kernels vs plain above 1e-4")
    check(effect > 1e-3, "softcap prefill: the cap does not act")
    spec = SpeculativeConfig(SPEC_W, 1)
    f32 = {}
    for layout in ("paged", "slotted"):
        for sp in (None, spec):
            f32[layout, sp is not None] = ServingEngine(
                c32, p32, num_slots=8, slot_len=512, slot_k=tiers,
                kv_layout=layout, speculative=sp).run(
                    _arch_requests(c32, tiers)).tokens_by_rid()
    plain = f32["paged", False]
    for (layout, is_spec), t in f32.items():
        diff = [r for r in plain if not np.array_equal(plain[r], t[r])]
        check(not diff, f"softcap float32 {layout} "
              f"{'speculative' if is_spec else 'plain'}: requests {diff} "
              "differ from paged plain decode")
    seq = prompt
    with torch.inference_mode():
        for _ in range(reqs[1].max_new_tokens):
            lg, _ = model_lib.prefill(c32, p32, seq, k=tiers[1])
            seq = torch.cat([seq, lg[:, -1].argmax(-1)[:, None]
                             .to(seq.dtype)], dim=1)
    by_prefill = seq[0, prompt.shape[1]:].cpu().numpy()
    check(np.array_equal(by_prefill, plain[1]),
          "softcap float32: request 1's engine tokens differ from greedy "
          "by whole prefills")
    print("softcap float32: greedy speculative (verify) and plain decode "
          "tokens equal on both pools; request 1's 16 engine tokens equal "
          "greedy by whole prefills")
    del p32
    return out["paged"], flash_call


def audio_softcap_phase(torch, dev, check, kc):
    """Phase 19: audio codebooks and the logit softcap.  ``musicgen-large``
    FULL (48 layers, d_model 2048, MHA 32/32 at head_dim 64, d_ff 8192,
    4 codebooks of 2048; bf16, random seeded weights, uncut): (b) the train
    step at 4096 tokens, (c) a FLAME round on both round drivers and an
    HLoRA round; (d) 2 layers at fp32 against the CPU; (e) OLMoE at 2
    layers with a softcap of 50 that acts, served and checked call by call;
    (a) flash at musicgen's shapes without and with the cap, at row 2's and
    row 2W's shapes and the capped serve's prefill with the cap, and
    ``lora_matmul`` at musicgen's projections,
    each held against its plain version and timed.  Returns the rows."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import backend, ref
    from repro_torch.models import model as model_lib
    t_phase = time.perf_counter()
    cfg = get_config("musicgen-large", "full")
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(31), dev)
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == 3_254_978_560, f"musicgen-large has {n_params} "
          "parameters, the reference's count_params 3,254,978,560")
    print(f"audio {cfg.name}: {cfg.num_layers} layers (FULL, uncut), "
          f"{n_params / 1e9:.3f} B params bf16, embedding "
          f"{tuple(params['embed']['tokens'].shape)}, head "
          f"{tuple(params['lm_head'].shape)}")
    t0 = time.perf_counter()
    train, mb = _audio_train_step(torch, cfg, params, dev, check)
    print(f"audio phase (b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flame, hlora = _audio_rounds(torch, cfg, params, dev, check)
    print(f"audio phase (c): {time.perf_counter() - t0:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _audio_e2e(torch, cfg, dev, check)
    capped, serve_call = _softcap_serve(torch, dev, check, kc)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"audio phase (d, e): {time.perf_counter() - t0:.1f} s")
    # (a) launches: each row's count from the run that gave flash its shape
    # (the round at B=16 S=128, the train step's microbatch at S=4096, the
    # capped serve's prefill); 0 where no path of this run launches the
    # shape with that cap
    H, D = cfg.n_heads, cfg.head_dim_
    gen = torch.Generator(device=dev).manual_seed(40)

    def synthetic(B, S, h, d, w, cap):
        """A flash call as ``_recorded`` keeps one, bf16, q and k at three
        times unit scale so capped scores pass the cap."""
        q, k = ((3 * torch.randn((B, S, h, d), generator=gen, device=dev))
                .to(torch.bfloat16) for _ in range(2))
        v = torch.randn((B, S, h, d), generator=gen, device=dev).to(
            torch.bfloat16)
        return ("flash_attention", (q, k, v),
                {"causal": True, "window": w, "softcap": cap})

    cases = [(what, (B, S, h, d, w, cap), n) for what, B, S, h, d, w, cap, n in (
        ("musicgen client step", 16, 128, H, D, 0, 0.0,
         flame["flash_attention"]),
        ("musicgen client step", 16, 128, H, D, 0, AUDIO_CAP, 0),
        ("musicgen train step", mb, 4096, H, D, 0, 0.0,
         train["flash_attention"]),
        ("musicgen train step", mb, 4096, H, D, 0, AUDIO_CAP, 0),
        ("row 2's shape", 2, 256, 16, 128, 0, AUDIO_CAP, 0),
        ("row 2W's window", 1, 12288, 16, 128, 8192, AUDIO_CAP, 0))]
    cases.append(("OLMoE capped serve prefill", serve_call,
                  capped["flash_attention"]))
    rows = []
    for what, call, n in cases:
        if not isinstance(call[0], str):
            call = synthetic(*call)
        (q, k, v), kw = call[1], call[2]
        B, S, h, d = q.shape
        name = (f"{what}, B={B} S={S} H=KV={h} D={d}"
                + (f", window {kw['window']}" if kw["window"] else "")
                + (f", softcap {kw['softcap']:g}" if kw["softcap"] else ""))
        err = kc["close"](backend.flash_attention(q, k, v, **kw),
                          ref.flash_attention_ref(
                              *(x.transpose(1, 2) for x in (q, k, v)),
                              **kw).transpose(1, 2), f"flash {name}")
        ms, pl, nb, fl, lib, lib_what = _time_flash(torch, call, kc)
        rows.append(_row(f"flash_attention ({name})", "flash_attention.cu",
                         "flash_attention.py:92", err, ms, pl,
                         bound_ms(nb, fl, BF16_FLOPS), lib, n, lib_what))
        if n == 0:
            print(f"flash_attention ({name}): no path of this run launches "
                  "this shape with this cap: 0 launches")
        del call, q, k, v
        torch.cuda.empty_cache()
    del serve_call, cases
    d, f = cfg.d_model, cfg.d_ff
    for r, launches, seed in ((16, flame["lora_matmul"], 41),
                              (5, hlora["lora_matmul"], 42)):
        rows += _lora_shape_rows(
            torch, dev, kc, "musicgen train",
            [(2048, d, d, r, "q/k/v/o"), (2048, d, f, r, "w1/w3"),
             (2048, f, d, r, "w2")], launches, seed, cfg.lora.scale)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"audio and softcap phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


def backward_phase(torch, backend, ref, dev, check) -> None:
    """Gradients through each autograd wrapper (kernel forward, reference
    backward) against autograd through the plain version, float32, with a
    random cotangent and b != 0 so that dA != 0.  Tolerance 1e-4 relative
    to the largest gradient: fp32 both sides, the forward sums over K in
    another order and the backward products are the same.  The ragged
    trio runs on a plan of 256 tokens at budgets (1, 2, 8, 0) over 64
    experts, padding rows present."""
    from repro_torch.kernels.ragged_dispatch import ragged_plan
    g = torch.Generator(device=dev).manual_seed(5)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def lora_in(lead, M, K, N, r):
        return (rn(*lead, M, K), rn(*lead, K, N, scale=K ** -0.5),
                rn(*lead, K, r, scale=K ** -0.5), rn(*lead, r, N, scale=0.1))

    k_tok = torch.tensor((8, 8, 4, 4, 2, 2, 1, 0), dtype=torch.int32,
                         device=dev).repeat(32)

    def flash_plain(q, k, v):
        return ref.flash_attention_ref(*(t.transpose(1, 2) for t in
                                         (q, k, v))).transpose(1, 2)

    kt = torch.tensor((1, 2, 8, 0), dtype=torch.int32, device=dev).repeat(64)
    w_r, m_r, _ = ref.adaptive_topk_router_ref(rn(256, 64), kt, 8)
    pl = ragged_plan(m_r, w_r, budget=int(kt.sum()), max_k=8)
    n_rows = pl.src.shape[0]
    check(int(pl.valid.sum()) < n_rows, "backward: the ragged plan has no "
          "padding rows")
    be = pl.block_expert

    cases = {
        "lora_matmul": (lora_in((), 300, 512, 384, 20),
                        lambda *t: backend.lora_matmul(*t, scale=1.25),
                        lambda *t: ref.lora_matmul_ref(*t, 1.25)),
        "lora_matmul_experts": (
            lora_in((8,), 41, 512, 256, 20),
            lambda *t: backend.lora_matmul_experts(*t, scale=1.25),
            lambda *t: ref.lora_matmul_experts_ref(*t, 1.25)),
        "topk_router": ((rn(256, 64),),
                        lambda l: backend.router(l, 8)[0],
                        lambda l: ref.topk_router_ref(l, 8)[0]),
        "adaptive_topk_router": (
            (rn(256, 64),),
            lambda l: backend.adaptive_router(l, k_tok, 8)[0],
            lambda l: ref.adaptive_topk_router_ref(l, k_tok, 8)[0]),
        "flash_attention": ((rn(2, 128, 16, 128), rn(2, 128, 16, 128),
                             rn(2, 128, 16, 128)),
                            lambda q, k, v: backend.flash_attention(q, k, v),
                            flash_plain),
        "ragged_gather": (
            (rn(256, 512),),
            lambda x: backend.ragged_gather(x, pl.src, pl.valid),
            lambda x: ref.ragged_gather_ref(x, pl.src, pl.valid)),
        "ragged_expert_matmul (LoRA r20)": (
            (rn(n_rows, 512), rn(64, 512, 256, scale=512 ** -0.5),
             rn(64, 512, 20, scale=512 ** -0.5), rn(64, 20, 256, scale=0.1)),
            lambda xs, w, a, b: backend.ragged_expert_matmul(
                xs, be, w, a, b, scale=1.25),
            lambda xs, w, a, b: ref.ragged_expert_matmul_ref(
                xs, be, w, a, b, scale=1.25)),
        "ragged_combine": (
            (rn(n_rows, 512), pl.wrank.clone()),
            lambda eo, w: backend.ragged_combine(eo, pl.rows, w),
            lambda eo, w: ref.ragged_combine_ref(eo, pl.rows, w)),
    }
    for name, (inputs, wrap, plain) in cases.items():
        outs = []
        for fn in (wrap, plain):
            leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
            out = fn(*leaves)
            if not outs:
                cot = torch.randn(out.shape, generator=g, device=dev)
            outs.append(torch.autograd.grad(out, leaves, cot))
        errs = []
        for gw, gp in zip(*outs):
            err = (gw - gp).abs().max().item()
            errs.append(err)
            check(err <= 1e-4 * max(gp.abs().max().item(), 1e-3),
                  f"{name} backward: max |wrapper - plain| {err:.3e}")
        print(f"backward {name}: max |grad wrapper - grad plain| per input "
              + ", ".join(f"{e:.3e}" for e in errs))


def ragged_loss_grads(torch, dev, check) -> None:
    """The gradient of every trainable leaf (adapters with b != 0, the
    rescalers) of ``lm_loss`` on a 2-layer full-width model in float32 on
    the card: ``dispatch="ragged"`` (the trio's Functions) against
    ``dispatch="dense"`` (one-hot, the expert LoRA kernel), relative L2
    <= 1e-4 per leaf (fp32; the two sum over experts in other orders)."""
    from repro_torch.configs import get_config
    from repro_torch.core import lora as lora_lib
    from repro_torch.kernels import _build
    from repro_torch.models import model as model_lib
    c32 = get_config("olmoe-1.3b-6.9b", "full").replace(num_layers=2,
                                                       dtype="float32")
    params = model_lib.init_params(
        c32, torch.Generator(device=dev).manual_seed(12), dev)
    lora = lora_lib.init_lora(torch.Generator(device=dev).manual_seed(13),
                              c32, params)
    gen = torch.Generator(device=dev).manual_seed(14)
    for path, leaf in _paths(lora):
        if path[-1] == "b":
            leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev)
                       * 0.02)
    tok = torch.randint(0, c32.vocab_size, (2, 64), generator=gen,
                        device=dev)
    grads, launches = {}, {}
    for mode in ("ragged", "dense"):
        tr = {"lora": _clone(lora),
              "rescaler": lora_lib.init_rescalers(c32, 8, device=dev)}
        leaves = [leaf.requires_grad_(True) for _, leaf in _paths(tr)]
        _build.reset_launches()
        loss, _ = model_lib.lm_loss(c32, params, tok, tok.roll(-1, 1),
                                    trainable=tr, k=8, dispatch=mode)
        grads[mode] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        launches[mode] = dict(_build.LAUNCHES)
    for name in ("ragged_gather", "ragged_expert_matmul", "ragged_combine"):
        check(launches["ragged"][name] == 2 * (3 if "matmul" in name else 1),
              f"ragged lm_loss: {launches['ragged'][name]} {name} launches")
        check(launches["dense"][name] == 0, f"dense lm_loss launched {name}")
    rel = [((r - d).norm() / d.norm()).item()
           for r, d in zip(grads["ragged"], grads["dense"])]
    check(all(d.norm() > 0 for d in grads["dense"]),
          "ragged lm_loss: a dense gradient is zero")
    check(max(rel) <= 1e-4, f"ragged lm_loss gradients: relative L2 "
          f"{max(rel):.3e} > 1e-4 against dense dispatch")
    print(f"backward lm_loss (2 layers, full width, fp32, k=8): ragged "
          f"against dense dispatch, {len(rel)} trainable leaves, relative "
          f"L2 max {max(rel):.3e} (median {float(np.median(rel)):.3e})")
    del params, lora
    torch.cuda.empty_cache()


def training_phase(torch, cfg, params, dev, check, expert_ms, kernel_ms):
    """The reference's default FLAME round (batched cohort engine, host
    driver) at OLMoE FULL on the card through the port's entry points,
    held against the looped engine from the same start; returns the
    batched round's launch counts and (the round's global adapter, one
    client's rescaler per tier)."""
    import dataclasses

    from repro_torch.configs import FederatedConfig, TrainConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.federated import client as client_lib
    from repro_torch.federated.cohort import build_cohorts
    from repro_torch.federated.server import FederatedServer
    from repro_torch.federated.simulation import build_experiment
    from repro_torch.kernels import _build

    # the reference's defaults: round_engine="batched", cohort_backend=
    # "vmap", round_driver="host"; 8 clients, two per budget tier
    fed = FederatedConfig(num_clients=8, rounds=1, method="flame",
                          rescaler="learnable")
    check((fed.round_engine, fed.cohort_backend, fed.round_driver)
          == ("batched", "vmap", "host"), "FederatedConfig defaults moved")
    tc = TrainConfig()
    data = DataConfig(vocab_size=512, n_examples=320, seq_len=128)
    t0 = time.perf_counter()
    exp = build_experiment(cfg, fed=fed, tc=tc, data=data,
                           base_params=params, device=dev)
    server = exp.server
    torch.cuda.synchronize()
    print(f"training: build_experiment {time.perf_counter() - t0:.1f} s; "
          f"clients (k, examples): "
          + ", ".join(f"({c.k}, {c.dataset_size})" for c in server.clients))
    cohorts = build_cohorts(server.clients, tc, rank_of=server._dist_rank)
    print("training cohorts (k: members): " + ", ".join(
        f"{co.k}: {co.members}" for co in cohorts))
    check(sorted(len(co.members) for co in cohorts) == [2, 2, 2, 2],
          "the 8 clients do not form four cohorts of two")
    # warm-up off the clock: one step of a 2-row batch (cuBLAS handles and
    # workspaces of the fp32 backward products)
    c0 = server.clients[0]
    plan = client_lib.make_batch_plan(c0, tc, 10_000)
    client_lib.local_update(
        cfg, params, {"lora": server.global_lora, "rescaler": c0.rescaler},
        plan.tokens[:1, :2], plan.labels[:1, :2], plan.mask[:1, :2],
        plan.valid[:1], k=8, tc=tc, rescaler_trainable=True)

    # the start state, checkpointed at FULL (its save is timed here and its
    # load below, where it starts the looped engine from the same state)
    ckpt = ROOT / "build" / "chip_smoke" / "start.npz"
    start_lora = _clone(server.global_lora)
    resc0 = [c.rescaler["pos0"].clone() for c in server.clients]
    t0 = time.perf_counter()
    server.save_checkpoint(str(ckpt))
    save_s = time.perf_counter() - t0
    plans = [client_lib.make_batch_plan(c, tc, fed.seed * 1000)
             for c in server.clients]
    steps = [p.n_steps for p in plans]
    n_steps = sum(steps)
    tokens = sum(int(p.valid.sum()) * p.tokens.shape[1] * p.tokens.shape[2]
                 for p in plans)

    def timed_round(srv, what):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = srv.run_round(0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        print(f"training round, {what}: {n_steps} steps in {dt:.3f} s, "
              f"{dt / n_steps:.3f} s/step, {tokens / dt:.1f} tokens/s, peak "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        print(f"training launches, {what}: {json.dumps(launches)}")
        return res, dt, launches

    res, dt, launches = timed_round(server, "batched engine (default)")
    for c, n, loss in zip(server.clients, steps, res.client_losses):
        print(f"training client {c.client_id}: k={c.k} steps={n} "
              f"mean loss {loss:.4f}")
    # the expert kernel's share of the round, from the tier timings of the
    # kernel phase: per step, 16 layers x (w1 + w3 + w2)
    n_layers = cfg.num_layers
    expert_s = sum(n * n_layers * (2 * expert_ms[c.k][0] + expert_ms[c.k][1])
                   for c, n in zip(server.clients, steps)) / 1e3
    attn_s = launches["lora_matmul"] * kernel_ms["lora_matmul"] / 1e3
    print(f"training share: lora_matmul_experts ~{expert_s:.3f} s "
          f"({expert_s / dt:.1%} of the round), lora_matmul ~{attn_s:.3f} s "
          f"({attn_s / dt:.1%}), from kernel-phase times x launches")

    def fresh(engine):
        """A server on ``engine`` restored from the start checkpoint, with
        its own client states."""
        srv = FederatedServer(
            cfg, params, None,
            [dataclasses.replace(c, rescaler=None) for c in server.clients],
            dataclasses.replace(fed, round_engine=engine), tc)
        check(srv.restore_checkpoint(str(ckpt)) == 0,
              "the start checkpoint does not resume at round 0")
        return srv

    # the looped engine from the same start
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    looped = fresh("looped")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size = ckpt.stat().st_size
    print(f"checkpoint at FULL: {size / 2 ** 20:.1f} MiB "
          f"({ckpt.name}, global LoRA + 8 rescalers), save {save_s:.3f} s, "
          f"load onto the card {load_s:.3f} s")
    check(all(torch.equal(a, b) for (_, a), (_, b) in
              zip(_paths(looped.global_lora), _paths(start_lora))),
          "the FULL checkpoint did not restore the global LoRA bit for bit")
    check(all(torch.equal(c.rescaler["pos0"], r) for c, r in
              zip(looped.clients, resc0)),
          "the FULL checkpoint did not restore the rescalers bit for bit")
    lres, ldt, llaunches = timed_round(looped, "looped engine")
    # the first round on the card pays for allocator growth and first-seen
    # GEMM shapes: the same round twice more from the checkpoint, looped
    # then batched, so each engine runs once first and once last
    repeat = {}
    for engine in ("looped", "batched"):
        srv = fresh(engine)
        repeat[engine] = timed_round(srv, f"{engine} engine, repeat")[1]
        del srv
    print(f"training round times, batched / looped / looped / batched: "
          f"{dt:.3f} / {ldt:.3f} / {repeat['looped']:.3f} / "
          f"{repeat['batched']:.3f} s; means batched "
          f"{(dt + repeat['batched']) / 2:.3f} s, looped "
          f"{(ldt + repeat['looped']) / 2:.3f} s")
    ckpt.unlink()
    ckpt.with_name(ckpt.name + ".meta.json").unlink()

    # batched against looped: the same kernels in the same order on the
    # same inputs, so participants and activation counts are equal and
    # each client's run equal; only the mean loss's division (fp32 vs
    # float64) and the aggregation's summation order differ: losses within
    # 1e-6 relative, rescalers within 1e-6, aggregated bf16 adapters within
    # one bf16 ulp (2^-8 relative) of each element
    check(res.participating == lres.participating == list(range(8)),
          "batched and looped rounds differ in participants")
    check(all(np.array_equal(a["pos0"], b["pos0"]) for a, b in
              zip(res.client_freqs, lres.client_freqs)),
          "batched and looped rounds differ in activation counts")
    check(launches == llaunches,
          f"batched and looped rounds differ in launches: {llaunches}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(res.client_losses, lres.client_losses))
    resc_err = max((a.rescaler["pos0"] - b.rescaler["pos0"]).abs().max()
                   .item() for a, b in zip(server.clients, looped.clients))
    over, n_diff, n_all, max_d = 0, 0, 0, 0.0
    for (_, a), (_, b) in zip(_paths(server.global_lora),
                              _paths(looped.global_lora)):
        d = (a.float() - b.float()).abs()
        over += int((d > 2.0 ** -8 * b.float().abs()).sum())
        n_diff += int((d > 0).sum())
        n_all += d.numel()
        max_d = max(max_d, d.max().item())
    print(f"training batched vs looped: round time {dt:.3f} vs {ldt:.3f} s; "
          f"losses max rel diff {loss_rel:.3e}, rescalers max |d| "
          f"{resc_err:.3e}, aggregated adapters: {n_diff} of {n_all} "
          f"elements differ (max |d| {max_d:.3e}), {over} beyond one bf16 "
          f"ulp")
    check(loss_rel <= 1e-6, "batched and looped losses differ by > 1e-6")
    check(resc_err <= 1e-6, "batched and looped rescalers differ by > 1e-6")
    check(over == 0, "batched and looped aggregates differ by more than "
          "one bf16 ulp")

    check(all(np.isfinite(res.client_losses)),
          f"training losses not all finite: {res.client_losses}")
    check(sorted(c.k for c in server.clients) == [1, 1, 2, 2, 4, 4, 8, 8],
          "client budgets are not k = 8, 4, 2, 1, two each")
    b_moved = any(bool(leaf.abs().max() > 0) for path, leaf in
                  _paths(server.global_lora) if path[-1] == "b")
    check(b_moved, "no global LoRA b leaf moved off zero")
    for c, r0 in zip(server.clients, resc0):
        check(not torch.equal(c.rescaler["pos0"], r0),
              f"client {c.client_id}: learnable rescaler did not move")
    for name in ("lora_matmul", "lora_matmul_experts", "topk_router",
                 "flash_attention"):
        check(launches[name] > 0, f"training round launched no {name}")
    for name in ("ragged_gather", "ragged_expert_matmul", "ragged_combine",
                 "adaptive_topk_router"):
        check(launches[name] == 0, f"training round launched {name}")
    # the round's global adapter and one client's rescaler per tier, for
    # the LoRA serving phase's FLAME pipeline
    adapter = (server.global_lora,
               {c.k: c.rescaler for c in reversed(server.clients)})
    del exp, server, looped, start_lora
    return launches, adapter


def _two_layer_experiment(cfg2, params, dev, num_clients=8, **fed_kw):
    """An experiment on the 2-layer full-width model: ``num_clients``
    clients (8 by default), a corpus of 20 examples of 64 tokens per
    client, batch 8."""
    from repro_torch.configs import FederatedConfig, TrainConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.federated.simulation import build_experiment
    return build_experiment(
        cfg2, fed=FederatedConfig(num_clients=num_clients, **fed_kw),
        tc=TrainConfig(batch_size=8),
        data=DataConfig(vocab_size=512, n_examples=20 * num_clients,
                        seq_len=64),
        base_params=params, device=dev)


def resume_phase(torch, cfg2, params, dev, check) -> None:
    """Two default-engine rounds straight through against one round, a
    checkpoint, a fresh server's restore and the second round (8 clients,
    participation 0.5).  The resumed round replays the participant stream
    and restores the state bit for bit, so it runs the same ops on the
    same inputs: the same participants and round index, and the global
    LoRA and rescalers within one bf16 ulp (2^-8 relative) of the straight
    run's."""
    ckpt = ROOT / "build" / "chip_smoke" / "resume.npz"
    kw = dict(rounds=2, participation=0.5)
    t0 = time.perf_counter()
    straight = _two_layer_experiment(cfg2, params, dev, **kw)
    full = straight.server.run()
    first = _two_layer_experiment(cfg2, params, dev, **kw)
    first.server.run_round(0)
    first.server.save_checkpoint(str(ckpt))
    resumed = _two_layer_experiment(cfg2, params, dev, **kw)
    rest = resumed.server.run(resume_from=str(ckpt))
    torch.cuda.synchronize()
    ckpt.unlink()
    ckpt.with_name(ckpt.name + ".meta.json").unlink()
    check([r.round_idx for r in rest] == [1], "the resumed run did not "
          "start at round 1")
    check(rest[0].participating == full[1].participating,
          "resumed and straight runs sample different participants")
    worst = 0.0
    pairs = list(zip(_paths(resumed.server.global_lora),
                     _paths(straight.server.global_lora)))
    pairs += [(((), a.rescaler["pos0"]), ((), b.rescaler["pos0"]))
              for a, b in zip(resumed.server.clients, straight.server.clients)]
    for (_, a), (_, b) in pairs:
        d = (a.float() - b.float()).abs()
        worst = max(worst, (d / (b.float().abs() + 1e-12)).max().item()
                    if bool((d > 0).any()) else 0.0)
    print(f"resume: participants {full[0].participating} then "
          f"{rest[0].participating}, losses straight "
          f"{np.round(full[1].client_losses, 6).tolist()} resumed "
          f"{np.round(rest[0].client_losses, 6).tolist()}, state max rel "
          f"diff {worst:.3e} ({time.perf_counter() - t0:.1f} s)")
    check(worst <= 2.0 ** -8, "resumed state differs from the straight run "
          "by more than one bf16 ulp")


def baselines_phase(torch, cfg2, params, dev, check) -> None:
    """One default-engine round of each baseline on the 2-layer
    full-width model.  Checks: finite losses; the global tree keeps the
    server rank's shapes; trivial's components above r_min are zero;
    FlexLoRA's scale·A·B equals the rank-r truncation (fp32 SVD) of the
    size-weighted mean ΔW of the clients' trained adapters within 2e-2
    relative Frobenius error per leaf (the clients' factors, the ΔW_i,
    their mean and the refactored A, B are each rounded to bf16, ~4e-3
    relative apiece)."""
    for method in ("trivial", "hlora", "flexlora"):
        exp = _two_layer_experiment(cfg2, params, dev, rounds=1,
                                    method=method)
        srv = exp.server
        shapes = [leaf.shape for _, leaf in _paths(srv.global_lora)]
        seen = {}
        aggregate = srv._aggregate

        def capture(loras, freqs, sizes, parts):
            seen.update(loras=loras, sizes=sizes)
            return aggregate(loras, freqs, sizes, parts)

        srv._aggregate = capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = srv.run_round(0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(all(np.isfinite(res.client_losses)),
              f"{method}: losses not all finite {res.client_losses}")
        check([leaf.shape for _, leaf in _paths(srv.global_lora)] == shapes,
              f"{method}: the global tree lost the server rank's shapes")
        check(all(bool(torch.isfinite(leaf).all())
                  for _, leaf in _paths(srv.global_lora)),
              f"{method}: non-finite global adapter")
        ranks = sorted({c.rank for c in srv.clients})
        extra = ""
        if method == "trivial":
            r_min = ranks[0]
            for path, leaf in _paths(srv.global_lora):
                tail = (leaf[..., r_min:] if path[-1] == "a"
                        else leaf[..., r_min:, :])
                check(float(tail.abs().max()) == 0.0,
                      f"trivial: {'/'.join(path)} nonzero above r_min")
            extra = f", components above r_min={r_min} zero"
        if method == "flexlora":
            errs = _flexlora_errors(torch, srv, seen["loras"], seen["sizes"])
            extra = (f", scale·A·B vs rank-{ranks[-1]} truncation of the "
                     f"mean ΔW: rel Frobenius err max {max(errs):.3e} over "
                     f"{len(errs)} leaves")
            check(max(errs) <= 2e-2, "flexlora: scale·A·B differs from the "
                  "truncated mean ΔW by more than 2e-2")
        print(f"baseline {method}: ranks {ranks}, {len(res.participating)} "
              f"clients, mean loss {np.mean(res.client_losses):.4f}, round "
              f"{dt:.3f} s{extra}")
        del exp, srv, seen


def memory_phase(torch, cfg2, params, dev, check) -> None:
    """The memory a FLAME round takes above its start, on both engines, as
    the participant count grows (2-layer full-width model, 8, 32 and 64
    clients, all participating, four budget cohorts), and what it still
    holds once it has returned (the new global adapter).  The looped engine
    keeps every participant's trained adapters until it aggregates; the
    batched engine keeps one cohort's (stacked in, stacked out) plus the
    fp32 streaming accumulator.  Both engines run the same steps, so the
    losses must agree within 1e-6 relative."""
    import gc

    from repro_torch.federated.cohort import build_cohorts
    tree_mib = None
    for n in (8, 32, 64):
        peak, left, loss = {}, {}, {}
        for engine in ("looped", "batched"):
            exp = _two_layer_experiment(cfg2, params, dev, num_clients=n,
                                        rounds=1, round_engine=engine)
            srv = exp.server
            if tree_mib is None:
                tree_mib = sum(leaf.numel() * leaf.element_size() for _, leaf
                               in _paths(srv.global_lora)) / 2 ** 20
            # what an earlier phase left in reference cycles is freed
            # first, so it is neither in the base nor freed mid-round
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = srv.run_round(0)
            torch.cuda.synchronize()
            peak[engine] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            left[engine] = (torch.cuda.memory_allocated() - base) / 2 ** 20
            loss[engine] = res.client_losses
            cohorts = build_cohorts(srv.clients, srv.tc,
                                    rank_of=srv._dist_rank)
            del exp, srv
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(loss["batched"], loss["looped"]))
        print(f"round memory, {n} clients in cohorts of "
              f"{sorted(len(co.members) for co in cohorts)} (adapter tree "
              f"{tree_mib:.1f} MiB bf16): peak above the round's start "
              f"looped {peak['looped']:.1f} MiB, batched "
              f"{peak['batched']:.1f} MiB; held after it looped "
              f"{left['looped']:.1f} MiB, batched {left['batched']:.1f} MiB; "
              f"losses max rel diff {rel:.3e}")
        check(all(np.isfinite(loss["batched"])),
              f"round memory, {n} clients: losses not all finite")
        check(rel <= 1e-6, f"round memory, {n} clients: batched and looped "
              "losses differ by > 1e-6")


TRAFFIC_SLOTS = (8, 8, 4, 4, 2, 2, 1, 1)
TRAFFIC_SLO_MS = {8: 200.0, 4: 400.0, 2: 1000.0, 1: 5000.0}


def _traffic_trace(cfg, rate=float("inf"), n=24, new=16):
    """The traffic phase's workload: 192/320-token prompts opening with one
    of two 128-token system prompts, a quarter of the requests at each of
    k = 8, 4, 2, 1, seed 0."""
    from repro_torch.serving import WorkloadConfig, make_trace
    return make_trace(WorkloadConfig(
        n_requests=n, rate=rate, prompt_lens=(192, 320), new_tokens=(new,),
        tier_mix=((8, 0.25), (4, 0.25), (2, 0.25), (1, 0.25)),
        shared_prefix_len=128, n_shared_prefixes=2, seed=0,
        vocab_size=cfg.vocab_size))


def _hit_rids(reqs):
    """Requests whose (system prompt, tier) an earlier request of the
    trace already carried: the ones the tier-salted prefix cache can
    serve."""
    seen, hits = set(), []
    for r in reqs:
        key = (r.prompt[:128].tobytes(), r.k)
        if key in seen:
            hits.append(r.rid)
        seen.add(key)
    return hits


def _suffix_vs_cold(torch, cfg, params, reqs, dev):
    """Per (system prompt, tier) group of ``reqs``: the first prompt
    prefilled cold and written into a prefix-cached pool, then every later
    prompt of the group prefilled over its suffix against the attached
    pages, and cold, alone and as a batch of two copies of itself (the
    same math at another GEMM shape: the floor of shape-dependent
    rounding).  Returns one dict per follower: the suffix step's last
    logits against the cold ones (relative L2 error, max |difference|,
    argmax agreement), the cold top-2 margin, and the same error and
    agreement for the two cold shapes."""
    from repro_torch.models import model as model_lib
    from repro_torch.serving import BlockPool
    pool = BlockPool(cfg, 2, 512, block_size=16, prefix_cache=True,
                     device=dev)
    groups = {}
    for r in reqs:
        groups.setdefault((r.prompt[:128].tobytes(), r.k), []).append(r)

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    out = []
    with torch.inference_mode():
        for (_, k), rs in groups.items():
            salt = str(k).encode()
            for i, r in enumerate(rs):
                L = r.prompt_len
                full = torch.as_tensor(r.prompt[None], dtype=torch.int64,
                                       device=dev)
                cold, piece = model_lib.prefill(cfg, params, full, k=k)
                s = pool.allocate()
                pool.reserve(s, L)
                # attach, then scatter past the matched span (the engine's
                # order)
                covered, ready = pool.attach_prefix(s, r.prompt, L, salt)
                if i == 0:
                    pool.write([s], piece, [L], starts=[covered])
                    pool.release(s)          # its blocks stay cached
                    continue
                st = min(ready // 16 * 16, L - 1)
                nb = -(-st // 16)
                logits, _ = model_lib.prefill_suffix(
                    cfg, params, full[:, st:], [st], [L - st], pool.cache,
                    torch.as_tensor(pool.block_table[s:s + 1, :nb],
                                    device=dev),
                    page_span=nb * 16, k=k)
                pool.release(s)
                pair, _ = model_lib.prefill(cfg, params, full.repeat(2, 1),
                                            k=k)
                a, b, c = (t[0, 0].float() for t in (logits, cold, pair))
                top = b.topk(2).values
                out.append({
                    "rid": r.rid, "rel": rel(a, b),
                    "maxdiff": (a - b).abs().max().item(),
                    "agree": bool(a.argmax() == b.argmax()),
                    "margin": (top[0] - top[1]).item(),
                    "floor_rel": rel(c, b),
                    "floor_agree": bool(c.argmax() == b.argmax())})
    return out


def _recorded(torch, fn):
    """``fn()`` with every kernel wrapper of ``repro_torch.kernels.backend``
    and ``attention.suffix_attention`` recording its calls.  Returns
    (``fn()``'s result, [(name, args, kwargs, output), ...]); a
    ``suffix_attention`` call records its row pages (gathered at the call,
    before the step's write) in place of the pool and block table."""
    from repro_torch.kernels import backend
    from repro_torch.models import attention
    calls, saved = [], []

    def wrap(mod, name, prep=None):
        orig = getattr(mod, name)
        saved.append((mod, name, orig))

        def rec(*args, **kw):
            kept = prep(*args) if prep else args
            out = orig(*args, **kw)
            calls.append((name, kept, kw, out))
            return out
        setattr(mod, name, rec)

    for name in ("flash_attention", "router", "adaptive_router",
                 "ragged_gather", "ragged_expert_matmul", "ragged_combine",
                 "lora_matmul", "lora_matmul_experts"):
        wrap(backend, name)
    wrap(attention, "suffix_attention",
         lambda q, k, v, kp, vp, tbl, plen, span: (
             q, k, v, attention.paged_gather(kp, tbl, span),
             attention.paged_gather(vp, tbl, span), plen))
    try:
        return fn(), calls
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def _suffix_group_kernels(torch, cfg, params, reqs, dev, check, kc, what):
    """The suffix step's kernels at the shapes the traffic engine gives
    them, each held against its plain version on the same inputs.

    On a prefix-cached engine of the traffic phase's shape, per group a
    leader prompt (the trace's first system prompt and a seeded tail) is
    prefilled cold and written; two followers are then attached and run
    through the engine's own suffix call (``_prefill_suffix_group``): two
    192-token prompts at k = 8 (flash over T = 128 + 64 rows), two
    320-token prompts at k = 4 (T = 128 + 192), and one of each at k = 2,
    whose padding columns the per-token router sends to no expert.  Every
    wrapper call of those steps (every layer) is recorded and checked:
    flash over the laid-out rows (zero queries at the prefix positions)
    against ``ref.flash_attention_ref``; both routers (mask and counts
    exact, weights within 1e-6); the gather exact; the grouped matmul and
    the combine with ``kc["close"]``; and each layer's ``suffix_attention``
    (the pages, layout and flash) against the plain ``verify_attention``
    on the same pages, with ``kc["close"]``.  One layer's suffix attention
    at T = 320 is timed against its flash launch and ``verify_attention``.
    """
    from repro_torch.kernels import backend, ref
    from repro_torch.models import attention
    from repro_torch.models import model as model_lib
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.engine import _tier_salt
    eng = ServingEngine(cfg, params, num_slots=8, slot_len=512,
                        slot_k=TRAFFIC_SLOTS, block_size=16,
                        prefix_cache=True)
    pool, bs = eng.pool, 16
    system = reqs[0].prompt[:128]
    rng = np.random.default_rng(11)

    def prompt(L):
        return np.concatenate([system, rng.integers(
            0, cfg.vocab_size, (L - 128,))]).astype(np.int32)

    def claim(L, toks, k):
        s = pool.allocate()
        pool.reserve(s, L + 1)
        covered, ready = pool.attach_prefix(s, toks, L, _tier_salt(k))
        return s, covered, ready

    layers = cfg.num_layers
    for kk, lens, masked in ((8, (192, 192), False), (4, (320, 320), False),
                             (2, (192, 320), True)):
        with torch.inference_mode():
            lead = prompt(192)
            s0, cov0, _ = claim(192, lead, kk)
            _, piece = model_lib.prefill(
                cfg, params, torch.as_tensor(lead[None], dtype=torch.int64,
                                             device=dev), k=kk)
            pool.write([s0], piece, [192], starts=[cov0])
            items = []
            for i, L in enumerate(lens):
                r = Request(rid=i, prompt=prompt(L), max_new_tokens=1, k=kk)
                s, covered, ready = claim(L, r.prompt, kk)
                check(covered == ready == 128, f"{what} suffix group k={kk}: "
                      f"{covered} tokens matched, {ready} ready, not 128")
                items.append((r, s, min(ready // bs * bs, L - 1), covered))
            _, calls = _recorded(
                torch, lambda: eng._prefill_suffix_group(items, kk))
        T = max(lens)            # page_span 128 + the longest suffix
        names = [c[0] for c in calls]
        router = "adaptive_router" if masked else "router"
        for name in ("flash_attention", "suffix_attention", router,
                     "ragged_gather", "ragged_combine"):
            check(names.count(name) == layers, f"{what} suffix group k={kk}:"
                  f" {names.count(name)} {name} calls for {layers} layers")
        check(names.count("ragged_expert_matmul") == 3 * layers,
              f"{what} suffix group k={kk}: ragged_expert_matmul calls")
        worst = {}
        for name, a, kw, out in calls:
            tag = f"{what} suffix group k={kk} T={T}: {name}"
            if name == "flash_attention":
                check(tuple(a[0].shape[:2]) == (2, T),
                      f"{tag} at {tuple(a[0].shape)}")
                q, k, v = (t.transpose(1, 2) for t in a)
                want = ref.flash_attention_ref(
                    q, k, v, causal=kw["causal"], window=kw["window"],
                    softcap=kw["softcap"]).transpose(1, 2)
                err = kc["close"](out, want, tag)
            elif name == "suffix_attention":
                err = kc["close"](out, attention.verify_attention(
                    *a, logit_softcap=kw["logit_softcap"]), tag)
            elif name == "router":
                err = kc["router"](out, ref.topk_router_ref(*a), tag)
            elif name == "adaptive_router":
                err = kc["router"](out, ref.adaptive_topk_router_ref(*a), tag)
            elif name == "ragged_gather":
                check(torch.equal(out, ref.ragged_gather_ref(*a)),
                      f"{tag} differs from the plain version")
                err = 0.0
            elif name == "ragged_expert_matmul":
                err = kc["close"](out, ref.ragged_expert_matmul_ref(*a), tag)
            else:
                err = kc["close"](out, ref.ragged_combine_ref(*a), tag)
            worst[name] = max(worst.get(name, 0.0), err)
        rows = calls[names.index("ragged_gather")][1][1].shape[0]
        print(f"traffic {what} suffix group k={kk}, prompts {lens} "
              f"({'masked, per-token router' if masked else 'static router'}"
              f"; flash B=2 T={T}, {rows} ragged rows at layer 0), every "
              f"layer against its plain version, max |kernel - plain|: "
              + ", ".join(f"{n} {e:.3e}" for n, e in worst.items()))
        if T == 320:
            sa = calls[names.index("suffix_attention")][1]
            fa = calls[names.index("flash_attention")][1]
            print(f"traffic {what} suffix attention, one layer at B=2 S=192 "
                  f"over 128 cached positions: the flash launch over the "
                  f"laid-out T={T} rows (a cold prefill's shape) "
                  f"{kc['time_ms'](lambda: backend.flash_attention(*fa)):.4f}"
                  f" ms; plain verify_attention over the S rows "
                  f"{kc['time_ms'](lambda: attention.verify_attention(*sa)):.4f}"
                  f" ms")
        for s in [s0] + [it[1] for it in items]:
            pool.release(s)
    pool.check_invariants()
    check(pool.blocks_in_use == 0, f"{what} suffix groups: blocks held")
    del eng


def traffic_phase(torch, cfg, params, dev, check, kc):
    """The serving engine's traffic layer at FULL width (bf16): prefix
    cache with suffix-only prefill, SLO admission (EDF) and decode
    preemption, with the tracer, the metrics registry and expert telemetry,
    on the shared-prefix trace as a closed batch and as Poisson arrivals at
    half the closed batch's request rate, against a cold engine on the same
    requests; then the suffix step's kernels against their plain versions
    at its shapes (:func:`_suffix_group_kernels`).  Returns the kernel
    launches of the checked closed-batch run (the counts zeroed just
    before it) and its number of prefill calls and decode steps."""
    import os

    from repro_torch.kernels import _build
    from repro_torch.obs import MetricsRegistry, Tracer, validate_chrome_trace
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.workload import percentile
    base = dict(num_slots=8, slot_len=512, slot_k=TRAFFIC_SLOTS, block_size=16)

    def traffic_engine(obs):
        """The engine, its tracer and its metrics registry (None when
        ``obs`` is off)."""
        tracer, reg = (Tracer(), MetricsRegistry()) if obs else (None, None)
        return ServingEngine(cfg, params, **base, prefix_cache=True,
                             slo_ms=TRAFFIC_SLO_MS, preemption=True,
                             tracer=tracer, metrics=reg,
                             expert_telemetry=obs), tracer, reg

    def check_run(name, eng, rep, n):
        summ = rep.summary()
        check(summ["n_requests"] == n and summ["gen_tokens"] == n * 16,
              f"traffic {name}: {summ['n_requests']} requests, "
              f"{summ['gen_tokens']} tokens")
        for c in rep.completions:
            check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
                  f"traffic {name}: request {c.rid} token ids out of range")
        eng.pool.check_invariants()
        check(eng.pool.blocks_in_use == 0,
              f"traffic {name}: {eng.pool.blocks_in_use} blocks still held")
        return summ

    def tier_line(rep):
        by = {}
        for c in rep.completions:
            by.setdefault(c.k, []).append(c.ttft * 1e3)
        return ", ".join(f"k={k}: {percentile(v, 50):.1f}/"
                         f"{percentile(v, 95):.1f}"
                         for k, v in sorted(by.items(), reverse=True))

    t_phase = time.perf_counter()
    reqs = _traffic_trace(cfg)
    hits = _hit_rids(reqs)
    cold_eng = ServingEngine(cfg, params, **base)
    cold = cold_eng.run(_traffic_trace(cfg))
    check_run("cold", cold_eng, cold, len(reqs))
    # closed batch, in the order: no observability, observability (the
    # checked run, launch counts zeroed just before it), no observability
    off = []
    for i in range(2):
        if i == 1:
            on_eng, tracer, reg = traffic_engine(obs=True)
            torch.cuda.synchronize()
            _build.reset_launches()
            on = on_eng.run(_traffic_trace(cfg))
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        eng, _, _ = traffic_engine(obs=False)
        rep = eng.run(_traffic_trace(cfg))
        off.append(check_run(f"closed, no observability {len(off)}", eng,
                             rep, len(reqs)))
        del eng
    summ = check_run("closed", on_eng, on, len(reqs))
    n_prefill, n_decode = len(on.prefill_s), summ["decode_steps"]

    # prefix cache: real hits, and fewer prompt tokens prefilled than cold
    check(on.prefix["hit_tokens"] > 0, "traffic: no prefix-cache hits")
    check(on.prefill_tokens < cold.prefill_tokens,
          f"traffic: {on.prefill_tokens} prompt tokens prefilled, cold "
          f"{cold.prefill_tokens}")
    ct, tt = cold.tokens_by_rid(), on.tokens_by_rid()
    first = [int(tt[r][0] == ct[r][0]) for r in hits]
    same = [int((tt[r] == ct[r]).all()) for r in ct]
    print(f"traffic prefix cache: {json.dumps(on.prefix)}; prompt tokens "
          f"prefilled {on.prefill_tokens} (cold {cold.prefill_tokens}); "
          f"{len(hits)} hit requests, first token equal to cold on "
          f"{sum(first)}/{len(first)} (differ: rids "
          f"{[r for r, f in zip(hits, first) if not f]}), all tokens on "
          f"{sum(same)}/{len(same)}")
    sv = _suffix_vs_cold(torch, cfg, params, reqs, dev)
    for d in sv:
        print(f"traffic suffix vs cold, rid {d['rid']}: rel L2 "
              f"{d['rel']:.3e}, max |d| {d['maxdiff']:.3e}, argmax "
              f"{'equal' if d['agree'] else 'differs'}, cold top-2 margin "
              f"{d['margin']:.3e}; cold B=1 vs B=2: rel L2 "
              f"{d['floor_rel']:.3e}, argmax "
              f"{'equal' if d['floor_agree'] else 'differs'}")
    errs = [d["rel"] for d in sv]
    print(f"traffic: suffix-prefill last logits vs cold prefill, bf16, "
          f"{len(sv)} requests: rel L2 median {np.median(errs):.3e} max "
          f"{max(errs):.3e}, argmax agreement "
          f"{sum(d['agree'] for d in sv)}/{len(sv)}; cold at two batch "
          f"shapes: rel L2 median "
          f"{np.median([d['floor_rel'] for d in sv]):.3e}, argmax agreement "
          f"{sum(d['floor_agree'] for d in sv)}/{len(sv)}")
    # the suffix step and the cold prefill run the same kernels with the
    # same per-row math, and no kernel mixes rows, so a hit request's
    # first token is the cold run's
    check(sum(first) == len(first),
          f"traffic: first tokens of hit requests agree with the cold run "
          f"on {sum(first)}/{len(first)}")
    _suffix_group_kernels(torch, cfg, params, reqs, dev, check, kc,
                          "bf16 FULL")
    # the engine's trace, written and read back
    os.makedirs(ROOT / "build" / "chip_smoke", exist_ok=True)
    path = str(ROOT / "build" / "chip_smoke" / "traffic_trace.json")
    trace = json.load(open(tracer.dump(path)))
    errors = validate_chrome_trace(trace)
    check(errors == [], f"traffic trace invalid: {errors[:3]}")
    spans = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "X" and e["pid"] == 2:
            spans.setdefault(e["tid"], set()).add(e["name"])
    for r in reqs:
        check({"queued", "prefill", "decode"} <= spans.get(r.rid, set()),
              f"traffic trace: request {r.rid} lacks a lifecycle span")
    snap = reg.snapshot()
    for key in ("serving.kv.blocks_peak", "serving.kv.prefix.hit_tokens",
                "serving.kv.swap_outs", "serving.scheduler.queue_depth",
                "serving.decode_step_ms", "serving.prefill_ms"):
        check(key in snap, f"traffic metrics lack {key}")
    check(snap["serving.decode_step_ms"]["count"] == n_decode,
          "traffic metrics: decode histogram count")
    # each layer routed every active slot's k on every decode step
    want = sum(c.k * (c.n_generated - 1) for c in on.completions)
    for row in on.expert_load["totals"]["pos0"]:
        check(sum(row) == want, f"traffic expert load: a layer counts "
              f"{sum(row)} assignments, the decode steps routed {want}")
    # bf16: both steps attend through the flash kernel over the same keys
    # at the same positions, and the pages a suffix reads hold the bits a
    # cold prefill of the same head writes; only the dense GEMMs see
    # another row count, which a library may sum in another order.  The
    # design is bit-exact (0 in every run on the H100), so every row is
    # bounded, at 1e-3: room for such a reorder, none for a wrong row
    check(max(errs) <= 1e-3, "traffic: suffix-prefill logits differ from "
          "the cold prefill by more than 1e-3 relative in some row")
    pt = on.per_tier()
    print(f"traffic closed batch: {summ['gen_tokens']} tokens in "
          f"{summ['wall_s']:.3f} s, {summ['gen_tokens_per_s']:.1f} tokens/s "
          f"({summ['requests_per_s']:.2f} requests/s), decode step p50 "
          f"{summ['decode_step_ms_p50']:.2f} ms over {n_decode} steps, "
          f"{n_prefill} prefill calls (cold {len(cold.prefill_s)}), "
          f"preemptions {on.preemptions}, TTFT p50/p95 ms {tier_line(on)}, "
          f"SLO attainment " + ", ".join(
              f"k={k}: {v['slo_attainment']:.2f}"
              for k, v in sorted(pt.items(), key=lambda kv: -int(kv[0]))))
    cs = cold.summary()
    print(f"traffic cold engine: {cs['gen_tokens_per_s']:.1f} tokens/s, "
          f"TTFT p50/p95 ms {tier_line(cold)}, decode step p50 "
          f"{cs['decode_step_ms_p50']:.2f} ms")
    print(f"traffic observability overhead: {summ['gen_tokens_per_s']:.1f} "
          f"tokens/s, decode step p50 {summ['decode_step_ms_p50']:.2f} ms "
          f"with tracer + metrics + expert telemetry; without (runs before "
          f"and after) " + " / ".join(
              f"{o['gen_tokens_per_s']:.1f} tokens/s, "
              f"{o['decode_step_ms_p50']:.2f} ms" for o in off)
          + f"; {len(trace['traceEvents'])} trace events")
    print(f"traffic launches: {json.dumps(launches)}")
    del on_eng, cold_eng

    rate = 0.5 * summ["requests_per_s"]
    eng, tracer, _ = traffic_engine(obs=True)
    rep = eng.run(_traffic_trace(cfg, rate=rate))
    ps = check_run("poisson", eng, rep, len(reqs))
    check(validate_chrome_trace(tracer.to_dict()) == [],
          "traffic poisson trace invalid")
    print(f"traffic poisson at {rate:.3f} requests/s (half the closed "
          f"batch's): {ps['gen_tokens_per_s']:.1f} tokens/s over "
          f"{ps['wall_s']:.3f} s, decode step p50 "
          f"{ps['decode_step_ms_p50']:.2f} ms, preemptions "
          f"{rep.preemptions}, prefix {json.dumps(rep.prefix)}, TTFT "
          f"p50/p95 ms {tier_line(rep)}")
    del eng
    torch.cuda.empty_cache()
    print(f"traffic phase (a): {time.perf_counter() - t_phase:.1f} s")
    return launches, n_prefill, n_decode


def preemption_phase(torch, cfg, params, dev, check) -> None:
    """Forced preemption at FULL width: two slots at k = 8 and 1, and a
    pool of 32 blocks, so the economy request's reservation (a 64-token
    prompt and 384 new tokens: 28 blocks) starves a premium arrival 50 ms
    later whose TTFT target is already missed.  The engine swaps economy
    out to the host and resumes it; both requests' tokens must equal their
    solo runs on the same engine settings (the swap is a bit copy, and
    ragged dispatch keeps rows isolated)."""
    from repro_torch.serving import Request, ServingEngine
    t_phase = time.perf_counter()
    rng = np.random.default_rng(5)
    eco, prm = (rng.integers(0, cfg.vocab_size, (64,)).astype(np.int32)
                for _ in range(2))
    kw = dict(num_slots=2, slot_len=512, slot_k=(8, 1), block_size=16,
              num_blocks=32, preemption=True, slo_ms={8: 0.0, 1: 60000.0})

    def e_req():
        return Request(rid=0, prompt=eco, max_new_tokens=384, k=1)

    def p_req(t):
        return Request(rid=1, prompt=prm, max_new_tokens=16, k=8, arrival=t)

    eng = ServingEngine(cfg, params, **kw)
    timed = {"out": [], "in": [], "blocks": []}
    swap_out, swap_in = eng.pool.swap_out, eng.pool.swap_in

    def timed_out(slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = swap_out(slot)
        timed["out"].append((time.perf_counter() - t0) * 1e3)
        timed["blocks"].append(state["n_blocks"])
        return state

    def timed_in(slot, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        swap_in(slot, state)
        torch.cuda.synchronize()
        timed["in"].append((time.perf_counter() - t0) * 1e3)

    eng.pool.swap_out, eng.pool.swap_in = timed_out, timed_in
    rep = eng.run([e_req(), p_req(0.05)])
    by_rid = {c.rid: c for c in rep.completions}
    check(rep.preemptions >= 1, "preemption: no request was preempted")
    check(eng.pool.swap_outs == eng.pool.swap_ins == rep.preemptions,
          f"preemption: {eng.pool.swap_outs} swap-outs, "
          f"{eng.pool.swap_ins} swap-ins, {rep.preemptions} preemptions")
    eng.pool.check_invariants()
    check(eng.pool.blocks_in_use == 0, "preemption: blocks still held")
    block_bytes = eng.pool.block_bytes()
    del eng
    for rid, solo_req in ((0, e_req()), (1, p_req(0.0))):
        solo = ServingEngine(cfg, params, **kw).run([solo_req])
        check(solo.preemptions == 0, "preemption: a solo run was preempted")
        check(bool((solo.completions[0].tokens == by_rid[rid].tokens).all()),
              f"preemption: request {rid}'s tokens differ from its solo run")
    mib = [b * block_bytes / 2 ** 20 for b in timed["blocks"]]
    print(f"preemption: {rep.preemptions} preemption(s), economy preempted "
          f"{by_rid[0].preemptions} time(s), premium TTFT "
          f"{by_rid[1].ttft * 1e3:.1f} ms; swapped "
          + ", ".join(f"{b} blocks = {m:.1f} MiB" for b, m in
                      zip(timed["blocks"], mib))
          + f" (block {block_bytes / 2 ** 20:.3f} MiB); swap-out ms "
          + ", ".join(f"{t:.3f}" for t in timed["out"]) + "; swap-in ms "
          + ", ".join(f"{t:.3f}" for t in timed["in"])
          + "; both requests' tokens equal their solo runs "
          f"({time.perf_counter() - t_phase:.1f} s)")


def traffic_fp32_phase(torch, cfg2, dev, check, kc) -> None:
    """The exact semantics on the card: a 2-layer full-width model in
    float32, the cold paged engine against the traffic engine (prefix
    cache, EDF, preemption) on a shared-prefix mixed-tier closed batch:
    identical greedy tokens for every request; the suffix step's last
    logits against a cold prefill within 1e-4 relative (only the
    summation order differs); and the suffix step's kernels against their
    plain versions (:func:`_suffix_group_kernels`, float32)."""
    from repro_torch.models import model as model_lib
    from repro_torch.serving import ServingEngine
    c32 = cfg2.replace(dtype="float32")
    params = model_lib.init_params(
        c32, torch.Generator(device=dev).manual_seed(3), dev)
    base = dict(num_slots=8, slot_len=512, slot_k=TRAFFIC_SLOTS, block_size=16)
    cold_eng = ServingEngine(c32, params, **base)
    cold = cold_eng.run(_traffic_trace(c32, n=16, new=8))
    eng = ServingEngine(c32, params, prefix_cache=True, preemption=True,
                        slo_ms={8: 0.0, 4: 0.0, 2: 60000.0, 1: 60000.0},
                        **base)
    warm = eng.run(_traffic_trace(c32, n=16, new=8))
    ct, wt = cold.tokens_by_rid(), warm.tokens_by_rid()
    check(sorted(ct) == sorted(wt), "traffic fp32: request sets differ")
    diff = [r for r in ct if not np.array_equal(ct[r], wt[r])]
    check(not diff, f"traffic fp32: requests {diff} differ from the cold "
          "engine")
    check(warm.prefix["hit_tokens"] > 0, "traffic fp32: no prefix hits")
    eng.pool.check_invariants()
    check(eng.pool.blocks_in_use == 0, "traffic fp32: blocks still held")
    sv = _suffix_vs_cold(torch, c32, params,
                         _traffic_trace(c32, n=16, new=8), dev)
    errs = [d["rel"] for d in sv]
    print(f"traffic fp32 (2 layers): {len(ct)} requests token-identical to "
          f"the cold engine, prefix {json.dumps(warm.prefix)}, preemptions "
          f"{warm.preemptions}, prompt tokens prefilled "
          f"{warm.prefill_tokens} (cold {cold.prefill_tokens}); suffix "
          f"logits vs cold rel L2 max {max(errs):.3e}, argmax agreement "
          f"{sum(d['agree'] for d in sv)}/{len(sv)}")
    check(max(errs) <= 1e-4, "traffic fp32: suffix-prefill logits differ "
          "from the cold prefill by more than 1e-4 relative")
    _suffix_group_kernels(torch, c32, params,
                          _traffic_trace(c32, n=16, new=8), dev, check, kc,
                          "fp32 2-layer")
    del eng, cold_eng, params
    torch.cuda.empty_cache()


SPEC_W = 4
SPEC_SAMPLER = dict(kind="top_p", temperature=0.8, top_p=0.9)


def _spec_requests(cfg, n=16, new=16, seed=0):
    """The serving phase's workload: 128/256-token prompts in turn, tiers
    (8,8,4,4,2,2,1,1) in turn, ``new`` new tokens, seeded."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, ((128, 256)[i % 2],)).astype(np.int32),
        max_new_tokens=new, k=TRAFFIC_SLOTS[i % 8]) for i in range(n)]


class _SpecRecorder:
    """What one engine run emitted each token from, for the near-tie rule:
    prefill and plain-decode rows (host) through the engine's ``_emit``,
    and each speculative round's verify rows (kept on the device) through
    ``speculative.verify_window``, with the round's drafts, draft logits,
    accepts and active slots; plus the hand-kernel launches of every
    round and plain decode step."""

    def __init__(self, eng):
        from repro_torch.kernels import _build
        from repro_torch.serving import speculative
        self.eng, self.mod = eng, speculative
        self.rows, self.rounds = {}, []
        self.launches = {"round": [], "decode": []}
        emit, decode = eng._emit, eng._decode_once
        orig = self._orig = speculative.verify_window

        def rec_emit(slot, a, row, drawn, report):
            self.rows[a.req.rid, len(a.tokens)] = row
            emit(slot, a, row, drawn, report)

        def rec_verify(d_toks, d_logits, t_logits, sc, u, u_last):
            out = orig(d_toks, d_logits, t_logits, sc, u, u_last)
            active = [(s, a.req.rid, len(a.tokens), eng.slot_k[s])
                      for s, a in enumerate(eng._active) if a is not None]
            for s, rid, base, _ in active:
                for j in range(t_logits.shape[1]):
                    self.rows[rid, base + j] = (len(self.rounds), s, j)
            self.rounds.append((t_logits, d_logits, d_toks, out[2], active))
            return out

        def counted(fn, kind):
            def run(report):
                n0, r0 = sum(_build.LAUNCHES.values()), report.spec_rounds
                fn(report)
                if kind == "decode" or report.spec_rounds > r0:
                    self.launches[kind].append(
                        sum(_build.LAUNCHES.values()) - n0)
            return run

        eng._emit = rec_emit
        eng._decode_once = counted(decode, "decode")
        if eng._spec is not None:
            eng._spec.round = counted(eng._spec.round, "round")
        speculative.verify_window = rec_verify

    def close(self):
        """Restore ``verify_window`` and let go of the engine (and so of
        its weights and pool); the recorded rows stay."""
        self.mod.verify_window = self._orig
        self.eng = None

    def row(self, rid, t):
        v = self.rows[rid, t]
        if isinstance(v, tuple):
            i, s, j = v
            return self.rounds[i][0][s, j].float().cpu().numpy()
        return v

    def per_tier(self):
        """{tier: (drafted, accepted)} over the run's rounds."""
        out = {}
        for _, _, d_toks, n_acc, active in self.rounds:
            n = n_acc.cpu().numpy()
            for s, _, _, tier in active:
                d, a = out.get(tier, (0, 0))
                out[tier] = (d + d_toks.shape[1], a + int(n[s]))
        return out

    def k1_misses(self):
        """Each rejected draft of a k = 1 slot: (verify top-1 logit minus
        the draft token's, max |draft row - verify row|) at the first
        rejected position; a near-tie when the first is no larger."""
        out = []
        for lv, ql, d_toks, n_acc, active in self.rounds:
            n = n_acc.cpu().numpy()
            W = d_toks.shape[1]
            for s, _, _, tier in active:
                j = int(n[s])
                if tier != 1 or j == W:
                    continue
                v, q = lv[s, j].float(), ql[s, j].float()
                gap = (v.max() - v[int(d_toks[s, j])]).item()
                out.append((gap, (q - v).abs().max().item()))
        return out


def _first_divergences(plain_rec, plain, other_rec, other):
    """Per request whose tokens differ: (rid, first differing position,
    the plain logits' top-2 gap there, max |other - plain| logit)."""
    out = []
    for rid, a in plain.items():
        diff = np.nonzero(a != other[rid])[0]
        if not len(diff):
            continue
        t = int(diff[0])
        p, o = plain_rec.row(rid, t), other_rec.row(rid, t)
        top = np.sort(p)[-2:]
        out.append((rid, t, float(top[1] - top[0]),
                    float(np.abs(o - p).max())))
    return out


def _spec_run(torch, eng, reqs):
    """One recorded run: (report, recorder, hand-kernel launches of the
    run, counts zeroed just before it)."""
    from repro_torch.kernels import _build
    rec = _SpecRecorder(eng)
    try:
        torch.cuda.synchronize()
        _build.reset_launches()
        rep = eng.run(reqs)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    finally:
        rec.close()
    return rep, rec, launches


def _spec_round_kernels(torch, cfg, params, dev, check, kc, what,
                        timed=False):
    """Every kernel call of one speculative round with all 8 slots busy —
    W draft steps at k = 1 (the static router at T = 8) and the verify
    step at the tiers (the per-token router at T = 8·(W+1) = 40, budgets
    repeated per slot) — each against its plain version at every layer:
    ``kc["close"]`` at bf16, <= 1e-5 absolute at float32, routers exact
    with weights within 1e-6, the gather exact.  ``timed``: layer 0's
    calls of the first draft step and of the verify step timed beside
    their plain versions, bounds and library calls.  Returns the per-shape
    times."""
    from repro_torch.kernels import ref
    from repro_torch.serving import ServingEngine, SpeculativeConfig
    from repro_torch.serving.engine import ServingReport
    L = cfg.num_layers
    eng = ServingEngine(cfg, params, num_slots=8, slot_len=512,
                        slot_k=TRAFFIC_SLOTS, block_size=16,
                        speculative=SpeculativeConfig(SPEC_W, 1))
    report = ServingReport(completions=[])
    eng._t0 = time.perf_counter()
    for r in _spec_requests(cfg, n=8, new=32, seed=3):
        eng.scheduler.add(r)
    with torch.inference_mode():
        eng._admit(report)
        check(eng.n_active == 8, f"{what} spec kernels: {eng.n_active} slots")
        _, calls = _recorded(torch, lambda: eng._spec.round(report))
        while eng.n_active:
            eng._spec.round(report)
    eng.pool.check_invariants()
    check(eng.pool.blocks_in_use == 0, f"{what} spec kernels: blocks held")
    names = [c[0] for c in calls]
    split = names.index("adaptive_router")
    draft, verify = calls[:split], calls[split:]
    for part, router, n_steps, T in ((draft, "router", SPEC_W, 8),
                                     (verify, "adaptive_router", 1,
                                      8 * (SPEC_W + 1))):
        pn = [c[0] for c in part]
        for name in (router, "ragged_gather", "ragged_combine"):
            check(pn.count(name) == L * n_steps,
                  f"{what} spec {router} part: {pn.count(name)} {name} calls")
        check(pn.count("ragged_expert_matmul") == 3 * L * n_steps and
              len(pn) == 6 * L * n_steps, f"{what} spec {router} part: calls")
        for c in part:
            if c[0] in ("router", "adaptive_router"):
                check(c[1][0].shape[0] == T, f"{what} spec {c[0]} at "
                      f"T={c[1][0].shape[0]}, not {T}")
    check(all(c[1][1] == 1 for c in draft if c[0] == "router"),
          f"{what} spec: a draft router call not at k = 1")

    def close32(got, want, tag):
        err = (got.float() - want.float()).abs().max().item()
        check(err <= 1e-5, f"{tag}: max |kernel - plain| {err:.3e} > 1e-5")
        return err

    close = kc["close"] if cfg.dtype != "float32" else close32
    worst = {}
    for part_name, part in (("draft", draft), ("verify", verify)):
        for name, a, kw, out in part:
            tag = f"{what} spec {part_name} {name}"
            if name == "router":
                err = kc["router"](out, ref.topk_router_ref(*a), tag)
            elif name == "adaptive_router":
                err = kc["router"](out, ref.adaptive_topk_router_ref(*a), tag)
            elif name == "ragged_gather":
                check(torch.equal(out, ref.ragged_gather_ref(*a)),
                      f"{tag} differs from the plain version")
                err = 0.0
            elif name == "ragged_expert_matmul":
                err = close(out, ref.ragged_expert_matmul_ref(*a), tag)
            else:
                err = close(out, ref.ragged_combine_ref(*a), tag)
            key = f"{part_name} {name}"
            worst[key] = max(worst.get(key, 0.0), err)
    print(f"spec {what}: one round (W={SPEC_W} draft steps at k=1, T=8; "
          f"verify at the tiers, T={8 * (SPEC_W + 1)}), every kernel call "
          f"of {L} layers against its plain version, max |kernel - plain|: "
          + ", ".join(f"{n} {e:.3e}" for n, e in worst.items()))
    if not timed:
        return {}
    return {"draft": _time_layer0(torch, draft, kc),
            "verify": _time_layer0(torch, verify, kc)}


def _time_layer0(torch, calls, kc):
    """Layer 0's router, gather, three grouped matmuls and combine of a
    step: kernel, plain and library ms (CUDA events, L2 flushed; the
    grouped matmul's plain version over runs of row blocks,
    :func:`_ragged_mm_plain`) and the bound from these inputs.  Returns {name: (ms, plain_ms, bound_ms,
    bound_by, library_ms)}."""
    from repro_torch.kernels import backend, ref
    t = kc["time_ms"]
    out = {}
    router = calls[0]
    lg = router[1][0]
    T, E = lg.shape
    nbytes = lg.numel() * lg.element_size() + 2 * T * E * 4 + E * 4
    if router[0] == "adaptive_router":
        nbytes += 4 * T
        plain = ref.adaptive_topk_router_ref
    else:
        plain = ref.topk_router_ref
    fn = getattr(backend, router[0])
    out[router[0]] = (t(lambda: fn(*router[1])), t(lambda: plain(*router[1])),
                      *bound_ms(nbytes, 0.0, F32_FLOPS), None)
    x, src, valid = calls[1][1]
    el, D, N = x.element_size(), x.shape[1], src.shape[0]
    used = int(torch.unique(src[valid.bool()]).numel())
    out["ragged_gather"] = (
        t(lambda: backend.ragged_gather(x, src, valid)),
        t(lambda: ref.ragged_gather_ref(x, src, valid)),
        *bound_ms(used * D * el + N * 8 + N * D * el, 0.0, F32_FLOPS),
        t(lambda: torch.index_select(x, 0, src)))
    n_valid = int(valid.sum())
    for label, call in (("w1/w3", calls[2]), ("w2", calls[4])):
        xs, be, w = call[1][:3]
        K, H = w.shape[1], w.shape[2]
        n_exp = int(torch.unique(be).numel())
        peak = BF16_FLOPS if xs.dtype != torch.float32 else F32_FLOPS
        bm = xs.shape[0] // be.shape[0]
        ends = (torch.cumsum(torch.bincount(be.long(), minlength=w.shape[0]),
                             0) * bm).to(torch.int32)
        lib = (t(lambda: torch._grouped_mm(xs, w, offs=ends))
               if hasattr(torch, "_grouped_mm") and xs.dtype != torch.float32
               else None)
        out[f"ragged_expert_matmul {label}"] = (
            t(lambda: backend.ragged_expert_matmul(xs, be, w)),
            t(lambda: _ragged_mm_plain(torch, xs, be, w)),
            *bound_ms((xs.shape[0] * K + n_exp * K * H + xs.shape[0] * H)
                      * xs.element_size(), 2.0 * n_valid * K * H, peak), lib)
    eo, rows, wrank = calls[5][1]
    live = rows[wrank > 0]
    out["ragged_combine"] = (
        t(lambda: backend.ragged_combine(eo, rows, wrank)),
        t(lambda: ref.ragged_combine_ref(eo, rows, wrank)),
        *bound_ms(int(torch.unique(live).numel()) * D * el + rows.numel() * 8
                  + rows.shape[0] * D * el, 2.0 * live.numel() * D,
                  F32_FLOPS), None)
    return out


def speculative_phase(torch, cfg, params, dev, check, kc):
    """Self-speculative decoding (W = 4 drafts at k = 1, one full-k verify)
    at FULL width, bf16, on the serving phase's engine shape and requests:
    (a) greedy — plain paged decode against speculative engines on both
    layouts: tokens equal or the first divergence a near-tie (the plain
    top-2 gap no larger than the largest |verify - plain| logit there),
    acceptance per tier, rounds, draft / verify ms, tokens/s against plain,
    hand-kernel launches per round against per plain decode step, every
    serving kernel launched by the speculative run (counts zeroed just
    before it); (b) every kernel call of one round against its plain
    version, and layer 0's calls timed at the draft and verify shapes;
    (c) sampled (top-p 0.9 at temperature 0.8), plain and speculative:
    reproducible by seed, another seed other tokens, slotted against paged
    agreement printed.  Returns (the speculative run's launches, the
    per-shape times)."""
    from repro_torch.serving import (SamplerConfig, ServingEngine,
                                     SpeculativeConfig)
    t_phase = time.perf_counter()
    L = cfg.num_layers
    base = dict(num_slots=8, slot_len=512, slot_k=TRAFFIC_SLOTS, block_size=16)
    spec = SpeculativeConfig(SPEC_W, 1)
    # warm-up off the clock: the verify step's GEMM shapes are new
    ServingEngine(cfg, params, speculative=spec, **base).run(
        _spec_requests(cfg, n=8, new=6, seed=9))

    runs = {}
    for name, kw in (("plain", {}), ("spec paged", dict(speculative=spec)),
                     ("spec slotted", dict(speculative=spec,
                                           kv_layout="slotted"))):
        eng = ServingEngine(cfg, params, **base, **kw)
        runs[name] = _spec_run(torch, eng, _spec_requests(cfg))
        del eng
    plain_rep, plain_rec, _ = runs["plain"]
    plain_toks = plain_rep.tokens_by_rid()
    ps = plain_rep.summary()
    per_decode = float(np.mean(plain_rec.launches["decode"]))
    for name in ("spec paged", "spec slotted"):
        rep, rec, launches = runs[name]
        s = rep.summary()
        check(s["n_requests"] == 16 and s["gen_tokens"] == 16 * 16,
              f"spec {name}: {s['n_requests']} requests, {s['gen_tokens']} "
              "tokens")
        toks = rep.tokens_by_rid()
        div = _first_divergences(plain_rec, plain_toks, rec, toks)
        for rid, t, gap, d in div:
            check(gap <= d, f"spec {name}: request {rid} differs from plain "
                  f"decode at position {t}, where the plain top-2 gap "
                  f"{gap:.3e} exceeds max |verify - plain| {d:.3e} (not a "
                  "near-tie)")
        tiers = rec.per_tier()
        n_draft = sum(int(r[2].shape[1]) for r in rec.rounds)
        n_dec = len(rep.decode_step_s)
        check(len(rec.rounds) == rep.spec_rounds,
              f"spec {name}: {len(rec.rounds)} recorded rounds")
        for kname, n in launches.items():
            if kname.startswith("lora"):
                check(n == 0, f"spec {name} launched {kname}")
            else:
                check(n > 0, f"kernel {kname} was not launched by the "
                      f"speculative run ({name})")
        n_pre = len(rep.prefill_s)
        check(launches["flash_attention"] == L * n_pre,
              f"spec {name}: flash launches")
        check(launches["topk_router"] == L * (n_pre + n_draft),
              f"spec {name}: {launches['topk_router']} static router "
              f"launches for {n_pre} prefill calls and {n_draft} draft steps")
        check(launches["adaptive_topk_router"]
              == L * (rep.spec_rounds + n_dec),
              f"spec {name}: {launches['adaptive_topk_router']} per-token "
              f"router launches for {rep.spec_rounds} verify steps and "
              f"{n_dec} plain decode steps")
        print(f"spec {name} (W={SPEC_W}, draft_k=1), greedy bf16 FULL: "
              f"{16 - len(div)}/16 requests token-identical to plain decode"
              + ("" if not div else " (first divergences: " + "; ".join(
                  f"rid {r} at {t}: plain top-2 gap {g:.3e} <= max |verify"
                  f" - plain| {d:.3e}" for r, t, g, d in div) + ")")
              + f"; acceptance {s['acceptance_rate']:.3f} ("
              + ", ".join(f"k={k}: {a / max(d, 1):.3f}" for k, (d, a) in
                          sorted(tiers.items(), reverse=True))
              + f"), {s['spec_rounds']} rounds + {n_dec} plain steps, draft "
              f"window p50 {s['draft_step_ms_p50']:.2f} ms, verify p50 "
              f"{s['verify_step_ms_p50']:.2f} ms; {s['gen_tokens_per_s']:.1f}"
              f" tokens/s against plain {ps['gen_tokens_per_s']:.1f} ("
              f"decode step p50 {ps['decode_step_ms_p50']:.2f} ms); "
              f"hand-kernel launches per round "
              f"{float(np.mean(rec.launches['round'])):.1f} against "
              f"{per_decode:.1f} per plain decode step")
        misses = rec.k1_misses()
        print(f"spec {name}: k=1 slots rejected {len(misses)} drafts; near-"
              f"ties (verify top-1 lead over the draft token no larger than "
              f"max |draft - verify| there): "
              f"{sum(g <= d for g, d in misses)}/{len(misses)}")
        print(f"spec {name} launches: {json.dumps(launches)}")
    spec_launches = runs["spec paged"][2]
    del runs, plain_rec
    torch.cuda.empty_cache()

    times = _spec_round_kernels(torch, cfg, params, dev, check, kc,
                                "bf16 FULL", timed=True)
    for part, rows_ in times.items():
        print(f"spec kernel times, {part} step layer 0 (bf16): " + "; ".join(
            f"{n} {ms:.4f} ms (plain {pl:.4f}, bound {b:.4f} by {by}, "
            f"library {'none' if lib is None else f'{lib:.4f}'})"
            for n, (ms, pl, b, by, lib) in rows_.items()))

    sc = SamplerConfig(**SPEC_SAMPLER)
    agree = []
    for sp in (None, spec):
        toks = {}
        for layout, seed in (("paged", 0), ("paged", 0), ("paged", 1),
                             ("slotted", 0)):
            eng = ServingEngine(cfg, params, **base, kv_layout=layout,
                                sampler=sc, seed=seed, speculative=sp)
            toks.setdefault((layout, seed), []).append(eng.run(
                _spec_requests(cfg, n=8, new=8)).tokens_by_rid())
        a, b = toks["paged", 0]
        tag = "speculative" if sp else "plain"
        check(all(np.array_equal(a[r], b[r]) for r in a),
              f"spec sampled {tag}: two runs of seed 0 differ")
        check(any(not np.array_equal(a[r], toks["paged", 1][0][r])
                  for r in a), f"spec sampled {tag}: seeds 0 and 1 agree")
        sl = toks["slotted", 0][0]
        agree.append((tag, sum(np.array_equal(a[r], sl[r]) for r in a)))
    print("spec sampled (top-p 0.9, temperature 0.8) bf16 FULL, 8 requests x "
          "8 tokens: plain and speculative reproducible by seed, seeds 0 "
          "and 1 differ; slotted against paged, requests token-identical: "
          + ", ".join(f"{t} {n}/8" for t, n in agree))
    print(f"speculative phase (a-c): {time.perf_counter() - t_phase:.1f} s")
    return spec_launches, times


def speculative_fp32_phase(torch, cfg2, dev, check, kc) -> None:
    """(d) The exact semantics on the card: the 2-layer full-width model in
    float32 — greedy speculative tokens equal plain decode's on both
    layouts and slotted plain equals paged plain; slots at k = 1 accept
    every draft or each miss is a near-tie; sampled tokens equal across
    the layouts, plain and speculative; every kernel call of one round
    against its plain version (<= 1e-5); and a speculative engine with
    prefix cache and preemption on phase 10b's forced-preemption shape
    gives the tokens of the same engine without speculation, with the
    pool consistent after it."""
    from repro_torch.models import model as model_lib
    from repro_torch.serving import (Request, SamplerConfig, ServingEngine,
                                     SpeculativeConfig)
    t_phase = time.perf_counter()
    c32 = cfg2.replace(dtype="float32")
    params = model_lib.init_params(
        c32, torch.Generator(device=dev).manual_seed(4), dev)
    base = dict(num_slots=8, slot_len=512, slot_k=TRAFFIC_SLOTS, block_size=16)
    spec = SpeculativeConfig(SPEC_W, 1)
    out = {}
    for layout in ("paged", "slotted"):
        for sp in (None, spec):
            eng = ServingEngine(c32, params, kv_layout=layout,
                                speculative=sp, **base)
            out[layout, sp is not None] = _spec_run(
                torch, eng, _spec_requests(c32))[:2]
    plain = out["paged", False][0].tokens_by_rid()
    misses = []
    for (layout, is_spec), (rep, rec) in out.items():
        toks = rep.tokens_by_rid()
        diff = [r for r in plain if not np.array_equal(plain[r], toks[r])]
        kind = "speculative" if is_spec else "plain"
        check(not diff, f"spec fp32 {layout} {kind}: requests {diff} differ "
              "from paged plain decode")
        if is_spec:
            misses += rec.k1_misses()
            tiers = rec.per_tier()
            print(f"spec fp32 (2 layers) {layout}: tokens equal to plain, "
                  f"{rep.spec_rounds} rounds, acceptance "
                  f"{rep.summary()['acceptance_rate']:.3f} (" + ", ".join(
                      f"k={k}: {a}/{d}" for k, (d, a) in
                      sorted(tiers.items(), reverse=True)) + ")")
    for gap, d in misses:
        check(gap <= d, f"spec fp32: a k=1 draft rejected where the verify "
              f"top-1 leads the draft token by {gap:.3e} > max |draft - "
              f"verify| {d:.3e} (not a near-tie)")
    print(f"spec fp32: k=1 slots rejected {len(misses)} drafts, each a "
          "near-tie" if misses else "spec fp32: k=1 slots accepted every "
          "draft")
    sc = SamplerConfig(**SPEC_SAMPLER)
    for sp in (None, spec):
        got = [ServingEngine(c32, params, kv_layout=layout, sampler=sc,
                             seed=5, speculative=sp, **base).run(
            _spec_requests(c32, n=8, new=8)).tokens_by_rid()
               for layout in ("paged", "slotted")]
        check(all(np.array_equal(got[0][r], got[1][r]) for r in got[0]),
              f"spec fp32 sampled {'speculative' if sp else 'plain'}: "
              "slotted tokens differ from paged")
    print("spec fp32 sampled: slotted tokens equal paged, plain and "
          "speculative")
    _spec_round_kernels(torch, c32, params, dev, check, kc, "fp32 2-layer")

    rng = np.random.default_rng(5)
    eco, prm = (rng.integers(0, c32.vocab_size, (64,)).astype(np.int32)
                for _ in range(2))
    kw = dict(num_slots=2, slot_len=512, slot_k=(8, 1), block_size=16,
              num_blocks=32, prefix_cache=True, preemption=True,
              slo_ms={8: 0.0, 1: 60000.0})

    def reqs():
        return [Request(rid=0, prompt=eco, max_new_tokens=384, k=1),
                Request(rid=1, prompt=prm, max_new_tokens=16, k=8,
                        arrival=0.05)]
    ref_rep = ServingEngine(c32, params, **kw).run(reqs())
    eng = ServingEngine(c32, params, speculative=spec, **kw)
    rep = eng.run(reqs())
    want, got = ref_rep.tokens_by_rid(), rep.tokens_by_rid()
    check(all(np.array_equal(want[r], got[r]) for r in want),
          "spec fp32 preemption: tokens differ from the engine without "
          "speculation")
    check(rep.preemptions >= 1, "spec fp32 preemption: nothing preempted")
    eng.pool.check_invariants()
    check(eng.pool.blocks_in_use == 0, "spec fp32 preemption: blocks held")
    print(f"spec fp32 preemption (prefix cache, 2 slots, 32 blocks): "
          f"{rep.preemptions} preemption(s) ({ref_rep.preemptions} without "
          f"speculation), {rep.spec_rounds} rounds, tokens equal to the "
          f"engine without speculation, pool invariants hold "
          f"({time.perf_counter() - t_phase:.1f} s)")
    del eng, params
    torch.cuda.empty_cache()


LORA_REL = 0.1


def _pairs(tree, prefix=()):
    """(key path, {"a", "b"} node) of an adapter tree, keys sorted."""
    if set(tree) == {"a", "b"}:
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _pairs(tree[k], prefix + (k,))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _rms(t) -> float:
    return t.float().pow(2).mean().sqrt().item()


def _serving_adapter(torch, cfg, params, dev, seed, rel=LORA_REL):
    """A seeded rank-``cfg.lora.rank`` adapter on q/k/v/o and every
    expert's w1/w2/w3: ``init_lora``'s ``a`` (N(0, 1/d_in)), and ``b``
    drawn N(0, σ²) per weight, σ set on layer 0 so that the LoRA term's
    rms is ``rel`` times the base product's for x ~ N(0, 1) (256 rows;
    the expert weights at expert 0): σ = rel · rms(x·W) / (rms(x·A) ·
    sqrt(r) · s), s the LoRA scale.  Returns (adapter, {weight: measured
    rms((x·A)·B·s) / rms(x·W) at layer 0})."""
    from repro_torch.core import lora as lora_lib
    lora = lora_lib.init_lora(torch.Generator(device=dev).manual_seed(seed),
                              cfg, params)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    r, s = cfg.lora.rank, cfg.lora.scale
    blocks = params["blocks"]["pos0"]
    ratios = {}
    for path, pair in _pairs(lora["blocks"]["pos0"]):
        w0, a0 = _at(blocks, path)[0].float(), pair["a"][0].float()
        if w0.dim() == 3:
            w0, a0 = w0[0], a0[0]
        x = torch.randn(256, w0.shape[0], generator=gen, device=dev)
        sigma = rel * _rms(x @ w0) / (_rms(x @ a0) * r ** 0.5 * s)
        pair["b"].copy_(torch.randn(pair["b"].shape, generator=gen,
                                    device=dev) * sigma)
        b0 = pair["b"][0].float()
        b0 = b0[0] if b0.dim() == 3 else b0
        ratios[".".join(path[-2:])] = _rms((x @ a0) @ b0 * s) / _rms(x @ w0)
    return lora, ratios


def _lora_step_calls(torch, cfg, params, lora, check, what, dispatch="ragged"):
    """Every kernel call of one prefill call and of one decode step (8
    slots at the tiers), on an engine serving ``lora`` unmerged under
    ``dispatch``.  The prefill call takes one 256-token prompt at k = 8
    under ragged dispatch, two under the one-hot modes (two routing groups
    under dense, a bucket of two under capacity).  Returns (prefill calls,
    decode calls)."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import ServingReport
    eng = ServingEngine(cfg, params, lora=lora, num_slots=8, slot_len=512,
                        slot_k=TRAFFIC_SLOTS, block_size=16,
                        dispatch=dispatch)
    report = ServingReport(completions=[])
    eng._t0 = time.perf_counter()
    reqs = _spec_requests(cfg, n=10, new=4, seed=5)
    first = [reqs[1]] if dispatch == "ragged" else [reqs[1], reqs[9]]
    check(all(r.prompt_len == 256 and r.k == 8 for r in first),
          f"{what}: requests 1 and 9 are not 256-token prompts at k=8")
    with torch.inference_mode():
        for r in first:
            eng.scheduler.add(r)
        _, pre = _recorded(torch, lambda: eng._admit(report))
        for r in (reqs[:1] if dispatch == "ragged" else []) + reqs[2:8]:
            eng.scheduler.add(r)
        eng._admit(report)
        check(eng.n_active == 8, f"{what}: {eng.n_active} slots busy")
        _, dec = _recorded(torch, lambda: eng._decode_once(report))
        while eng.n_active:
            eng._decode_once(report)
    eng.pool.check_invariants()
    check(eng.pool.blocks_in_use == 0, f"{what}: blocks held after the run")
    return pre, dec


def _check_lora_calls(torch, cfg, calls, check, kc, what, router, T,
                      slots=None, prefill=None):
    """Each recorded call against its plain version, at every layer: the
    per-layer call counts, every expert matmul carrying the expert
    adapter, routers exact (weights within 1e-6), the gather exact, the
    rest within ``kc["close"]`` (phase 2's: close_16bit at bf16, 1e-4·max
    at float32).  ``slots``: None for ragged dispatch, else the one-hot
    modes' expert slot count G·C that every ``lora_matmul_experts`` call
    must have.  ``prefill``: whether the call is a prefill (one flash
    launch per layer); by default, whether ``router`` is the static one.
    Returns {name: max |kernel - plain|}."""
    from repro_torch.kernels import ref
    close = kc["close"]
    L = cfg.num_layers
    names = [c[0] for c in calls]
    if prefill is None:
        prefill = router == "router"
    want_n = {router: L, "lora_matmul": 4 * L,
              "flash_attention": L if prefill else 0}
    if slots is None:
        want_n.update({"ragged_gather": L, "ragged_combine": L,
                       "ragged_expert_matmul": 3 * L})
    else:
        want_n["lora_matmul_experts"] = 3 * L
    for name, n in want_n.items():
        check(names.count(name) == n, f"{what}: {names.count(name)} {name} "
              f"calls, not {n}")
    check(len(names) == sum(want_n.values()), f"{what}: other calls {names}")
    worst = {}
    for name, a, kw, out in calls:
        tag = f"{what} {name}"
        if name == "flash_attention":
            q, k, v = (t.transpose(1, 2) for t in a)
            err = close(out, ref.flash_attention_ref(
                q, k, v, causal=kw["causal"], window=kw["window"],
                softcap=kw["softcap"]).transpose(1, 2), tag)
        elif name in ("router", "adaptive_router"):
            check(a[0].shape[0] == T, f"{tag} at T={a[0].shape[0]}")
            plain = (ref.topk_router_ref if name == "router"
                     else ref.adaptive_topk_router_ref)
            err = kc["router"](out, plain(*a), tag)
        elif name == "ragged_gather":
            check(torch.equal(out, ref.ragged_gather_ref(*a)),
                  f"{tag} differs from the plain version")
            err = 0.0
        elif name == "ragged_expert_matmul":
            check(len(a) == 5 and a[3] is not None, f"{tag} without LoRA")
            err = close(out, ref.ragged_expert_matmul_ref(*a, **kw), tag)
        elif name == "ragged_combine":
            err = close(out, ref.ragged_combine_ref(*a), tag)
        elif name == "lora_matmul_experts":
            check(a[0].shape[1] == slots, f"{tag} over {a[0].shape[1]} "
                  f"slots, not {slots}")
            err = close(out, ref.lora_matmul_experts_ref(*a, kw["scale"]),
                        tag)
        else:
            err = close(out, ref.lora_matmul_ref(*a, kw["scale"]), tag)
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


def _one_hot_slots(cfg, dispatch, rows, S, ks):
    """The expert slot count G·C of one prefill call (``rows`` prompts of
    ``S`` tokens at ``ks[0]``) or decode step (S = 1, ``ks`` the active
    budgets) under a one-hot mode, by the port's own rules: dense routes
    a prefill call one group per row with C its token count; capacity
    routes one group whose C follows the budgets of the call's bucket."""
    from repro_torch.models import moe_layer
    if dispatch == "dense":
        groups = rows if S > 1 else 1
        return groups * moe_layer.dense_capacity(rows * S // groups)
    return moe_layer._capacity_from_assignments(
        S * sum(ks), cfg.moe.num_experts, cfg.moe.capacity_factor)


def _one_hot_step_checks(torch, cfg, params, lora, check, kc, what):
    """Under dense and capacity dispatch: every kernel call of one LoRA
    prefill call (two 256-token prompts at k = 8) and one decode step (the
    tiers) against its plain version at every layer
    (``_check_lora_calls``).  Returns {dispatch: (prefill calls, decode
    calls, {name: max |kernel - plain|})}."""
    out = {}
    for d in ("dense", "capacity"):
        pre, dec = _lora_step_calls(torch, cfg, params, lora, check,
                                    f"{what} {d}", dispatch=d)
        worst = {}
        # capacity prefills a bucket with its real-row mask: the
        # per-token-budget router
        pre_router = "router" if d == "dense" else "adaptive_router"
        for part, calls, router, T, slots in (
                ("prefill", pre, pre_router, 512,
                 _one_hot_slots(cfg, d, 2, 256, (8, 8))),
                ("decode", dec, "adaptive_router", 8,
                 _one_hot_slots(cfg, d, 8, 1, TRAFFIC_SLOTS))):
            w = _check_lora_calls(torch, cfg, calls, check, kc,
                                  f"{what} {d} {part}", router, T, slots,
                                  prefill=part == "prefill")
            for k, v in w.items():
                worst[k] = max(worst.get(k, 0.0), v)
            print(f"{what} {d} {part} (T={T}, {slots} expert slots): every "
                  f"kernel call of {cfg.num_layers} layers against its plain "
                  "version, max |kernel - plain|: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in w.items()))
        out[d] = (pre, dec, worst)
    return out


def _one_hot_run_checks(torch, eng, reqs, check, what):
    """One run of a dense or capacity engine serving an adapter, counts
    zeroed just before it: ``lora_matmul_experts`` 3 and ``lora_matmul`` 4
    launches per layer and engine call, flash once per layer and prefill
    call, no ragged launch.  Returns ``_spec_run``'s result."""
    rep, rec, la = _spec_run(torch, eng, reqs)
    L = eng.cfg.num_layers
    n_pre, n_calls = len(rep.prefill_s), len(rep.prefill_s) + len(
        rep.decode_step_s)
    for name, want in (("lora_matmul_experts", 3 * L * n_calls),
                       ("lora_matmul", 4 * L * n_calls),
                       ("flash_attention", L * n_pre),
                       ("ragged_gather", 0), ("ragged_expert_matmul", 0),
                       ("ragged_combine", 0)):
        check(la[name] == want, f"{what}: {la[name]} {name} launches for "
              f"{n_calls} engine calls ({n_pre} prefill) x {L} layers, not "
              f"{want}")
    s = rep.summary()
    check(s["n_requests"] == len(reqs), f"{what}: {s['n_requests']} requests")
    return rep, rec, la


def _time_lora_layer0(torch, calls, kc):
    """Layer 0's q projection (``lora_matmul``) and its grouped w1 and w2
    (the ragged LoRA route) of a step: (ms, plain ms, bytes, FLOPs,
    library ms of the base product alone) each, CUDA events, L2 flushed.
    Bytes: every input read once and the output written once (for the
    grouped matmul: each expert that a row block names, its W, A and B);
    FLOPs: the products of the valid rows."""
    from repro_torch.kernels import backend, ref
    t = kc["time_ms"]
    out = {}
    x, w, a, b = next(c[1] for c in calls if c[0] == "lora_matmul")
    sc = next(c[2]["scale"] for c in calls if c[0] == "lora_matmul")
    M, K = x.shape
    N, r = w.shape[1], a.shape[1]
    out["lora_matmul"] = (
        t(lambda: backend.lora_matmul(x, w, a, b, scale=sc)),
        t(lambda: ref.lora_matmul_ref(x, w, a, b, sc)),
        2 * (M * K + K * N + K * r + r * N + M * N),
        2.0 * M * (K * N + K * r + r * N),
        t(lambda: torch.matmul(x, w)))
    valid = next(c[1][2] for c in calls if c[0] == "ragged_gather")
    n_valid = int(valid.sum())
    mms = [c for c in calls if c[0] == "ragged_expert_matmul"]
    for label, (_, args, kw, _) in (("w1", mms[0]), ("w2", mms[2])):
        xs, be, w, a, b = args
        E, K, H = w.shape
        r = a.shape[2]
        n_exp = int(torch.unique(be).numel())
        bm = xs.shape[0] // be.shape[0]
        ends = (torch.cumsum(torch.bincount(be.long(), minlength=E), 0)
                * bm).to(torch.int32)
        lib = (t(lambda: torch._grouped_mm(xs, w, offs=ends))
               if hasattr(torch, "_grouped_mm") else None)
        out[f"ragged {label}"] = (
            t(lambda: backend.ragged_expert_matmul(xs, be, w, a, b, **kw)),
            t(lambda: ref.ragged_expert_matmul_ref(xs, be, w, a, b, **kw)),
            2 * (xs.shape[0] * K + n_exp * (K * H + K * r + r * H)
                 + xs.shape[0] * H),
            2.0 * n_valid * (K * H + K * r + r * H), lib)
    return out


def _time_experts_layer0(torch, calls, kc):
    """Layer 0's w1 ``lora_matmul_experts`` call of a one-hot step: (ms,
    plain ms, bytes, FLOPs, ms of ``torch.bmm`` on the base product
    alone), CUDA events, L2 flushed; bytes and FLOPs over every slot."""
    from repro_torch.kernels import backend, ref
    t = kc["time_ms"]
    (x, w, a, b), kw = next((c[1], c[2]) for c in calls
                            if c[0] == "lora_matmul_experts")
    E, C, K = x.shape
    N, r = w.shape[2], a.shape[2]
    return (t(lambda: backend.lora_matmul_experts(x, w, a, b, **kw)),
            t(lambda: ref.lora_matmul_experts_ref(x, w, a, b, kw["scale"])),
            2 * E * (C * K + K * N + K * r + r * N + C * N),
            2.0 * E * C * (K * N + K * r + r * N),
            t(lambda: torch.bmm(x, w)))


def lora_serving_phase(torch, cfg, params, dev, check, kc, fed_adapter):
    """LoRA serving at OLMoE FULL, bf16, on the serving phase's weights,
    engine shape and 16 requests: (a) a seeded rank-20 adapter
    (``_serving_adapter``, the LoRA term at a tenth of the base product's
    rms on layer 0) served unmerged against the engine on
    ``merge_into_params`` (merged in fp32, then cast): every request
    token-identical or its first divergence a near-tie (phase 11's rule);
    against the engine without the adapter most requests differ; the
    unmerged run's launches (counters zeroed just before it) — the
    grouped matmul (its LoRA route) 3 and ``lora_matmul`` 4 per layer and
    engine call; hand-kernel launches per decode step, tokens/s and decode
    p50 of the three; then the dense and capacity engines with the
    adapter (``_one_hot_run_checks``; dense against ragged by the
    near-tie rule); (b) every kernel call of one prefill call (T = 256,
    k = 8) and one decode step (T = 8, the tiers) against its plain
    version at every layer, layer 0's LoRA calls timed, and the same
    under dense and capacity (``_one_hot_step_checks``, layer 0's expert
    call timed); (d) the FLAME
    pipeline: phase 5's global adapter with one client's rescaler per
    tier, unmerged, 8 requests, every request complete with finite
    logits.  Returns (the unmerged run's launches, layer 0's times
    {"prefill"|"decode"|"<mode> prefill"|"<mode> decode": ...}, max
    |kernel - plain| per kernel, {mode: lora_matmul_experts launches})."""
    from repro_torch.core import lora as lora_lib
    from repro_torch.serving import ServingEngine
    t_phase = time.perf_counter()
    L = cfg.num_layers
    base = dict(num_slots=8, slot_len=512, slot_k=TRAFFIC_SLOTS, block_size=16)
    lora, ratios = _serving_adapter(torch, cfg, params, dev, seed=21)
    print(f"lora serving adapter: rank {cfg.lora.rank}, scale "
          f"{cfg.lora.scale}, rms(LoRA term) / rms(base product) at layer "
          f"0: " + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    merged = lora_lib.merge_into_params(params, lora, cfg.lora.scale)
    # warm-up off the clock: the LoRA shapes are new to cuBLAS and caches
    ServingEngine(cfg, params, lora=lora, **base).run(
        _spec_requests(cfg, n=8, new=2, seed=9))
    runs = {}
    for name, p_, lo in (("merged", merged, None), ("unmerged", params, lora),
                         ("no adapter", params, None)):
        runs[name] = _spec_run(torch, ServingEngine(cfg, p_, lora=lo, **base),
                               _spec_requests(cfg))
    del merged
    torch.cuda.empty_cache()
    toks = {n: r[0].tokens_by_rid() for n, r in runs.items()}
    for name, (rep, _, _) in runs.items():
        s = rep.summary()
        check(s["n_requests"] == 16 and s["gen_tokens"] == 16 * 16,
              f"lora {name}: {s['n_requests']} requests, {s['gen_tokens']} "
              "tokens")
    div = _first_divergences(runs["merged"][1], toks["merged"],
                             runs["unmerged"][1], toks["unmerged"])
    for rid, t, gap, d in div:
        check(gap <= d, f"lora unmerged: request {rid} differs from merged "
              f"at position {t}, where the merged top-2 gap {gap:.3e} "
              f"exceeds max |unmerged - merged| {d:.3e} (not a near-tie)")
    n_moved = sum(not np.array_equal(toks["no adapter"][r], toks["unmerged"][r])
                  for r in toks["unmerged"])
    check(n_moved > 8, f"lora: only {n_moved}/16 requests differ from the "
          "engine without the adapter")
    rep, rec, launches = runs["unmerged"]
    n_calls = len(rep.prefill_s) + len(rep.decode_step_s)
    check(launches["ragged_expert_matmul"] == 3 * L * n_calls,
          f"lora unmerged: {launches['ragged_expert_matmul']} grouped matmul "
          f"launches for {n_calls} engine calls x {L} layers x 3")
    check(launches["lora_matmul"] == 4 * L * n_calls,
          f"lora unmerged: {launches['lora_matmul']} lora_matmul launches "
          f"for {n_calls} engine calls x {L} layers x 4")
    check(launches["lora_matmul_experts"] == 0,
          "lora unmerged launched lora_matmul_experts")
    check(runs["merged"][2]["lora_matmul"] == 0, "merged launched lora_matmul")
    per_step = {n: float(np.mean(r[1].launches["decode"]))
                for n, r in runs.items()}
    # the adapter rides in launches serving makes anyway: q/k/v/o go from
    # cuBLAS products (not counted) to lora_matmul, nothing else is added
    check(per_step["unmerged"] == per_step["merged"] + 4 * L,
          f"lora: hand-kernel launches per decode step unmerged "
          f"{per_step['unmerged']} != merged {per_step['merged']} + 4 x {L}")
    print(f"lora serving (bf16 FULL, 16 requests): unmerged vs merged "
          f"{16 - len(div)}/16 requests token-identical"
          + ("" if not div else " (first divergences: " + "; ".join(
              f"rid {r} at {t}: merged top-2 gap {g:.3e} <= max |unmerged "
              f"- merged| {d:.3e}" for r, t, g, d in div) + ")")
          + f"; {n_moved}/16 differ from the engine without the adapter; "
          "hand-kernel launches per decode step (q/k/v/o are cuBLAS "
          "products without lora_matmul): " + ", ".join(
              f"{n} {v:.1f}" for n, v in per_step.items()))
    for name, (rep_, _, _) in runs.items():
        s = rep_.summary()
        print(f"lora serving {name}: {s['gen_tokens_per_s']:.1f} tokens/s, "
              f"decode step p50 {s['decode_step_ms_p50']:.2f} ms, prefill "
              f"p50 {float(np.median(rep_.prefill_s)) * 1e3:.1f} ms, TTFT "
              f"p50 {s['ttft_p50_ms']:.1f} ms")
    print(f"lora serving launches (unmerged): {json.dumps(launches)}")
    # the one-hot modes at FULL with the adapter: launch counts, and dense
    # (loss-free) against ragged by the near-tie rule
    onehot_launches = {}
    for d in ("dense", "capacity"):
        rep_d, rec_d, la = _one_hot_run_checks(
            torch, ServingEngine(cfg, params, lora=lora, dispatch=d, **base),
            _spec_requests(cfg), check, f"lora bf16 {d}")
        toks_d = rep_d.tokens_by_rid()
        div_d = _first_divergences(runs["unmerged"][1], toks["unmerged"],
                                   rec_d, toks_d)
        if d == "dense":
            for rid, t, gap, dd in div_d:
                check(gap <= dd, f"lora dense: request {rid} differs from "
                      f"ragged at position {t}, where the ragged top-2 gap "
                      f"{gap:.3e} exceeds max |dense - ragged| {dd:.3e}")
        s = rep_d.summary()
        print(f"lora serving {d} (bf16 FULL, 16 requests): "
              f"{16 - len(div_d)}/16 requests token-identical to ragged"
              + (" (every first divergence a near-tie)" if d == "dense"
                 else " (capacity may drop tokens)")
              + f", {s['gen_tokens_per_s']:.1f} tokens/s, decode step p50 "
              f"{s['decode_step_ms_p50']:.2f} ms, prefill p50 "
              f"{float(np.median(rep_d.prefill_s)) * 1e3:.1f} ms; launches "
              f"{json.dumps(la)}")
        onehot_launches[d] = la["lora_matmul_experts"]
        del rep_d, rec_d
    del runs
    torch.cuda.empty_cache()

    # (b) every kernel call of one prefill call and one decode step
    pre, dec = _lora_step_calls(torch, cfg, params, lora, check, "lora bf16")
    worst = {}
    for part, calls, router, T in (("prefill", pre, "router", 256),
                                   ("decode", dec, "adaptive_router", 8)):
        w = _check_lora_calls(torch, cfg, calls, check, kc,
                              f"lora bf16 {part}", router, T)
        for k, v in w.items():
            worst[k] = max(worst.get(k, 0.0), v)
        print(f"lora bf16 {part} (T={T}): every kernel call of {L} layers "
              f"against its plain version, max |kernel - plain|: "
              + ", ".join(f"{k} {v:.3e}" for k, v in w.items()))
    times = {"prefill": _time_lora_layer0(torch, pre, kc),
             "decode": _time_lora_layer0(torch, dec, kc)}
    del pre, dec
    for d, (pre, dec, w) in _one_hot_step_checks(
            torch, cfg, params, lora, check, kc, "lora bf16").items():
        for k, v in w.items():
            worst[f"{d} {k}"] = v
        for part, calls in (("prefill", pre), ("decode", dec)):
            times[f"{d} {part}"] = _time_experts_layer0(torch, calls, kc)
        del pre, dec

    # (d) the FLAME pipeline: phase 5's adapter, per-tier rescalers
    glora, resc = fed_adapter
    check(sorted(resc) == [1, 2, 4, 8], f"lora pipeline: tiers {sorted(resc)}")
    eng = ServingEngine(cfg, params, lora=glora, rescaler_by_k=resc, **base)
    rep, rec, _ = _spec_run(torch, eng, _spec_requests(cfg, n=8, seed=4))
    s = rep.summary()
    check(s["n_requests"] == 8 and s["gen_tokens"] == 8 * 16,
          f"lora pipeline: {s['n_requests']} requests, {s['gen_tokens']} "
          "tokens")
    check(all(np.isfinite(np.asarray(v)).all() for v in rec.rows.values()),
          "lora pipeline: non-finite logits")
    print(f"lora pipeline (phase 5's global adapter, rescalers of clients "
          f"at k={sorted(resc)}, unmerged, 8 requests): every request "
          f"complete, {len(rec.rows)} logit rows finite, "
          f"{s['gen_tokens_per_s']:.1f} tokens/s")
    del eng, lora
    torch.cuda.empty_cache()
    print(f"lora serving phase (a, b, d): {time.perf_counter() - t_phase:.1f}"
          " s")
    return launches, times, worst, onehot_launches


def lora_fp32_phase(torch, cfg2, dev, check, kc) -> None:
    """(c) The 2-layer full-width model in float32 with a random nonzero
    adapter, 16 requests: the unmerged engine token for token against the
    merged one; ragged against dense and against capacity dispatch with
    capacity_factor = E (capacity cannot bind); speculative decoding (W =
    4, draft_k = 1) with the adapter against plain decode with it; and the
    prefix-cached engine with the adapter against a cold one on the
    traffic phase's shared-prefix trace.  The dense and capacity runs
    count their launches (``_one_hot_run_checks``), and every kernel call
    of one prefill call and one decode step under each is held against its
    plain version (``_one_hot_step_checks``, 1e-4·max at float32)."""
    import dataclasses

    from repro_torch.core import lora as lora_lib
    from repro_torch.models import model as model_lib
    from repro_torch.serving import ServingEngine, SpeculativeConfig
    t_phase = time.perf_counter()
    c32 = cfg2.replace(dtype="float32")
    params = model_lib.init_params(
        c32, torch.Generator(device=dev).manual_seed(22), dev)
    lora, _ = _serving_adapter(torch, c32, params, dev, seed=23)
    base = dict(num_slots=8, slot_len=512, slot_k=TRAFFIC_SLOTS, block_size=16)

    def run(cfg_, p_, lo, reqs, **kw):
        return ServingEngine(cfg_, p_, lora=lo, **base, **kw).run(
            reqs).tokens_by_rid()

    def counted(cfg_, d):
        return _one_hot_run_checks(
            torch, ServingEngine(cfg_, params, lora=lora, dispatch=d, **base),
            _spec_requests(c32), check, f"lora fp32 {d}")[0].tokens_by_rid()

    want = run(c32, params, lora, _spec_requests(c32))
    cap = c32.replace(moe=dataclasses.replace(
        c32.moe, capacity_factor=float(c32.moe.num_experts)))
    others = {
        "merged": run(c32, lora_lib.merge_into_params(
            params, lora, c32.lora.scale), None, _spec_requests(c32)),
        "dense": counted(c32, "dense"),
        "capacity (factor E)": counted(cap, "capacity"),
        "speculative": run(c32, params, lora, _spec_requests(c32),
                           speculative=SpeculativeConfig(SPEC_W, 1)),
    }
    for name, got in others.items():
        diff = [r for r in want if not np.array_equal(want[r], got[r])]
        check(not diff, f"lora fp32 {name}: requests {diff} differ from the "
              "unmerged ragged engine")
    cold = run(c32, params, lora, _traffic_trace(c32))
    warm = run(c32, params, lora, _traffic_trace(c32), prefix_cache=True)
    diff = [r for r in cold if not np.array_equal(cold[r], warm[r])]
    check(not diff, f"lora fp32 prefix cache: requests {diff} differ from "
          "the cold engine")
    _one_hot_step_checks(torch, c32, params, lora, check, kc, "lora fp32")
    bare = run(c32, params, None, _spec_requests(c32))
    n_moved = sum(not np.array_equal(bare[r], want[r]) for r in want)
    check(n_moved > 8, f"lora fp32: only {n_moved}/16 requests differ "
          "without the adapter")
    print(f"lora fp32 (2 layers, full width): the unmerged ragged engine's "
          f"16 requests equal " + ", ".join(others)
          + f"; 24 prefix-cached requests equal the cold engine's; "
          f"{n_moved}/16 differ without the adapter "
          f"({time.perf_counter() - t_phase:.1f} s)")
    del params, lora
    torch.cuda.empty_cache()


def _flexlora_errors(torch, srv, loras, sizes):
    """Per adapter pair: ‖scale·A·B − T_r(ΔW̄)‖_F / ‖T_r(ΔW̄)‖_F, where ΔW̄
    is the size-weighted mean of the clients' scale·A_i·B_i in fp32 and
    T_r its best rank-r approximation (r = the server rank)."""
    scale = srv.cfg.lora.scale
    r = max(c.rank for c in srv.clients)
    w = torch.tensor(sizes, dtype=torch.float32)
    w = (w / w.sum()).tolist()
    out = []

    def pairs(tree):
        return {p[:-1]: None for p, _ in _paths(tree)}

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    for path in pairs(srv.global_lora):
        g = get(srv.global_lora, path)
        mean = sum(wi * torch.matmul(get(l, path)["a"].float(),
                                     get(l, path)["b"].float()) * scale
                   for wi, l in zip(w, loras))
        u, s_, vt = torch.linalg.svd(mean, full_matrices=False)
        trunc = torch.matmul(u[..., :r] * s_[..., None, :r], vt[..., :r, :])
        got = torch.matmul(g["a"].float(), g["b"].float()) * scale
        out.append(((got - trunc).norm() / trunc.norm().clamp_min(1e-30))
                   .item())
        del mean, u, s_, vt, trunc, got
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def train_e2e_phase(torch, cfg2, dev, check) -> None:
    """The training loss and the gradient of every trainable leaf of a
    2-layer full-width model, on the card and on the CPU, same weights,
    adapters (random nonzero b) and batch (B=2, S=64, k=8)."""
    from repro_torch.core import lora as lora_lib
    from repro_torch.models import model as model_lib

    c32 = cfg2.replace(dtype="float32")
    params = model_lib.init_params(c32, torch.Generator().manual_seed(3),
                                   "cpu")
    lora = lora_lib.init_lora(torch.Generator().manual_seed(4), c32, params)
    gen = torch.Generator().manual_seed(5)
    for path, leaf in _paths(lora):
        if path[-1] == "b":
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 0.02)
    trainable = {"lora": lora,
                 "rescaler": lora_lib.init_rescalers(c32, 8, device="cpu")}
    rng = np.random.default_rng(6)
    tok = torch.as_tensor(rng.integers(0, cfg2.vocab_size, (2, 64)))
    lab = torch.roll(tok, -1, dims=1)
    msk = torch.ones(2, 64)

    def fresh(tree, dtype, device):
        """Leaf copies on ``device`` that require grad (never the CPU
        originals themselves, which ``.to`` would return unchanged)."""
        if isinstance(tree, dict):
            return {k: fresh(v, dtype, device) for k, v in tree.items()}
        return tree.detach().to(device=device,
                                dtype=dtype).requires_grad_(True)

    def loss_and_grads(dtype, device):
        p = _cast(params, dtype, device)
        tr = {"lora": fresh(trainable["lora"], dtype, device),
              "rescaler": fresh(trainable["rescaler"], torch.float32, device)}
        leaves = [t for _, t in _paths(tr)]
        c = cfg2.replace(dtype=str(dtype).split(".")[1])
        t0 = time.perf_counter()
        loss, counts = model_lib.lm_loss(c, p, tok.to(device),
                                         lab.to(device), msk.to(device),
                                         trainable=tr, k=8)
        grads = torch.autograd.grad(loss, leaves)
        if device != "cpu":
            torch.cuda.synchronize()
        return (loss.item(), counts["pos0"].cpu(),
                [g.float().cpu() for g in grads], time.perf_counter() - t0)

    names = ["/".join(p) for p, _ in _paths(trainable)]
    l_cpu, n_cpu, g_cpu, s_cpu = loss_and_grads(torch.float32, "cpu")
    for dtype in (torch.float32, torch.bfloat16):
        l_gpu, n_gpu, g_gpu, s_gpu = loss_and_grads(dtype, dev)
        rel = [((a - b).norm() / b.norm().clamp_min(1e-12)).item()
               for a, b in zip(g_gpu, g_cpu)]
        mx = [((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
              for a, b in zip(g_gpu, g_cpu)]
        dn = str(dtype).split(".")[1]
        print(f"train e2e {dn} card vs fp32 cpu: loss {l_gpu:.6f} vs "
              f"{l_cpu:.6f} (|d| {abs(l_gpu - l_cpu):.3e}), routing counts "
              f"{'equal' if torch.equal(n_gpu, n_cpu) else 'differ'}, "
              f"{len(rel)} leaves: grad rel L2 err median "
              f"{float(np.median(rel)):.3e} max {max(rel):.3e} "
              f"(card {s_gpu:.1f} s, cpu {s_cpu:.1f} s)")
        for name, r, m in zip(names, rel, mx):
            print(f"  {dn} {name}: rel L2 {r:.3e}, max|d|/max|cpu| {m:.3e}")
        if dtype == torch.float32:
            # fp32 both sides, only summation order differs (sums over up
            # to 2048 terms, cuBLAS vs the CPU's BLAS), so the same experts
            # are chosen and every gradient agrees to a few ulps of its
            # largest entry, amplified through two layers of backward
            check(torch.equal(n_gpu, n_cpu), "fp32 routing counts differ")
            check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu),
                  "fp32 training loss differs by more than 1e-5 relative")
            check(max(mx) <= 1e-3, "fp32 gradients differ by more than "
                  "1e-3 of each leaf's largest entry")
        else:
            # bf16 activations keep ~3 significant digits, a near-tied
            # router choice may flip, and a gradient that sums many
            # cancelling terms (the rescaler's) keeps fewer, so the bound
            # is loose: the loss to 2%, the median leaf to 25% in L2, and
            # every leaf's gradient pointing the same way (cosine >= 0.7)
            cos = [float(torch.nn.functional.cosine_similarity(
                a.flatten(), b.flatten(), dim=0)) for a, b in
                zip(g_gpu, g_cpu)]
            print(f"  bf16 grad cosine to fp32: min {min(cos):.4f}")
            check(abs(l_gpu - l_cpu) <= 2e-2 * abs(l_cpu),
                  "bf16 training loss differs by more than 2% from fp32")
            check(float(np.median(rel)) <= 0.25 and min(cos) >= 0.7,
                  "bf16 gradients too far from fp32")


def _paths(tree, prefix=()):
    """(key path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif tree is not None:
        yield prefix, tree


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


# --------------------------------------------------------------------------
# 21. the card mesh
# --------------------------------------------------------------------------

MESH_DIR = ROOT / "build" / "chip_smoke"
MESH_SHAPES = (((1, 4), ("data", "model")), ((2, 2), ("data", "model")),
               ((2, 1, 2), ("pod", "data", "model")))


def _mesh_state(torch, cfg, dev, seed):
    """Whole seeded weights and a trainable tree: adapters with ``b``
    drawn off zero (so every factor has a gradient) and rescalers at 0.7
    of their start."""
    from repro_torch.core import lora as lora_lib
    from repro_torch.models import model as model_lib
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    lora = lora_lib.init_lora(torch.Generator(device=dev).manual_seed(seed + 1),
                              cfg, params)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    for _, pair in _pairs(lora):
        pair["b"] = (torch.randn(pair["b"].shape, generator=gen, device=dev)
                     * 0.01).to(pair["b"].dtype)
    resc = lora_lib.init_rescalers(cfg, cfg.moe.top_k, device=dev)
    if resc is not None:
        resc = {key: v * 0.7 for key, v in resc.items()}
    return params, lora_lib.make_trainable(lora, resc)


def _bit_equal(torch, got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))


def _want_calls(cfg):
    """{backend wrapper: calls} of one forward of ``cfg``: per layer,
    flash at an attention position, ``lora_matmul`` at each adapted
    projection (q/k/v/o, the Mamba block's in/out, a dense or shared
    FFN's three), the router and three expert products at an MoE
    position."""
    lc, m = cfg.lora, cfg.moe
    n = cfg.num_layers // cfg.pattern_period
    want = {}

    def add(name, k):
        if k:
            want[name] = want.get(name, 0) + k * n
    for j in range(cfg.pattern_period):
        if cfg.layer_kind(j) == "attn":
            add("flash_attention", 1)
            add("lora_matmul", 4 * lc.target_attn)
        else:
            add("lora_matmul", 2 * lc.target_ssm)
        if cfg.layer_is_moe(j):
            add("router", 1)
            add("lora_matmul_experts", 3 * lc.target_expert)
            add("lora_matmul", 3 * lc.target_ffn * (m.num_shared_experts > 0))
        elif cfg.d_ff > 0:
            add("lora_matmul", 3 * lc.target_ffn)
    return want


def _mesh_call_checks(torch, cfg, calls, kc, what):
    """Every recorded kernel call of one mesh forward against its plain
    version: the router (static, exact), flash, and the two LoRA
    matmuls within close_16bit.  Returns {name: max err}."""
    from repro_torch.kernels import ref
    want_n = _want_calls(cfg)
    names = [c[0] for c in calls]
    check(all(names.count(n) == k for n, k in want_n.items())
          and len(names) == sum(want_n.values()),
          f"{what}: calls {sorted((n, names.count(n)) for n in set(names))}")
    worst = {}
    for name, a, kw, out in calls:
        tag = f"{what} {name}"
        if name == "router":
            err = kc["router"](out, ref.topk_router_ref(*a), tag)
        elif name == "flash_attention":
            q, k, v = (t.transpose(1, 2) for t in a)
            err = kc["close"](out, ref.flash_attention_ref(
                q, k, v, causal=kw["causal"], window=kw["window"],
                softcap=kw["softcap"]).transpose(1, 2), tag)
        elif name == "lora_matmul":
            err = kc["close"](out, ref.lora_matmul_ref(*a, kw["scale"]), tag)
        else:
            err = kc["close"](out, ref.lora_matmul_experts_ref(
                *a, kw["scale"]), tag)
        worst[name] = max(worst.get(name, 0.0), err)
    return worst


def _mesh_rows(torch, calls, kc, launches, what, errs, picks):
    """Rows for layer 0's calls: the router, flash, the ``lora_matmul``
    calls ``picks`` names ((label, index among the forward's LoRA
    calls)) and the experts' w1, each timed beside its bound, plain
    version and library call; a kernel the forward does not call has no
    row."""
    from repro_torch.kernels import backend, ref
    t = kc["time_ms"]
    first = {}
    lora = []
    for c in calls:
        first.setdefault(c[0], c)
        if c[0] == "lora_matmul":
            lora.append(c)
    rows = []
    if "router" in first:
        logits, k = first["router"][1]
        T, E = logits.shape
        rows.append(_row(
            f"topk_router ({what}, T={T}, E={E}, k={k})", "topk_router.cu",
            "topk_router.py:59", errs["router"],
            t(lambda: backend.router(logits, k)),
            t(lambda: ref.topk_router_ref(logits, k)),
            bound_ms(T * E * 2 + 2 * T * E * 4 + E * 4, 2.0 * T * E * k,
                     F32_FLOPS), None, launches["topk_router"]))
    if "flash_attention" in first:
        call = first["flash_attention"]
        f_ms, f_pl, f_nb, f_fl, f_lib, f_what = _time_flash(torch, call, kc)
        q, k = call[1][0], call[1][1]
        rows.append(_row(
            f"flash_attention ({what}, B={q.shape[0]}, S={q.shape[1]}, "
            f"H={q.shape[2]}, KV={k.shape[2]}, D={q.shape[3]})",
            "flash_attention.cu", "flash_attention.py:92",
            errs["flash_attention"], f_ms, f_pl,
            bound_ms(f_nb, f_fl, BF16_FLOPS), f_lib,
            launches["flash_attention"], f_what))
    for name, (_, (x, w, a, b), kw, _) in ((n, lora[i]) for n, i in picks):
        M, K = x.shape
        N, r = w.shape[1], a.shape[1]
        sc = kw["scale"]
        rows.append(_row(
            f"lora_matmul ({what} {name} {K}->{N}, r={r}, M={M})",
            "lora_matmul.cu", "lora_matmul.py:63", errs["lora_matmul"],
            t(lambda: backend.lora_matmul(x, w, a, b, scale=sc)),
            t(lambda: ref.lora_matmul_ref(x, w, a, b, sc)),
            bound_ms(2 * (M * K + K * N + K * r + r * N + M * N),
                     2.0 * M * (K * N + K * r + r * N), BF16_FLOPS),
            t(lambda: torch.matmul(x, w)), launches["lora_matmul"],
            "torch.matmul(x, W), base product only"))
    if "lora_matmul_experts" in first:
        x, w, a, b = first["lora_matmul_experts"][1]
        sc = first["lora_matmul_experts"][2]["scale"]
        E, C, K = x.shape
        N, r = w.shape[2], a.shape[2]
        rows.append(_row(
            f"lora_matmul_experts ({what} w1, E={E}, G·C={C}, {K}->{N}, "
            f"r={r})", "lora_matmul.cu", "lora_matmul.py:101",
            errs["lora_matmul_experts"],
            t(lambda: backend.lora_matmul_experts(x, w, a, b, scale=sc)),
            t(lambda: ref.lora_matmul_experts_ref(x, w, a, b, sc)),
            bound_ms(2 * E * (C * K + K * N + K * r + r * N + C * N),
                     2.0 * E * C * (K * N + K * r + r * N), BF16_FLOPS),
            t(lambda: torch.bmm(x, w)), launches["lora_matmul_experts"],
            "torch.bmm(x, W), base product only"))
    return rows


# phase 21 on one card: (arch, row tag, layers, the LoRA calls timed (label,
# index among one forward's), whether prefill and decode run too)
MESH_ONE = (("qwen3-moe-235b-a22b", "Q", 2, (("q", 0),), True),
            ("llama3-405b", "L", 2, (("q", 0), ("w1", 4)), False),
            ("mamba2-780m", "M", 2, (("in_proj", 0), ("out_proj", 1)), True),
            ("jamba-v0.1-52b", "J", 8, (("in_proj", 0), ("out_proj", 1),
                                        ("w1", 2)), True),
            ("musicgen-large", "A", 2, (("q", 0), ("w1", 4)), False),
            ("phi4-mini-3.8b", "P", 2, (("q", 0),), True),
            ("granite-20b", "G", 2, (("q", 0),), True))


# the (1, 1) train step's knob budget: its knobs are fixed (n_micro 2,
# "batch") to hold it to the single-device step, and the estimate must
# not refuse what fits: a world of one gathers nothing, yet the estimate
# counts a period's weights thrice for FSDP gathers (jamba's 8 layers:
# 78 GB of 85), so the budget is set past any card's memory
MESH_ONE_BUDGET = 2 ** 40


def _launch_names(cfg):
    """The launch counters of the kernels one forward of ``cfg`` calls."""
    return [{"router": "topk_router"}.get(n, n) for n in _want_calls(cfg)]


def _mesh_one(rank, world, out_dir):
    """Phase 21 on one card: a world of one NCCL rank, mesh (1, 1).  For
    each arch of ``MESH_ONE`` at full width (2 layers; jamba one period
    of 8): the mesh train step (B = 2, S = 2048, n_micro 2) against the
    single-device ``build_train`` on the same weights, batch and
    trainable tree, bit for bit (loss, counts, adapters, Adam's
    moments); launch counts of the mesh step; every kernel call of one
    mesh forward against its plain version and layer 0's timed; for
    qwen3, mamba2 and jamba the mesh prefill (B = 2, S = 512) and one
    decode step against a 1024-deep cache against the single-device
    steps, bit for bit.  Writes the rows for the parent."""
    import gc

    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as model_lib
    from repro_torch.models.parallel import Shard
    from repro_torch.optim import adam
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    kc = _kernel_tools(torch, dev, [torch.empty(
        2 ** 28, dtype=torch.float32, device=dev)])
    mesh = mesh_lib.make_production_mesh(mesh_shape=(1, 1))
    rows, peaks = [], {}
    for arch, tag, layers, picks, serve in MESH_ONE:
        t_arch = time.perf_counter()
        cfg = get_config(arch, "full").replace(num_layers=layers)
        params, trainable = _mesh_state(torch, cfg, dev, 31)
        shape = ShapeConfig("train_2k", 2048, 2, "train")
        one = steps.build_train(cfg, shape, n_micro=2, device=dev)
        on_mesh = steps.build_train(cfg, shape, n_micro=2, device=dev,
                                    mesh=mesh, memory_bytes=MESH_ONE_BUDGET)
        check(on_mesh.meta["num_groups"] == one.meta["num_groups"],
              "mesh (1, 1) chose other routing groups")
        batch = synthetic_batch(cfg, shape, torch.Generator(
            device=dev).manual_seed(41), dev)
        tr1, opt1, m1 = one.fn(params, trainable, adam.init(trainable),
                               *batch)
        p_loc = shd.shard_tree(params, on_mesh.specs["params"], mesh)
        t_loc = shd.shard_tree(trainable, on_mesh.specs["trainable"], mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        tr2, opt2, m2 = on_mesh.fn(p_loc, t_loc, adam.init(t_loc),
                                   *(steps.shard_batch(b, mesh, 2)
                                     for b in batch))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peaks[f"{arch} train"] = torch.cuda.max_memory_allocated()
        launches = dict(_build.LAUNCHES)
        same = (torch.equal(m1["loss"], m2["loss"])
                and _bit_equal(torch, m1["counts"], m2["counts"])
                and _bit_equal(torch, tr1, tr2)
                and _bit_equal(torch, opt1.mu, opt2.mu)
                and _bit_equal(torch, opt1.nu, opt2.nu))
        print(f"mesh (1, 1) {cfg.name} {layers} layers, full width: train step "
              f"(B=2, S=2048, n_micro 2) loss {float(m2['loss']):.6f} vs "
              f"single-device {float(m1['loss']):.6f}, bit-equal "
              f"(loss, counts, adapters, Adam) {same}; {dt:.3f} s; "
              f"launches {json.dumps(launches)}")
        check(same, f"mesh (1, 1) train step of {cfg.name} differs from the "
              "single-device step")
        check(all(launches[k] > 0 for k in _launch_names(cfg)),
              f"mesh train step launched {launches}")
        del tr1, tr2, opt1, opt2

        # every kernel call of one mesh forward against its plain version
        tok, lab, mask = (b[:1] for b in batch)
        with torch.no_grad():
            _, calls = _recorded(torch, lambda: model_lib.lm_loss(
                cfg, p_loc, tok, lab, mask, trainable=t_loc,
                k=cfg.moe.top_k or None,
                num_groups=on_mesh.meta["num_groups"], shard=Shard(mesh)))
        errs = _mesh_call_checks(torch, cfg, calls, kc,
                                 f"mesh (1, 1) {cfg.name}")
        print(f"mesh (1, 1) {cfg.name}: every kernel call of one forward "
              f"(B=1, S=2048) vs plain, max err {json.dumps(errs)}")
        rows += _mesh_rows(torch, calls, kc, launches,
                           f"21{tag} {cfg.name} mesh (1, 1)", errs, picks)
        del calls

        if serve:
            # prefill and one decode step: mesh (1, 1) against one device
            pshape = ShapeConfig("p", 512, 2, "prefill")
            dshape = ShapeConfig("d", 1024, 2, "decode")
            prompt = torch.randint(0, cfg.vocab_size, (2, 512),
                                   generator=torch.Generator(
                                       device=dev).manual_seed(42),
                                   device=dev, dtype=torch.int32)
            outs = []
            for m in (None, mesh):
                pre = steps.build_prefill(cfg, pshape, mesh=m)
                srv = steps.build_serve(cfg, dshape, mesh=m)
                torch.cuda.reset_peak_memory_stats()
                lg, cache = pre.fn(p_loc, t_loc, prompt)
                peaks[f"{arch} prefill"] = torch.cuda.max_memory_allocated()
                # the decode writes Mamba state in place: keep the prefill's
                full = model_lib.grow_cache(_clone(cache), 1024)
                nxt = lg.argmax(-1).to(torch.int32)
                torch.cuda.reset_peak_memory_stats()
                ld, full = srv.fn(p_loc, t_loc, full, nxt,
                                  torch.tensor(512, dtype=torch.int32,
                                               device=dev))
                peaks[f"{arch} decode"] = torch.cuda.max_memory_allocated()
                outs.append((lg, cache, ld, full))
            (a1, b1, c1, d1), (a2, b2, c2, d2) = outs
            same = (torch.equal(a1, a2) and _bit_equal(torch, b1, b2)
                    and torch.equal(c1, c2) and _bit_equal(torch, d1, d2))
            print(f"mesh (1, 1) {cfg.name}: prefill (B=2, S=512) logits and "
                  f"cache, one decode step at 512 of a 1024-deep cache: "
                  f"bit-equal to the single-device steps {same}")
            check(same, "mesh (1, 1) prefill / serve differ from one device")
            del outs, a1, b1, c1, d1, a2, b2, c2, d2
        del params, trainable, p_loc, t_loc, batch
        gc.collect()
        torch.cuda.empty_cache()
        print(f"mesh (1, 1) {cfg.name}: {time.perf_counter() - t_arch:.1f} s")
    (Path(out_dir) / "mesh_rows_1.json").write_text(json.dumps(rows))
    (Path(out_dir) / "mesh_one.json").write_text(json.dumps(peaks))


def _near_tie_tokens(torch, got, want, want_logits, got_logits):
    """Decoded tokens (B, N) equal, or each row's first divergence a near
    tie: the one-card top-2 logit gap there no larger than the largest
    |mesh - one-card| logit difference of that row and step."""
    for b in range(want.shape[0]):
        diff = (got[b] != want[b]).nonzero()
        if len(diff) == 0:
            continue
        j = int(diff[0])
        top2 = want_logits[j][b].float().topk(2).values
        gap = float(top2[0] - top2[1])
        d = float((got_logits[j][b].float() - want_logits[j][b].float())
                  .abs().max())
        check(gap <= d, f"row {b} diverges at step {j}: top-2 gap {gap:.4f} "
              f"> max |mesh - one card| {d:.4f}")
    return int((got != want).any(dim=1).sum())


def _compare_run(torch, cfg, params, trainable, mesh, dev, serve=True):
    """One train step (B = 4, S = 1024, n_micro 2, 2 routing groups), then
    with ``serve`` a prefill (B = 4, S = 256) and 4 greedy decode steps (a
    512-deep cache) on ``mesh`` (None: one device).  Returns loss, counts,
    the updated adapters (whole), tokens (4, 5), each step's logits
    (whole), the collectives by kind of the train step, the prefill and
    one decode step (the four steps' over 4) and the train step's
    launches."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import model as model_lib
    from repro_torch.models import parallel
    from repro_torch.optim import adam
    comm = {}

    def counted(what, fn, n=1):
        parallel.comm_start()
        out = fn()
        c = parallel.comm_stop()["by_kind"]
        comm[what] = {k: [v[0] / n, v[1] / n] for k, v in c.items()}
        return out
    shape = ShapeConfig("t", 1024, 4, "train")
    tb = steps.build_train(cfg, shape, n_micro=2, num_groups=2, device=dev,
                           mesh=mesh)
    batch = synthetic_batch(cfg, shape, torch.Generator(
        device=dev).manual_seed(43), dev)
    p, tr = params, trainable
    if mesh is not None:
        p = shd.shard_tree(params, tb.specs["params"], mesh)
        tr = shd.shard_tree(trainable, tb.specs["trainable"], mesh)
        batch = [steps.shard_batch(b, mesh, 2) for b in batch]
    _build.reset_launches()
    new, _, m = counted("train", lambda: tb.fn(p, tr, adam.init(tr), *batch))
    launches = dict(_build.LAUNCHES)
    if mesh is not None:
        new = shd.gather_tree(new, tb.specs["trainable"], mesh)
    if not serve:
        return (float(m["loss"]), m["counts"], new, None, None, comm,
                launches)
    pre = steps.build_prefill(cfg, ShapeConfig("p", 256, 4, "prefill"),
                              mesh=mesh)
    srv = steps.build_serve(cfg, ShapeConfig("d", 512, 4, "decode"),
                            mesh=mesh)
    prompt = torch.randint(0, cfg.vocab_size, (4, 256), generator=torch.Generator(
        device=dev).manual_seed(44), device=dev, dtype=torch.int32)
    rows = None if mesh is None else pre.specs["batch"]
    if mesh is not None:
        prompt = steps.shard_batch(prompt, mesh)
    lg, cache = counted("prefill", lambda: pre.fn(p, tr, prompt))
    cache = model_lib.grow_cache(cache, 512)
    logits, toks = [lg[:, 0]], [lg.argmax(-1)]

    def decode():
        nonlocal lg, cache
        for i in range(4):
            lg, cache = srv.fn(p, tr, cache, toks[-1].to(torch.int32),
                               torch.tensor(256 + i, dtype=torch.int32,
                                            device=dev))
            logits.append(lg[:, 0])
            toks.append(lg.argmax(-1))
    counted("decode", decode, n=4)
    tokens = torch.cat(toks, dim=1)
    if mesh is not None:
        tokens = shd.gather_leaf(tokens, rows, mesh)
        logits = [shd.gather_leaf(x, rows, mesh) for x in logits]
    return float(m["loss"]), m["counts"], new, tokens, logits, comm, launches


def _mesh_four(rank, world, out_dir):
    """Phase 21 with four cards: (a) qwen3-moe-235b-a22b at full width, 2
    layers, on (1, 4), (2, 2) and (2, 1, 2) against rank 0's one-card run
    of the same weights: loss and updated adapters within close_16bit,
    counts' total equal and at most 2% of the routes moved, tokens equal
    or near-ties; mamba2-780m and musicgen-large FULL, uncut, on (2, 2)
    against one card (:func:`_full_on_mesh`); (b) qwen3-moe-235b-a22b and
    llama3-405b at the deepest whole-period cut the estimate fits on (2,
    2) in "batch", jamba-v0.1-52b at ``deepest_fit``'s: two train steps
    at 4096 tokens (batch 8), then a prefill (8 x 4096) and 8 decode
    steps;
    phase 22 (a): both archs at those depths trained once in each
    act_mode (:func:`_act_mode_steps`) and every kernel call of a dmodel
    and an sp forward checked (:func:`_act_mode_calls`); (c) every kernel
    call of one microbatch's forward of the SSM, hybrid and codebook
    archs on (2, 2) checked (:func:`_rank_calls`); on rank 0, the kernels
    at (2, 2)'s per-rank shapes timed."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import INPUT_SHAPES, ShapeConfig, get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.launch.serve import mesh_serve
    from repro_torch.launch.train import MESH_RESERVE, mesh_train
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    log = print if rank == 0 else (lambda *_: None)
    kc = _kernel_tools(torch, dev, [torch.empty(
        2 ** 28, dtype=torch.float32, device=dev)])
    res = {"meshes": {}, "deep": {}}
    # one Mesh a shape for the whole run: each holds NCCL communicators
    meshes = {shape: mesh_lib.Mesh(shape, axes)
              for shape, axes in MESH_SHAPES}
    base = INPUT_SHAPES["train_4k"]
    train_4k = ShapeConfig(base.name, base.seq_len, 8, "train")
    memory = steps.device_bytes(dev) - MESH_RESERVE
    # served first: rank 0's one-card run of granite-20b FULL holds its
    # whole weights (52.5 GiB) beside a prefill of 8 x 4096 tokens
    for arch in SERVE_ON_ROW:
        full = get_config(arch, "full")
        layers = steps.deepest_fit(full, train_4k, meshes[(1, 4)], memory)
        check(layers > 0, f"{arch}: no depth fits (1, 4)")
        _serve_on_mesh(torch, arch, full.replace(num_layers=layers),
                       meshes[(1, 4)], dev, kc, log, res, rank)

    cfg = get_config("qwen3-moe-235b-a22b", "full").replace(num_layers=2)
    params, trainable = _mesh_state(torch, cfg, dev, 51)
    want = None
    if rank == 0:
        want = _compare_run(torch, cfg, params, trainable, None, dev)
        log(f"one card: {cfg.name} 2 layers loss {want[0]:.6f}, tokens "
            f"row 0 {want[3][0].tolist()}")
    dist.barrier()
    for shape, _ in MESH_SHAPES:
        mesh = meshes[shape]
        got = _compare_run(torch, cfg, params, trainable, mesh, dev)
        if rank == 0:
            # the loss is fp32 of bf16 logits: close_16bit's rule
            loss_err = abs(got[0] - want[0])
            check(loss_err <= 1e-2 * abs(want[0]) + 1e-2,
                  f"mesh {shape} loss {got[0]} vs one card {want[0]}")
            ad_err = max(kc["close"](a, b, f"mesh {shape} adapters")
                         for a, b in zip(_leaves(got[2]), _leaves(want[2])))
            cg, cw = got[1]["pos0"], want[1]["pos0"]
            moved = float((cg - cw).abs().sum()) / 2
            total = float(cw.sum())
            check(float(cg.sum()) == total and moved <= 0.02 * total,
                  f"mesh {shape} counts: {moved} of {total} routes moved")
            n_div = _near_tie_tokens(torch, got[3], want[3], want[4], got[4])
            lg_err = max(float((a.float() - b.float()).abs().max())
                         for a, b in zip(got[4], want[4]))
            res["meshes"][str(shape)] = {
                "loss": got[0], "loss_one_card": want[0],
                "adapter_err": ad_err, "routes_moved": moved,
                "routes": total, "rows_diverged": n_div,
                "logit_err": lg_err, "comm": got[5]}
            log(f"mesh {shape} {cfg.name} 2 layers: loss {got[0]:.6f} "
                f"(one card {want[0]:.6f}, |d| {loss_err:.3e}), adapters max "
                f"|d| {ad_err:.3e}, routes moved {moved:.0f} of {total:.0f}, "
                f"decoded rows diverged {n_div} of 4 (near-ties), logits max "
                f"|d| {lg_err:.3e}")
        dist.barrier()
    del params, trainable, want
    gc.collect()
    torch.cuda.empty_cache()

    mesh = meshes[(2, 2)]
    for arch in FULL_ON_MESH:
        _full_on_mesh(torch, arch, mesh, dev, kc, log, res, rank)
    shape = train_4k
    for arch in DEEP_ARCHS + ("jamba-v0.1-52b",):
        t_arch = time.perf_counter()
        full = get_config(arch, "full")
        if arch in DEEP_ARCHS:
            layers = _batch_depth(steps, full, shape, mesh, memory)
        else:
            layers = steps.deepest_fit(full, shape, mesh, memory)
        check(layers > 0, f"{arch}: no depth fits (2, 2)")
        cfg = full.replace(num_layers=layers)
        log(f"deep {arch} on (2, 2): {layers} of {full.num_layers} layers "
            f"(the deepest whole-period cut the estimate fits "
            f"{memory / 2 ** 30:.1f} GiB a card"
            + (" in \"batch\"" if arch in DEEP_ARCHS else "") +
            "), train_4k's batch cut 256 -> 8")
        _build.reset_launches()
        tr = mesh_train(cfg, shape, mesh, dev, steps=2, seed=61, log=log)
        launches = dict(_build.LAUNCHES)
        gc.collect()
        torch.cuda.empty_cache()
        sv = mesh_serve(cfg, mesh, dev, batch=8, prompt_len=4096,
                        cache_len=4096 + 8, new_tokens=9, seed=71, log=log)
        meta = tr["meta"]
        est = meta["rank_fixed_bytes"] + meta["act_bytes"]
        res["deep"][arch] = {
            "layers": layers, "of": full.num_layers, "meta": {
                k: v for k, v in meta.items() if k != "mesh"},
            "estimate_bytes": est,
            "steps": [{k: v for k, v in s.items()} for s in tr["steps"]],
            "train_launches": launches,
            "prefill_s": sv["prefill_s"], "decode_ms": sv["decode_ms"],
            "decode_tokens_per_s": sv["tokens_per_s"],
            "decode_comm": sv["comm"], "prefill_comm": sv["prefill_comm"],
            "serve_peak_bytes": sv["peak_bytes"]}
        log(f"deep {arch}: estimate {est / 2 ** 30:.2f} GiB a rank; "
            f"{time.perf_counter() - t_arch:.1f} s")
        del tr, sv
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()

    # phase 22 (a): the activation modes at phase 21's depths
    res["act_mode"] = {}
    for arch in ("qwen3-moe-235b-a22b", "llama3-405b"):
        full = get_config(arch, "full")
        layers = res["deep"][arch]["layers"]
        res["act_mode"][arch] = _act_mode_steps(
            torch, full.replace(num_layers=layers), shape, mesh, dev, log,
            res["deep"][arch]["meta"])
        res["act_mode"][arch]["deepest_fit_dmodel"] = steps.deepest_fit(
            full, shape, mesh, memory)
        log(f"22 {arch}: deepest_fit with the dmodel fallback "
            f"{res['act_mode'][arch]['deepest_fit_dmodel']} layers (phase "
            f"21, batch only: {layers})")
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    res["act_mode_calls"] = _act_mode_calls(torch, mesh, dev, kc, log)
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    rows = _rank_calls(torch, meshes, dev, kc, log, res, rank)

    if rank == 0:
        res["rows"] = rows + _mesh_rank_shape_rows(torch, dev, kc, res)
        (Path(out_dir) / "mesh_four.json").write_text(json.dumps(res))


# the archs run FULL on (2, 2) against one card
FULL_ON_MESH = ("mamba2-780m", "musicgen-large")
# the archs served on (1, 4) against one card, at deepest_fit's depth:
# phi4-mini's 24/8 heads (6/2 a rank, the prefill's own KV heads
# redistributed by sequence) and granite's MQA (its cache held whole on
# every rank before the sequence split)
SERVE_ON_ROW = ("phi4-mini-3.8b", "granite-20b")
# their serving run: rows, prompt tokens, decode steps
SERVE_SHAPE = (8, 4096, 8)
# (arch, row tag, layers, the LoRA calls timed, mesh) of the per-rank calls
RANK_CALLS = (("mamba2-780m", "M", 2, (("in_proj", 0), ("out_proj", 1)),
               (2, 2)),
              ("jamba-v0.1-52b", "J", 8, (("in_proj", 0), ("out_proj", 1),
                                          ("w1", 2)), (2, 2)),
              ("musicgen-large", "A", 2, (("q", 0), ("w1", 4)), (2, 2)),
              ("phi4-mini-3.8b", "P", 2, (("q", 0),), (1, 4)),
              ("granite-20b", "G", 2, (("q", 0), ("k", 1)), (1, 4)))


def _serve_run(torch, cfg, params, trainable, mesh, dev, feed=None):
    """A prefill of ``SERVE_SHAPE``'s rows x prompt tokens (8 x 4096) and
    its 8 greedy decode steps against a cache as deep as both need, on
    ``mesh`` (None: one device), from this rank's shards of the weights;
    with ``feed`` (rows, steps + 1) step i decodes ``feed[:, i]``
    (teacher-forced) in place of the last argmax.  Returns the argmax
    tokens (rows, steps + 1), each step's logits (whole), the collectives
    by kind of the prefill and of one decode step (all steps' over their
    number: [calls, bytes, ms]), the launches of the run, the prefill s
    and each decode step's ms."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import _build
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    from repro_torch.models import parallel
    B, S, n = SERVE_SHAPE
    pre = steps.build_prefill(cfg, ShapeConfig("p", S, B, "prefill"),
                              mesh=mesh)
    srv = steps.build_serve(cfg, ShapeConfig("d", S + n, B, "decode"),
                            mesh=mesh)
    p, tr = params, trainable
    prompt = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator(device=dev).manual_seed(
                               45), device=dev, dtype=torch.int32)
    if mesh is not None:
        prompt = steps.shard_batch(prompt, mesh)
        if feed is not None:
            feed = steps.shard_batch(feed, mesh)
    comm = {}
    torch.cuda.synchronize()
    _build.reset_launches()
    parallel.comm_start()
    t0 = time.perf_counter()
    lg, cache = pre.fn(p, tr, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    comm["prefill"] = parallel.comm_stop()["by_kind"]
    if mesh is None:
        cache = model_lib.grow_cache(cache, S + n)
    else:
        cache = shd.grow_cache(cache, pre.specs["cache"], srv.specs["cache"],
                               S + n, mesh)
    logits, toks, step_ms = [lg[:, 0]], [lg.argmax(-1)], []
    parallel.comm_start()
    for i in range(n):
        nxt = toks[-1] if feed is None else feed[:, i:i + 1]
        t0 = time.perf_counter()
        lg, cache = srv.fn(p, tr, cache, nxt.to(torch.int32),
                           torch.tensor(S + i, dtype=torch.int32,
                                        device=dev))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg[:, 0])
        toks.append(lg.argmax(-1))
    comm["decode"] = {k: [x / n for x in v] for k, v in
                      parallel.comm_stop()["by_kind"].items()}
    launches = dict(_build.LAUNCHES)
    tokens = torch.cat(toks, dim=1)
    if mesh is not None:
        rows = pre.specs["batch"]
        tokens = shd.gather_leaf(tokens, rows, mesh)
        logits = [shd.gather_leaf(x, rows, mesh) for x in logits]
    return tokens, logits, comm, launches, prefill_s, step_ms


# the (1, 4) serving runs' logits against one card's, row by row: bf16
# rounds the row-split products' partial sums before their all-reduce, and
# the difference compounds over 32-52 layers (unit roundoff 2^-8 times
# sqrt(2 x 52) is 0.04), beyond close_16bit's one ulp, so the gate is the
# relative L2 of each row; close_16bit's verdict is printed beside it
SERVE_REL_L2 = 5e-2


def _serve_on_mesh(torch, arch, cfg, mesh, dev, kc, log, res, rank):
    """Phase 21, four cards: ``cfg`` (of ``arch``) served on ``mesh``
    (:func:`_serve_run`) against rank 0's one-card run of the same weights
    and depth, the mesh run fed the one card's tokens (so every step
    compares the same inputs): every row's logits within ``SERVE_REL_L2``
    relative L2 at every step, and each step's argmax equal to the one
    card's or a near tie (the one card's top-2 gap no larger than the
    row's largest |mesh - one card| logit difference)."""
    import gc

    import torch.distributed as dist
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    t0 = time.perf_counter()
    params, trainable = _mesh_state(torch, cfg, dev, 57)
    want = None
    B, _, n = SERVE_SHAPE
    feed = torch.empty((B, n + 1), dtype=torch.int64, device=dev)
    if rank == 0:
        free, total = torch.cuda.mem_get_info()
        log(f"{arch} ({cfg.num_layers} layers): whole weights "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated, "
            f"{free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB free before "
            "the one-card run")
        want = _serve_run(torch, cfg, params, trainable, None, dev)
        feed.copy_(want[0])
    dist.broadcast(feed, 0)
    p = shd.shard_tree(params, shd.param_specs(
        cfg, steps.abstract_params(cfg), mesh), mesh)
    tr = shd.shard_tree(trainable, shd.trainable_specs(cfg, trainable, mesh),
                        mesh)
    del params, trainable
    gc.collect()
    torch.cuda.empty_cache()
    # the first collective on a group starts its NCCL communicator (seconds):
    # outside the timed prefill
    for axes in ("model", mesh.axis_names):
        if mesh.group(axes) is not None:
            dist.all_reduce(torch.zeros(1, device=dev), group=mesh.group(axes))
    got = _serve_run(torch, cfg, p, tr, mesh, dev, feed)
    del p, tr
    if rank == 0:
        key = f"{arch} {tuple(mesh.shape.values())}"
        rel, abs_err, ok16, ties = 0.0, 0.0, True, 0
        for j, (g, w) in enumerate(zip(got[1], want[1])):
            g, w = g.float(), w.float()
            d = (g - w).abs()
            r = float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())
            check(r <= SERVE_REL_L2, f"{key} logits step {j}: a row's "
                  f"relative L2 {r:.3e} > {SERVE_REL_L2:g}")
            rel, abs_err = max(rel, r), max(abs_err, float(d.max()))
            ok16 = ok16 and bool((d <= 1e-2 * w.abs() + 1e-2).all())
            for b_ in (got[0][:, j] != want[0][:, j]).nonzero()[:, 0].tolist():
                top2 = w[b_].topk(2).values
                gap = float(top2[0] - top2[1])
                check(gap <= float(d[b_].max()), f"{key} step {j} row {b_}: "
                      f"argmax differs, top-2 gap {gap:.4f} > max |d| "
                      f"{float(d[b_].max()):.4f}")
                ties += 1
        med = sorted(got[5])[len(got[5]) // 2]
        res["meshes"][key] = {
            "layers": cfg.num_layers, "logit_rel_l2": rel,
            "logit_err": abs_err, "close_16bit": ok16, "near_ties": ties,
            "comm": {k: {kind: v[:2] for kind, v in c.items()}
                     for k, c in got[2].items()},
            "comm_ms": {k: {kind: v[2] for kind, v in c.items()}
                        for k, c in got[2].items()},
            "launches": got[3],
            "prefill_s": got[4], "decode_ms": got[5],
            "one_card_prefill_s": want[4], "one_card_decode_ms": want[5]}
        kinds = "; ".join(
            f"{what}: " + ", ".join(f"{k} {v[0]:g} calls {v[1] / 2 ** 20:.2f}"
                                    f" MiB {v[2]:.2f} ms" for k, v in
                                    c.items())
            for what, c in got[2].items())
        log(f"mesh {tuple(mesh.shape.values())} {cfg.name} ({cfg.num_layers} "
            f"layers) served {B} x {SERVE_SHAPE[1]} + {n} decode steps fed "
            f"the one card's tokens: logits max row relative L2 {rel:.3e} "
            f"(gate {SERVE_REL_L2:g}), max |d| {abs_err:.3e}, within "
            f"close_16bit {ok16}; argmax near-ties {ties} of {B * (n + 1)}; "
            f"prefill {got[4]:.3f} s (one card {want[4]:.3f}), decode p50 "
            f"{med:.2f} ms (one card {sorted(want[5])[n // 2]:.2f}); "
            f"collectives {kinds}; launches "
            f"{json.dumps(got[3])}; {time.perf_counter() - t0:.1f} s")
    dist.barrier()
    del want, got
    gc.collect()
    torch.cuda.empty_cache()


def _full_on_mesh(torch, arch, mesh, dev, kc, log, res, rank):
    """Phase 21, four cards: ``arch`` at full width and depth on ``mesh``
    against rank 0's one-card run of the same weights
    (:func:`_compare_run`): loss and updated adapters within close_16bit;
    a text arch also prefills and decodes 4 steps, its tokens equal or
    near-ties (an audio arch trains only, as the reference's launchers
    run it)."""
    import gc

    import torch.distributed as dist
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config(arch, "full")
    serve = not cfg.num_codebooks
    params, trainable = _mesh_state(torch, cfg, dev, 53)
    want = None
    if rank == 0:
        want = _compare_run(torch, cfg, params, trainable, None, dev, serve)
    dist.barrier()
    got = _compare_run(torch, cfg, params, trainable, mesh, dev, serve)
    if rank == 0:
        loss_err = abs(got[0] - want[0])
        check(loss_err <= 1e-2 * abs(want[0]) + 1e-2,
              f"{arch} on (2, 2): loss {got[0]} vs one card {want[0]}")
        ad_err = max(kc["close"](a, b, f"{arch} (2, 2) adapters")
                     for a, b in zip(_leaves(got[2]), _leaves(want[2])))
        rec = {"layers": cfg.num_layers, "loss": got[0],
               "loss_one_card": want[0], "adapter_err": ad_err,
               "comm": got[5], "launches": got[6]}
        text = ""
        if serve:
            rec["rows_diverged"] = _near_tie_tokens(torch, got[3], want[3],
                                                    want[4], got[4])
            rec["logit_err"] = max(float((a.float() - b.float()).abs().max())
                                   for a, b in zip(got[4], want[4]))
            text = (f", decoded rows diverged {rec['rows_diverged']} of 4 "
                    f"(near-ties), logits max |d| {rec['logit_err']:.3e}")
        res["meshes"][f"{arch} (2, 2)"] = rec
        log(f"mesh (2, 2) {arch} FULL ({cfg.num_layers} layers): loss "
            f"{got[0]:.6f} (one card {want[0]:.6f}, |d| {loss_err:.3e}), "
            f"adapters max |d| {ad_err:.3e}{text}; train launches "
            f"{json.dumps(got[6])}; {time.perf_counter() - t0:.1f} s")
    dist.barrier()
    del params, trainable, want, got
    gc.collect()
    torch.cuda.empty_cache()


def _rank_calls(torch, meshes, dev, kc, log, res, rank):
    """Phase 21, four cards: every kernel call of one microbatch's forward
    (B = 1 a rank, S = 4096) of each ``RANK_CALLS`` arch at full width on
    its mesh (of ``meshes``) against its plain version within close_16bit,
    on every rank;
    rank 0 times layer 0's calls beside the launches of the arch's run
    on the mesh (jamba: the deep train step; mamba2, musicgen: the FULL
    step against one card; phi4-mini, granite: the (1, 4) serving run).
    Returns rank 0's rows."""
    import gc

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    from repro_torch.models.parallel import Shard
    rows = []
    for arch, tag, layers, picks, shape in RANK_CALLS:
        mesh = meshes[shape]
        cfg = get_config(arch, "full").replace(num_layers=layers)
        params, trainable = _mesh_state(torch, cfg, dev, 31)
        a_params = steps.abstract_params(cfg)
        p_loc = shd.shard_tree(params, shd.param_specs(cfg, a_params, mesh),
                               mesh)
        t_loc = shd.shard_tree(trainable, shd.trainable_specs(
            cfg, trainable, mesh), mesh)
        del params, trainable
        gen = torch.Generator(device=dev).manual_seed(92)
        B = shape[0]
        tok = torch.randint(0, cfg.vocab_size, steps.token_shape(cfg, B, 4096),
                            generator=gen, device=dev, dtype=torch.int32)
        tok, lab = (steps.shard_batch(t, mesh) for t in (tok, tok.roll(-1, 1)))
        mask = torch.ones((1, 4096), device=dev)
        groups = steps.choose_num_groups(cfg, B, 4096, mesh=mesh)
        with torch.no_grad():
            _, calls = _recorded(torch, lambda: model_lib.lm_loss(
                cfg, p_loc, tok, lab, mask, trainable=t_loc,
                k=cfg.moe.top_k or None, num_groups=groups,
                shard=Shard(mesh)))
        what = f"21{tag} {cfg.name} {shape} per rank"
        errs = _mesh_call_checks(torch, cfg, calls, kc, what)
        log(f"{what} ({layers} layers): every kernel call of one "
            f"microbatch's forward (B=1 a rank, S=4096) vs plain, max err "
            f"{json.dumps(errs)}")
        if rank == 0:
            run = (res["deep"][arch]["train_launches"] if arch in res["deep"]
                   else res["meshes"][f"{arch} {shape}"]["launches"])
            rows += _mesh_rows(torch, calls, kc, run, what, errs, picks)
        del calls, p_loc, t_loc
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    return rows


def _mesh_rank_shape_rows(torch, dev, kc, res):
    """Rank 0: the kernels at (2, 2)'s per-rank shapes of the deep runs
    (S = 4096, one sequence a microbatch), held against their plain
    versions and timed: flash at qwen3's 32/2 and llama3's 64/4 heads,
    ``lora_matmul`` at qwen3's q (4096 -> 4096) and llama3's FFN w1
    (16384 -> 26624), ``lora_matmul_experts`` at 64 local experts; the
    router as on one card (it is replicated).  Also the shapes of a rank
    of the production meshes' 16-way model axis, which only the dry run
    runs: flash at phi4-mini's 2/1 and granite's 3/1 heads, phi4-mini's
    q from the gathered ``wq`` columns (3072 -> 256)."""
    from repro_torch.kernels import backend, ref
    gen = torch.Generator(device=dev).manual_seed(81)
    t = kc["time_ms"]
    rows = []
    S = 4096

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    # the deep runs' ranks, then a rank of the 16-way model axis, which
    # only the dry run runs (no launch here): phi4-mini's 2 heads over one
    # KV head (of 1.5 its own) and granite's 3 over its one
    for what, H, KV, launches in (
            ("21 qwen3-moe-235b-a22b (2, 2)", 32, 2,
             res["deep"]["qwen3-moe-235b-a22b"]["train_launches"][
                 "flash_attention"]),
            ("21 llama3-405b (2, 2)", 64, 4,
             res["deep"]["llama3-405b"]["train_launches"][
                 "flash_attention"]),
            ("phi4-mini-3.8b 16-way, dry run only", 2, 1, 0),
            ("granite-20b 16-way, dry run only", 3, 1, 0)):
        q, k, v = randn(1, S, H, 128), randn(1, S, KV, 128), randn(1, S, KV, 128)
        kw = {"causal": True, "window": 0, "softcap": 0.0}
        err = kc["close"](backend.flash_attention(q, k, v, **kw),
                          ref.flash_attention_ref(
                              q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), **kw).transpose(1, 2),
                          f"flash {what}")
        f_ms, f_pl, f_nb, f_fl, f_lib, f_what = _time_flash(
            torch, ("flash_attention", (q, k, v), kw), kc)
        rows.append(_row(
            f"flash_attention ({what} per rank, B=1, S={S}, H={H}, "
            f"KV={KV}, D=128)", "flash_attention.cu", "flash_attention.py:92",
            err, f_ms, f_pl, bound_ms(f_nb, f_fl, BF16_FLOPS), f_lib,
            launches, f_what))
        del q, k, v
    for what, name, K, N, launches in (
            ("21 qwen3-moe-235b-a22b (2, 2)", "q per rank", 4096, 4096,
             res["deep"]["qwen3-moe-235b-a22b"]["train_launches"][
                 "lora_matmul"]),
            ("21 llama3-405b (2, 2)", "w1 per rank", 16384, 26624,
             res["deep"]["llama3-405b"]["train_launches"]["lora_matmul"]),
            ("phi4-mini-3.8b 16-way, dry run only:", "q of 2 heads from the "
             "gathered columns", 3072, 256, 0)):
        rows += _lora_shape_rows(torch, dev, kc, what, [(S, K, N, 16, name)],
                                 launches, 82, 2.0)
    E, C, K, N = 64, 8 * 168, 4096, 1536
    x, w = randn(E, C, K), randn(E, K, N, scale=K ** -0.5)
    a, b = randn(E, K, 16, scale=K ** -0.5), randn(E, 16, N, scale=0.5)
    err = kc["close"](backend.lora_matmul_experts(x, w, a, b, scale=2.0),
                      ref.lora_matmul_experts_ref(x, w, a, b, 2.0),
                      "experts (2, 2)")
    rows.append(_row(
        f"lora_matmul_experts (21 qwen3 w1 (2, 2) per rank, E={E}, "
        f"G·C={C}, {K}->{N}, r=16)", "lora_matmul.cu", "lora_matmul.py:101",
        err, t(lambda: backend.lora_matmul_experts(x, w, a, b, scale=2.0)),
        t(lambda: ref.lora_matmul_experts_ref(x, w, a, b, 2.0)),
        bound_ms(2 * E * (C * K + K * N + K * 16 + 16 * N + C * N),
                 2.0 * E * C * (K * N + K * 16 + 16 * N), BF16_FLOPS),
        t(lambda: torch.bmm(x, w)),
        res["deep"]["qwen3-moe-235b-a22b"]["train_launches"][
            "lora_matmul_experts"], "torch.bmm(x, W), base product only"))
    return rows


# --------------------------------------------------------------------------
# 22. act_mode on the mesh, and the dry run against the cards
# --------------------------------------------------------------------------

ACT_MODES = ("batch", "dmodel", "sp")
DEEP_ARCHS = ("qwen3-moe-235b-a22b", "llama3-405b")
CARDS_PER_NODE = 4               # the four-card machine is one node


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _batch_depth(steps, full, shape, mesh, memory):
    """Phase 21's depth: the deepest whole-period cut at which the knob
    chooser keeps act_mode "batch" within ``memory`` a card (its own
    ``deepest_fit`` also counts the "dmodel" fallback, phase 22 (a))."""
    def fits(n):
        try:
            knobs = steps.choose_train_knobs(
                full.replace(num_layers=n * full.pattern_period), shape,
                mesh=mesh, memory_bytes=memory)
        except steps.DoesNotFit:
            return False
        return knobs["act_mode"] == "batch"
    P = full.pattern_period
    return steps.most_periods(fits, full.num_layers // P) * P


def _act_mode_steps(torch, cfg, shape, mesh, dev, log, chosen):
    """Phase 22 (a) for one arch, on every rank: phase 21's weights (seed
    61), trainable tree and first batch at its depth, one train step in
    each act_mode at the knobs phase 21's run chose (``chosen``, its
    meta), passed explicitly.
    The launch counters are zeroed before each step and read after it.
    Each step's loss, counts, adapters and Adam moments go to the host;
    dmodel and sp must equal batch's bit for bit."""
    import gc

    from repro_torch.configs import TrainConfig
    from repro_torch.kernels import _build
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import rank_peaks
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models import parallel
    from repro_torch.optim import adam
    seed = 61
    knobs = {k: chosen[k] for k in ("n_micro", "num_groups", "remat_chunk")}
    params = shd.init_sharded_params(cfg, mesh, seed, dev)
    trainable = shd.init_sharded_lora(cfg, mesh, seed + 1, chosen["k"] or 0,
                                      dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    batch = [steps.shard_batch(t, mesh, knobs["n_micro"])
             for t in synthetic_batch(cfg, shape, gen, dev)]
    out, host = {"knobs": knobs}, {}
    for mode in ACT_MODES:
        b = steps.build_train(cfg, shape, tc=TrainConfig(), device=dev,
                              mesh=mesh, act_mode=mode, **knobs)
        check(b.meta["act_mode"] == mode, f"{cfg.name}: {mode} ran as "
              f"{b.meta['act_mode']}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        parallel.comm_start()
        t0 = time.perf_counter()
        tr, opt, m = b.fn(params, trainable, adam.init(trainable), *batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        comm = parallel.comm_stop()
        launches = dict(_build.LAUNCHES)
        peaks = rank_peaks(dev)
        host[mode] = _host({"loss": m["loss"], "counts": m["counts"],
                            "trainable": tr, "mu": opt.mu, "nu": opt.nu})
        out[mode] = {"loss": float(m["loss"]), "s": dt,
                     "tokens_per_s": shape.global_batch * shape.seq_len / dt,
                     "peak_bytes": peaks, "comm": comm,
                     "launches": launches, "act_bytes": b.meta["act_bytes"]}
        kinds = ", ".join(f"{k} {v[0]} calls {v[1] / 2 ** 30:.3f} GiB "
                          f"{v[2]:.1f} ms" for k, v in comm["by_kind"].items())
        log(f"22 {cfg.name} ({cfg.num_layers} layers) act_mode {mode}: loss "
            f"{out[mode]['loss']:.6f}, {dt:.3f} s/step, peak per rank ["
            + ", ".join(f"{p / 2 ** 30:.2f}" for p in peaks) + "] GiB "
            f"(estimate's activations {b.meta['act_bytes'] / 2 ** 30:.2f} "
            f"GiB); collectives {kinds}; launches {json.dumps(launches)}")
        check(all(launches[k] > 0 for k in _launch_names(cfg)),
              f"{cfg.name} {mode} step launched {launches}")
        del tr, opt, m
        gc.collect()
        torch.cuda.empty_cache()
    for mode in ACT_MODES[1:]:
        same = _bit_equal(torch, host[mode], host["batch"])
        out[mode]["bit_equal"] = same
        drop = [(a - b) / 2 ** 30 for a, b in zip(out["batch"]["peak_bytes"],
                                                  out[mode]["peak_bytes"])]
        log(f"22 {cfg.name}: {mode} bit-equal to batch (loss, counts, "
            f"adapters, Adam) {same}; peak per rank fell by ["
            + ", ".join(f"{d:.2f}" for d in drop) + "] GiB")
        check(same, f"{cfg.name}: the {mode} step differs from the batch "
              "step")
    del params, trainable, batch
    return out


def _act_mode_calls(torch, mesh, dev, kc, log):
    """Phase 22 (a), the kernels: qwen3-moe and llama3 at full width cut to
    2 layers on every rank of ``mesh``; every kernel call of one
    microbatch's forward (B = 1 a rank, S = 4096) in dmodel and in sp
    against its plain version within close_16bit.  Returns {arch: {mode:
    max err by kernel}}."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    from repro_torch.models.parallel import Shard
    out = {}
    for arch in DEEP_ARCHS:
        cfg = get_config(arch, "full").replace(num_layers=2)
        params, trainable = _mesh_state(torch, cfg, dev, 31)
        a_params = steps.abstract_params(cfg)
        p_loc = shd.shard_tree(params, shd.param_specs(cfg, a_params, mesh),
                               mesh)
        t_loc = shd.shard_tree(trainable, shd.trainable_specs(
            cfg, trainable, mesh), mesh)
        del params, trainable
        gen = torch.Generator(device=dev).manual_seed(91)
        tok = torch.randint(0, cfg.vocab_size, (1, 4096), generator=gen,
                            device=dev, dtype=torch.int32)
        lab = tok.roll(-1, dims=1)
        mask = torch.ones((1, 4096), device=dev)
        out[arch] = {}
        # the deep steps' routing groups: 2 sequences a microbatch
        groups = steps.choose_num_groups(cfg, 2, 4096, mesh=mesh)
        for mode in ACT_MODES[1:]:
            with torch.no_grad():
                _, calls = _recorded(torch, lambda: model_lib.lm_loss(
                    cfg, p_loc, tok, lab, mask, trainable=t_loc,
                    k=cfg.moe.top_k or None, num_groups=groups,
                    shard=Shard(mesh, act_mode=mode)))
            errs = _mesh_call_checks(torch, cfg, calls, kc,
                                     f"22 {cfg.name} (2, 2) {mode}")
            out[arch][mode] = errs
            log(f"22 {cfg.name} (2, 2) {mode}: every kernel call of one "
                f"microbatch's forward (B=1 a rank, S=4096) vs plain, max "
                f"err {json.dumps(errs)}")
            del calls
        del p_loc, t_loc
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _dry_pairs(memory, deep=None, row=None):
    """The dry-run pairs of the cards' runs: {tag: spec}, the knob
    chooser's budget ``memory`` as on the cards.  One card (``deep``
    None): phase 21's (1, 1) pairs.  Four (``deep``: {arch: (the depth
    the workers ran, the act_modes its train step ran in)}; ``row``:
    {arch: the depth served on (1, 4)}): the 2-layer qwen3 on (2, 2) and
    (1, 4), mamba2 and musicgen FULL on (2, 2), the (1, 4) serving runs'
    prefill and decode step, the deep runs' train steps, their prefill
    and decode step, and one 16 x 16 pair."""
    from repro_torch.configs import get_config
    q = DEEP_ARCHS[0]

    def pair(arch, shape, mesh, layers=None, card=None, **overrides):
        # card: where the cards' run keeps its counts (_card_counts)
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "replace": {"num_layers": layers} if layers else None,
                "overrides": overrides, "memory_bytes": memory,
                "card": card}
    if deep is None:
        pairs = {}
        for a, _, n, _, serve in MESH_ONE:
            pairs[f"(1, 1) {a} train"] = pair(
                a, ["train_2k", 2048, 2, "train"], [1, 1], n, n_micro=2)
            if serve:
                pairs[f"(1, 1) {a} prefill"] = pair(
                    a, ["p", 512, 2, "prefill"], [1, 1], n)
                pairs[f"(1, 1) {a} decode"] = pair(
                    a, ["d", 1024, 2, "decode"], [1, 1], n)
        return pairs
    pairs = {}
    for mesh in ([2, 2], [1, 4]):
        tag = f"({mesh[0]}, {mesh[1]}) {q} 2 layers"
        two = ["meshes", str(tuple(mesh))]
        pairs[f"{tag} train"] = pair(q, ["t", 1024, 4, "train"], mesh, 2,
                                     two + ["train"], n_micro=2,
                                     num_groups=2)
        pairs[f"{tag} prefill"] = pair(q, ["p", 256, 4, "prefill"], mesh, 2,
                                       two + ["prefill"])
        pairs[f"{tag} decode"] = pair(q, ["d", 512, 4, "decode"], mesh, 2,
                                      two + ["decode"])
    for arch in FULL_ON_MESH:
        tag = f"(2, 2) {arch} full"
        card = ["meshes", f"{arch} (2, 2)"]
        pairs[f"{tag} train"] = pair(arch, ["t", 1024, 4, "train"], [2, 2],
                                     None, card + ["train"], n_micro=2,
                                     num_groups=2)
        if not get_config(arch, "full").num_codebooks:
            pairs[f"{tag} prefill"] = pair(arch, ["p", 256, 4, "prefill"],
                                           [2, 2], None, card + ["prefill"])
            pairs[f"{tag} decode"] = pair(arch, ["d", 512, 4, "decode"],
                                          [2, 2], None, card + ["decode"])
    B, S, n_steps = SERVE_SHAPE
    for arch, n in row.items():
        tag = f"(1, 4) {arch} {n} layers"
        card = ["meshes", f"{arch} (1, 4)"]
        pairs[f"{tag} prefill"] = pair(arch, ["p", S, B, "prefill"],
                                       [1, 4], n, card + ["prefill"])
        pairs[f"{tag} decode"] = pair(arch, ["d", S + n_steps, B, "decode"],
                                      [1, 4], n, card + ["decode"])
    for arch, (n, modes) in deep.items():
        tag = f"(2, 2) {arch} {n} layers"
        for mode in modes:
            pairs[f"{tag} train {mode}"] = pair(
                arch, ["train_4k", 4096, 8, "train"], [2, 2], n,
                ["deep", arch, mode if len(modes) > 1 else "batch"],
                act_mode=mode)
        pairs[f"{tag} prefill"] = pair(arch, ["prefill", 4096, 8, "prefill"],
                                       [2, 2], n, ["deep", arch, "prefill"])
        pairs[f"{tag} decode"] = pair(arch, ["decode", 4104, 8, "decode"],
                                      [2, 2], n, ["deep", arch, "decode"])
    pairs[f"(16, 16) {q} train_4k"] = pair(q, ["train_4k", 4096, 256,
                                              "train"], [16, 16])
    return pairs


DRY_RUN = """
import json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.configs import ShapeConfig
from repro_torch.launch.dryrun import run_pair
pairs, out = json.load(open(sys.argv[1])), {}
for tag, p in pairs.items():
    t0 = time.perf_counter()
    rec = run_pair(p["arch"], p["shape"][0], shape=ShapeConfig(*p["shape"]),
                   mesh_shape=tuple(p["mesh"]), cfg_replace=p["replace"],
                   overrides=p["overrides"], memory_bytes=p["memory_bytes"],
                   cards_per_node=int(sys.argv[3]))
    rec["wall_s"] = time.perf_counter() - t0
    out[tag] = rec
json.dump(out, open(sys.argv[2], "w"), default=str)
"""


def _start_dry(pairs, name, procs):
    """The dry run of ``pairs`` in ``procs`` subprocesses of their own (no
    card visible to them: a fake world and ``meta`` tensors only)."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    tags = list(pairs)
    running = []
    for i in range(procs):
        mine = {t: pairs[t] for t in tags[i::procs]}
        if not mine:
            continue
        spec = MESH_DIR / f"dry_{name}_{i}.json"
        res = MESH_DIR / f"dry_{name}_{i}_out.json"
        spec.write_text(json.dumps(mine))
        log = open(MESH_DIR / f"dry_{name}_{i}.log", "w")
        running.append((subprocess.Popen(
            [sys.executable, "-c", DRY_RUN, str(spec), str(res),
             str(CARDS_PER_NODE)], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=str(ROOT)), res, log))
    return running


def _finish_dry(running, timeout=900):
    recs = {}
    for proc, res, log in running:
        rc = proc.wait(timeout=timeout)
        log.close()
        check(rc == 0, f"dry run exited {rc}: "
              + Path(log.name).read_text()[-2000:])
        recs.update(json.loads(res.read_text()))
    return recs


def _gib(b):
    return "not measured" if b is None else f"{b / 2 ** 30:.2f} GiB"


def _compare_one(recs, peaks):
    """The (1, 1) pairs: no collectives in a world of one; the estimate's
    peak beside the measured one."""
    for tag, rec in recs.items():
        check(not rec["collectives"]["execs_by_kind"],
              f"dry run {tag}: collectives in a world of one")
        what = tag.split(" ", 2)[2]
        r = rec["roofline"]
        print(f"22 dry run {tag}: estimate {rec['memory']['peak_gb']:.2f} "
              f"GiB a rank vs measured {_gib(peaks.get(what))}; roofline "
              f"compute {r['t_compute_ms']:.2f} memory {r['t_memory_ms']:.2f}"
              f" ms; traced in {rec['t_trace_s']} s")


def _card_counts(card, res):
    """What the cards counted for a dry-run pair (its spec's ``card``):
    ({kind: [calls, bytes]}, measured peak bytes or None, seconds or None,
    collective ms or None)."""
    def by_kind(comm, n=1):
        return {k: [v[0] / n, v[1] / n] for k, v in comm["by_kind"].items()}
    if card[0] == "meshes":
        return res["meshes"][card[1]]["comm"][card[2]], None, None, None
    _, arch, what = card
    deep = res["deep"][arch]
    if what == "prefill":
        return (by_kind(deep["prefill_comm"]), max(deep["serve_peak_bytes"]),
                deep["prefill_s"], deep["prefill_comm"]["ms"])
    if what == "decode":
        n = len(deep["decode_ms"])
        ms = sorted(deep["decode_ms"])[n // 2]
        return (by_kind(deep["decode_comm"], n),
                max(deep["serve_peak_bytes"]), ms / 1e3,
                deep["decode_comm"]["ms"] / n)
    if what == "batch":          # the deep run's own step (mesh_train)
        st = deep["steps"][-1]
    else:
        st = res["act_mode"][arch][what]
    return (by_kind(st["comm"]), max(st["peak_bytes"]), st["s"],
            st["comm"]["ms"])


def _compare_four(recs, pairs, res):
    """Each pair's collective calls and bytes by kind equal to the
    cards'; the estimate's peak and the roofline beside the measured."""
    for tag, rec in recs.items():
        r = rec["roofline"]
        if tag.startswith("(16, 16)"):
            print(f"22 dry run {tag}: traced in {rec['t_trace_s']} s "
                  f"({rec['wall_s']:.1f} s with the build); "
                  f"{json.dumps(rec['collectives']['execs_by_kind'])}; "
                  f"estimate {rec['memory']['peak_gb']:.2f} GiB a rank; "
                  f"roofline compute {r['t_compute_ms']:.1f} memory "
                  f"{r['t_memory_ms']:.1f} collective "
                  f"{r['t_collective_ms']:.1f} ms ({r['bottleneck']})")
            continue
        got, peak, sec, coll_ms = _card_counts(pairs[tag]["card"], res)
        dry = {k: [rec["collectives"]["execs_by_kind"][k],
                   rec["collectives"]["bytes_by_kind"][k]]
               for k in rec["collectives"]["execs_by_kind"]}
        same = dry == got
        print(f"22 dry run {tag}: collectives {json.dumps(dry)} vs cards "
              f"{json.dumps(got)}: equal {same}; estimate "
              f"{rec['memory']['peak_gb']:.2f} GiB a rank vs measured peak "
              f"{_gib(peak)}; roofline compute {r['t_compute_ms']:.1f} "
              f"memory {r['t_memory_ms']:.1f} collective "
              f"{r['t_collective_ms']:.1f} ms ({r['bottleneck']}) vs "
              + ("not measured" if sec is None else
                 f"{sec * 1e3:.1f} ms a step, collectives {coll_ms:.1f} ms")
              + f"; traced in {rec['t_trace_s']} s")
        check(same, f"dry run {tag}: the collectives differ from the cards'")


def mesh_phase(torch):
    """Phase 21: the card mesh (the module docstring).  The parent frees
    its cached memory, then spawns the workers (one a card, NCCL); their
    checks raise there and fail the phase.  Returns the kernel rows."""
    import gc

    from repro_torch.launch.mesh import spawn
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    n = torch.cuda.device_count()
    print(f"mesh phase: {n} card(s) visible; mesh (1, 1) on one card "
          "(a world of one NCCL rank)")
    from repro_torch.launch.steps import device_bytes
    from repro_torch.launch.train import MESH_RESERVE
    from repro_torch.launch.dryrun import MEMORY_BYTES
    total = device_bytes("cuda")
    # the knob chooser's budget, as train.py sets it on this card
    memory = total - MESH_RESERVE
    print(f"mesh phase: the card's total_memory {total} B; the dry run's "
          f"default budget assumes {MEMORY_BYTES + MESH_RESERVE} B: "
          f"{'equal' if total == MEMORY_BYTES + MESH_RESERVE else 'differ'}")
    # the dry runs start once the workers have returned: none of their
    # timed windows shares the host with them
    spawn(_mesh_one, 1, str(MESH_DIR), backend="nccl")
    rows = json.loads((MESH_DIR / "mesh_rows_1.json").read_text())
    t1 = time.perf_counter()
    _compare_one(_finish_dry(_start_dry(_dry_pairs(MESH_ONE_BUDGET), "one",
                                        2)),
                 json.loads((MESH_DIR / "mesh_one.json").read_text()))
    print(f"22 dry run (1, 1): {time.perf_counter() - t1:.1f} s after "
          "the card")
    if n >= 4:
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        print("mesh phase: four cards visible (" + "; ".join(cards)
              + "): meshes (1, 4), (2, 2), (2, 1, 2) at 2 layers, mamba2 and "
              "musicgen FULL on (2, 2), phi4-mini and granite served on (1, "
              "4), then the deepest cuts on (2, 2)")
        spawn(_mesh_four, 4, str(MESH_DIR), backend="nccl")
        four = json.loads((MESH_DIR / "mesh_four.json").read_text())
        rows += four.pop("rows")
        print(f"mesh four-card results: {json.dumps(four)}")
        t1 = time.perf_counter()
        pairs = _dry_pairs(memory, {
            a: (d["layers"], ACT_MODES if a in DEEP_ARCHS
                else (d["meta"]["act_mode"],))
            for a, d in four["deep"].items()},
            {a: four["meshes"][f"{a} (1, 4)"]["layers"] for a in SERVE_ON_ROW})
        _compare_four(_finish_dry(_start_dry(pairs, "four", 4)), pairs, four)
        print(f"22 dry run: {time.perf_counter() - t1:.1f} s after the "
              "cards")
    else:
        print("mesh phase: (1, 4), (2, 2), (2, 1, 2) and the deepest cuts "
              f"need four cards; {n} visible, so only (1, 1) ran")
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return rows


if __name__ == "__main__":
    sys.exit(main())
