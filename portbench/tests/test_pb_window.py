"""The benchmark's window arithmetic, its operation and byte counts, and
its traffic generator, against hand values."""
import math

import numpy as np
import pytest
import torch

from portbench import flops, peaks, traffic, window
from portbench.counts import flash_attention, lora_matmul, \
    ragged_expert_matmul
from portbench.trace import charge_gaps

OLMOE = {"num_layers": 16, "d_model": 2048, "n_heads": 16, "n_kv_heads": 16,
         "head_dim": 128, "vocab_size": 50304, "num_experts": 64,
         "top_k": 8, "d_expert": 1024, "num_shared_experts": 0,
         "d_shared_expert": 0, "lora_rank": 20}


def test_rate_and_tail_from_raw_samples():
    assert window.rate(300.0, 12.0) == 25.0
    with pytest.raises(ValueError):
        window.rate(1.0, 0.0)
    xs = list(range(1, 101))
    assert window.percentile(xs, 95) == pytest.approx(95.05)
    assert math.isnan(window.percentile([], 95))
    # a missing request is an infinite wait: it lands in the tail
    assert window.percentile([1.0] * 90 + [math.inf] * 10, 95) > 1e300
    assert window.percentile([1.0] * 99 + [math.inf], 50) == 1.0


@pytest.mark.parametrize("intervals,length", [
    ([(0, 2), (1, 3), (5, 6)], 4),
    ([(0, 10), (2, 3)], 10),
    ([], 0),
    ([(4, 5), (0, 1)], 2)])
def test_union_of_intervals(intervals, length):
    assert window.union_length(intervals) == length


def test_idle_share_and_gaps_charged_to_innermost_span():
    busy = [(0, 2), (1, 3), (5, 6)]
    assert window.gaps(busy, 0, 10) == [(3, 5), (6, 10)]
    assert window.idle_share(window.union_length(busy), 10) == \
        pytest.approx(60.0)
    spans = [(0, 100, "round"), (2, 7, "step"), (4, 6, "adam")]
    got = charge_gaps(spans, [(3, 4), (4, 5), (6, 7), (8, 9), (200, 210)])
    assert got == pytest.approx({"step": 2e-9, "adam": 1e-9,
                                 "round": 1e-9, "outside any span": 1e-8})


def test_lora_matmul_counts_by_hand():
    call = {"rows": 256, "K": 2048, "N": 1024, "r": 20, "elem": 2,
            "experts": 64}
    f, b = lora_matmul.cost(call)
    assert f == 2 * 256 * (2048 * 1024 + 2048 * 20 + 20 * 1024)
    assert b == 2 * (64 * (2048 * 1024 + 2048 * 20 + 20 * 1024)
                     + 256 * (2048 + 1024))
    f2, b2 = lora_matmul.cost(dict(call, experts=1, rows=8))
    assert f2 == 16 * (2048 * 1024 + 2048 * 20 + 20 * 1024)


def test_ragged_and_flash_counts_by_hand():
    f, b = ragged_expert_matmul.cost({"rows": 10, "experts": 3, "K": 4,
                                      "N": 6, "r": 2, "elem": 2})
    assert f == 2 * 10 * (24 + 8 + 12)
    assert b == 2 * (3 * (24 + 8 + 12) + 10 * 10)
    f, b = flash_attention.cost({"B": 1, "S": 4, "H": 2, "KV": 1, "D": 8,
                                 "elem": 2})
    # 10 causal (query, key) pairs, 4 D operations each, per head
    assert f == 2 * 10 * 4 * 8
    assert b == 2 * 4 * 8 * (2 * 2 + 2 * 1)


def test_least_time_takes_the_longer_bound():
    assert peaks.least_time(989e12, 0, torch.bfloat16) == pytest.approx(1.0)
    assert peaks.least_time(0, 3.35e12, torch.bfloat16) == \
        pytest.approx(1.0)
    assert peaks.least_time(67e12, 1.0, torch.float32) == pytest.approx(1.0)


def test_train_step_counts_the_frozen_base_once_in_backward():
    m = dict(OLMOE, num_layers=1, vocab_size=10, n_heads=1, n_kv_heads=1,
             head_dim=4, d_model=4, num_experts=2, top_k=1, d_expert=2,
             lora_rank=1)
    B, S, k = 1, 3, 1
    base = 2 * (4 * 4 * 4) + k * 2 * (4 * 2 * 3)        # q,k,v,o + w1,w3,w2
    lora = 2 * 1 * (8 * 4) + k * 2 * 1 * (6 * 3)
    router = 2 * 4 * 2
    head = 2 * 4 * 10
    attn = 4 * 1 * 4 * (S + 1) / 2                     # per token
    fwd = S * (base + lora + router + head + attn)
    bwd = S * (base + 2 * lora + router + head + 2 * attn)
    assert flops.train_step(m, B, S, k) == pytest.approx(fwd + bwd)
    # not the 3x-every-product count: the base's weights get no gradient
    assert flops.train_step(m, B, S, k) < 3 * fwd


def test_serve_request_counts_prefill_then_decode():
    m = dict(OLMOE)
    one = flops.serve_request(m, 2048, 1, 8)
    two = flops.serve_request(m, 2048, 2, 8)
    per_tok = 16 * sum(flops.layer_parts(m, 8).values())
    assert two - one == pytest.approx(
        per_tok + 2 * 2048 * 50304 + flops.attn_core(m, 2049))


def test_stratified_trace_offers_the_same_work_for_every_seed():
    mix = {"rate_rps": 20.0, "prompt_len_min": 2048, "prompt_len_max": 3968,
           "output_min": 16, "output_max": 128, "zipf_alpha": 1.8,
           "data_vocab": 512}
    a = traffic.serve_trace(mix, 1, 10.0, [8, 4, 2, 1])
    b = traffic.serve_trace(mix, 2**40 + 5, 10.0, [8, 4, 2, 1])
    assert len(a) == len(b) == 200
    for key in ("arrival", "max_new", "k"):
        assert [r[key] for r in a] == [r[key] for r in b]
    assert [len(r["prompt"]) for r in a] == [len(r["prompt"]) for r in b]
    assert any((r["prompt"] != q["prompt"]).any() for r, q in zip(a, b))
    arr = np.array([r["arrival"] for r in a])
    assert arr[0] == 0.0 and np.all(np.diff(arr) > 0) and arr[-1] < 10.0
    lens = [len(r["prompt"]) for r in a]
    assert min(lens) >= 2048 and max(lens) <= 3968
    outs = [r["max_new"] for r in a]
    assert min(outs) >= 16 and max(outs) <= 128
    assert {r["k"] for r in a} == {8, 4, 2, 1}
    assert all(0 <= r["prompt"].min() and r["prompt"].max() < 512
               for r in a)


def test_fl_corpus_gives_every_client_the_same_size():
    mix = {"clients": 3, "examples_per_client": 5, "seq_len": 12,
           "prompt_len": 3, "data_vocab": 40, "n_clusters": 2, "peak": 5.0,
           "dirichlet_alpha": 5.0}
    shards = traffic.fl_corpus(mix, 99)
    assert [s["tokens"].shape for s in shards] == [(5, 12)] * 3
    s = shards[0]
    assert np.array_equal(s["labels"][:, :-1], s["tokens"][:, 1:])
    assert s["mask"][:, :4].sum() == 0 and s["mask"][:, 4:11].all()
    assert s["tokens"].max() < 40
    again = traffic.fl_corpus(mix, 99)
    assert all(np.array_equal(x["tokens"], y["tokens"])
               for x, y in zip(shards, again))


@pytest.mark.parametrize("tier,k", [("b1", 4), ("b2", 2), ("b3", 1),
                                    ("b4", 1)])
def test_budget_grid_scaled_to_top_k(tier, k):
    grid = {"b1": 8, "b2": 4, "b3": 2, "b4": 1}
    assert traffic.budget_k(4, grid, tier) == k
