"""The port's sharded train, prefill and serve steps on gloo worlds of 2
and 4 CPU ranks against the JAX package's ``repro.launch.steps`` on a
1x1 local mesh, at float32.

Two worlds are spawned once for the module (``launch.mesh.spawn`` with a
``file://`` rendezvous under the test's temporary directory): 2 ranks run
the meshes (1, 2) and (2, 1), 4 ranks (2, 2) and (2, 1, 2), each on
``qwen3-moe-smoke`` and ``llama3-smoke``.  Every rank builds the same
seeded whole trees, takes its shard (``sharding.shard_tree``) and its
rows (``steps.shard_batch``), runs two train steps (``n_micro`` 2, the
adapters' ``b`` drawn nonzero, the rescalers at 0.7, so every factor and
its reduction carries gradient), a prefill (4 rows: under (2, x) meshes
its one routing group spans the ranks, so the MoE gathers the batch) and
one decode step; rank 0 gathers the shards and writes them for the
parent, which holds them against the reference's steps on the same
weights.

Tolerances (float32; only the summation order across ranks differs): the
loss within 1e-5 relative, the activation counts exactly, Adam's moments
within 1e-5 relative to each element and to the leaf's largest, the
updated adapters within 3e-5 absolute (a fifth of two Adam steps at lr
1.5e-4: Adam's m/√v magnifies an order-of-summation difference where a
gradient is near zero), logits and caches within 1e-4.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import lora as tlora
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.optim import adam as tadam
from repro_torch.tree import leaves

ARCHS = ("qwen3-moe-235b-a22b", "llama3-405b")
WORLDS = {2: (((1, 2), ("data", "model")), ((2, 1), ("data", "model"))),
          4: (((2, 2), ("data", "model")),
              ((2, 1, 2), ("pod", "data", "model")))}
B, S = 8, 16                # train: two microbatches of 4 rows
BP, SD = 4, 24              # prefill rows; the decode cache's depth


def _cfg(arch):
    return tconfigs.get_config(arch, "smoke").replace(dtype="float32")


def _num_groups(cfg):
    return 2 if cfg.moe.enabled else None


def _state(cfg):
    """Seeded whole weights and a trainable tree (numpy-drawn ``b``,
    rescalers at 0.7), the same in every process."""
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = tlora.init_lora(torch.Generator().manual_seed(1), cfg, params)
    rng = np.random.default_rng(2)

    def fill(t):
        if not isinstance(t, dict):
            return t
        return {k: (torch.tensor(rng.normal(0.0, 0.05, tuple(v.shape)),
                                 dtype=torch.float32) if k == "b"
                    else fill(v)) for k, v in sorted(t.items())}
    resc = tlora.init_rescalers(cfg, cfg.moe.top_k or 0, device="cpu")
    resc = None if resc is None else {k: v * 0.7 for k, v in resc.items()}
    return params, tlora.make_trainable(fill(lora), resc)


def _batches(cfg):
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, (BP, S)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1), mask, prompt


def _rows_spec(mesh, batch):
    return tshd.batch_spec(batch, mesh, 2)


def _run_mesh(cfg, mesh):
    """Every output of the three steps, gathered whole."""
    params, trainable = _state(cfg)
    tok, lab, mask, prompt = (torch.tensor(a) for a in _batches(cfg))
    k = cfg.moe.top_k or None
    tb = tsteps.build_train(cfg, tconfigs.ShapeConfig("t", S, B, "train"),
                            n_micro=2, num_groups=_num_groups(cfg),
                            device="cpu", mesh=mesh, memory_bytes=2 ** 34)
    sp = tb.specs
    p = tshd.shard_tree(params, sp["params"], mesh)
    tr = tshd.shard_tree(trainable, sp["trainable"], mesh)
    opt = tadam.init(tr)
    losses = []
    for _ in range(2):
        tr, opt, m = tb.fn(p, tr, opt,
                           *(tsteps.shard_batch(t, mesh, 2)
                             for t in (tok, lab, mask)))
        losses.append(float(m["loss"]))
    out = {"loss": losses, "counts": m["counts"], "tokens": m["tokens"],
           "trainable": tshd.gather_tree(tr, sp["trainable"], mesh),
           "mu": tshd.gather_tree(opt.mu, sp["trainable"], mesh),
           "nu": tshd.gather_tree(opt.nu, sp["trainable"], mesh)}

    _, tr0 = _state(cfg)
    tr0 = tshd.shard_tree(tr0, sp["trainable"], mesh)
    pb = tsteps.build_prefill(cfg, tconfigs.ShapeConfig("p", S, BP,
                                                        "prefill"),
                              mesh=mesh)
    logits, cache = pb.fn(p, tr0, tsteps.shard_batch(prompt, mesh))
    rows = _rows_spec(mesh, BP)
    out["prefill_logits"] = tshd.gather_leaf(logits, rows, mesh)
    out["prefill_cache"] = tshd.gather_tree(cache, pb.specs["cache"], mesh)
    sb = tsteps.build_serve(cfg, tconfigs.ShapeConfig("d", SD, BP, "decode"),
                            mesh=mesh)
    cache = tshd.grow_cache(cache, pb.specs["cache"], sb.specs["cache"], SD,
                            mesh)
    nxt = logits.argmax(-1).to(torch.int32)
    dl, cache = sb.fn(p, tr0, cache, nxt, torch.tensor(S, dtype=torch.int32))
    out["serve_logits"] = tshd.gather_leaf(dl, rows, mesh)
    out["serve_cache"] = tshd.gather_tree(cache, sb.specs["cache"], mesh)
    assert k == pb.meta["k"] == sb.meta["k"]
    return out


def _worker(rank, world, out_dir):
    torch.set_num_threads(1)
    for shape, axes in WORLDS[world]:
        mesh = tmesh.Mesh(shape, axes)
        for arch in ARCHS:
            res = _run_mesh(_cfg(arch), mesh)
            if rank == 0:
                torch.save(res, os.path.join(
                    out_dir, f"{arch}-{'x'.join(map(str, shape))}.pt"))


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    for world in WORLDS:
        rdv = out / f"rdv{world}"
        tmesh.spawn(_worker, world, str(out), backend="gloo",
                    init_method=f"file://{rdv}", timeout=600)
    return out


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's steps on ``make_local_mesh()``, on the same
    weights, trainable trees and batches."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrain
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_local_mesh
    from repro.optim import adam as jadam
    from repro_torch.convert import to_numpy

    mesh = make_local_mesh()
    out = {}
    for arch in ARCHS:
        jcfg = jreg.get_config(arch, "smoke").replace(dtype="float32")
        cfg = _cfg(arch)
        params, trainable = _state(cfg)
        jp = jax.tree.map(jnp.asarray, to_numpy(params))
        ntr = to_numpy(trainable)

        def jtr():           # the train step donates its trainable tree
            return jax.tree.map(jnp.asarray, ntr)
        tok, lab, mask, prompt = _batches(cfg)
        with mesh:
            tb = jsteps.build_train(jcfg, JShape("t", S, B, "train"), mesh,
                                    n_micro=2, num_groups=_num_groups(cfg),
                                    tc=JTrain())
            tr, opt, losses = jtr(), jadam.init(jtr()), []
            for _ in range(2):
                tr, opt, m = tb.fn(jp, tr, opt, tok, lab, mask)
                losses.append(float(m["loss"]))
            pb = jsteps.build_prefill(jcfg, JShape("p", S, BP, "prefill"),
                                      mesh)
            logits, cache = pb.fn(jp, jtr(), prompt)
            sb = jsteps.build_serve(jcfg, JShape("d", SD, BP, "decode"),
                                    mesh)
            padded = jax.tree.map(
                lambda t: jnp.pad(t, ((0, 0), (0, 0), (0, SD - S), (0, 0),
                                      (0, 0))), cache)
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            dl, dcache = sb.fn(jp, jtr(), padded, nxt, jnp.int32(S))
        out[arch] = {"loss": losses, "counts": _to_np(m["counts"]),
                     "tokens": float(m["tokens"]),
                     "trainable": _to_np(tr), "mu": _to_np(opt.mu),
                     "nu": _to_np(opt.nu),
                     "prefill_logits": np.asarray(logits),
                     "prefill_cache": _to_np(cache),
                     "serve_logits": np.asarray(dl),
                     "serve_cache": _to_np(dcache)}
    return out


def _pairs(got, want):
    g = list(leaves(got))
    w = [np.asarray(x) for x in leaves(want)]
    assert len(g) == len(w)
    return [(a.detach().numpy(), b) for a, b in zip(g, w)]


CASES = [(arch, "x".join(map(str, shape))) for world in WORLDS
         for shape, _ in WORLDS[world] for arch in ARCHS]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_train_step_matches_the_reference(mesh_results, reference,
                                               arch, mesh):
    got = torch.load(mesh_results / f"{arch}-{mesh}.pt")
    want = reference[arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["tokens"] == want["tokens"] == B * S
    assert set(got["counts"]) == set(want["counts"])
    for key, c in want["counts"].items():
        np.testing.assert_array_equal(got["counts"][key].numpy(), c)
    for what in ("mu", "nu"):
        for a, b in _pairs(got[what], want[what]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
    for a, b in _pairs(got["trainable"], want["trainable"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-5)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_prefill_and_serve_match_the_reference(mesh_results, reference,
                                                    arch, mesh):
    got = torch.load(mesh_results / f"{arch}-{mesh}.pt")
    want = reference[arch]
    for key in ("prefill_logits", "serve_logits"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=1e-4)
    for key in ("prefill_cache", "serve_cache"):
        for a, b in _pairs(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
