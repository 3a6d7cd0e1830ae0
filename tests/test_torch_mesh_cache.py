"""The port's sharded steps under the reference's decode-cache layout (the
sequence on ``model``) and with query heads that do not divide the model
axis, on a gloo world of 4 CPU ranks, against the JAX package's
``repro.launch.steps`` on a 1x1 local mesh, at float32.

One world is spawned for the module (``launch.mesh.spawn`` with a
``file://`` rendezvous under the test's temporary directory); it runs the
meshes (1, 4) and (2, 2) on five cases:

  * ``granite-smoke`` (MQA: one KV head, split mid-head by the rules);
  * ``phi4-mini-smoke`` (2 KV heads: by sequence on 4 ways, the prefill's
    own heads redistributed by an all-to-all on 2);
  * ``phi4-mini-smoke`` with 6 query heads (1.5 heads a rank on 4 ways,
    as production's 24 on 16; on 2 ways a whole cache of own heads,
    gathered);
  * ``phi4-mini-smoke`` with 10 query heads over 5 KV heads (2.5 heads a
    rank on 4 ways: a rank's heads start or end mid-group, so the flash
    kernel gets one KV head per query head);
  * ``phi4-mini-smoke`` with an 8-token sliding window: a 12-token
    prompt leaves the rolled ring, which 3 decode steps wrap.

Each case runs a train step (``n_micro`` 2, the adapters' ``b`` drawn
nonzero), a prefill whose cache ``sharding.grow_cache`` deepens, and 3
decode steps on teacher-forced tokens; every rank builds the same seeded
whole trees and takes its shard.  The prompt lengths and depths put the
prefill's cache whole on some meshes and split on others, and the 3 steps
leave one or two ranks' slices of the linear caches empty.  Rank 0
gathers the shards and writes them for the parent, which computes the
references while the world runs.

Tolerances, as ``test_torch_mesh_steps.py``'s (float32; only the
summation order across ranks differs): the loss within 1e-5 relative,
Adam's moments within 1e-5 relative to each element and to the leaf's
largest, the updated adapters within 3e-5 absolute, logits and caches
within 1e-4.
"""
import os
import threading

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
from repro_torch.tree import leaves, tree_map

MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# case: (arch, config fields replaced, prompt length, decode depth)
CASES = {"granite": ("granite-20b", {}, 9, 30),
         "phi4": ("phi4-mini-3.8b", {}, 8, 32),
         "phi4-6heads": ("phi4-mini-3.8b", {"n_heads": 6}, 9, 32),
         "phi4-10heads": ("phi4-mini-3.8b", {"n_heads": 10, "n_kv_heads": 5},
                          8, 32),
         "phi4-ring": ("phi4-mini-3.8b", {"attention_window": 8}, 12, 24)}
B, S = 8, 16                # train: two microbatches of 4 rows
BP, STEPS = 4, 3            # prefill rows; decode steps


def _cfg(case):
    arch, repl, _, _ = CASES[case]
    return tconfigs.get_config(arch, "smoke").replace(dtype="float32", **repl)


def _state(cfg):
    """Seeded whole weights and a trainable tree (numpy-drawn ``b``), the
    same in every process."""
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = tlora.init_lora(torch.Generator().manual_seed(1), cfg, params)
    rng = np.random.default_rng(2)

    def fill(t):
        if not isinstance(t, dict):
            return t
        return {k: (torch.tensor(rng.normal(0.0, 0.05, tuple(v.shape)),
                                 dtype=torch.float32) if k == "b"
                    else fill(v)) for k, v in sorted(t.items())}
    return params, tlora.make_trainable(fill(lora), None)


def _batches(cfg, prompt_len):
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size,
                          (BP, prompt_len)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (STEPS, BP, 1)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1), mask, prompt, feed


def _run_mesh(case, mesh):
    """Every output of the three steps, gathered whole."""
    cfg = _cfg(case)
    _, _, P, SD = CASES[case]
    params, trainable = _state(cfg)
    tok, lab, mask, prompt, feed = (torch.tensor(a)
                                    for a in _batches(cfg, P))
    tb = tsteps.build_train(cfg, tconfigs.ShapeConfig("t", S, B, "train"),
                            n_micro=2, device="cpu", mesh=mesh,
                            memory_bytes=2 ** 34)
    sp = tb.specs
    p = tshd.shard_tree(params, sp["params"], mesh)
    tr = tshd.shard_tree(trainable, sp["trainable"], mesh)
    tr, opt, m = tb.fn(p, tr, tadam.init(tr),
                       *(tsteps.shard_batch(t, mesh, 2)
                         for t in (tok, lab, mask)))
    out = {"loss": float(m["loss"]),
           "trainable": tshd.gather_tree(tr, sp["trainable"], mesh),
           "mu": tshd.gather_tree(opt.mu, sp["trainable"], mesh),
           "nu": tshd.gather_tree(opt.nu, sp["trainable"], mesh)}

    tr0 = tshd.shard_tree(trainable, sp["trainable"], mesh)
    pb = tsteps.build_prefill(cfg, tconfigs.ShapeConfig("p", P, BP,
                                                        "prefill"),
                              mesh=mesh)
    sb = tsteps.build_serve(cfg, tconfigs.ShapeConfig("d", SD, BP, "decode"),
                            mesh=mesh)
    rows = tshd.batch_spec(BP, mesh, 2)
    logits, cache = pb.fn(p, tr0, tsteps.shard_batch(prompt, mesh))
    out["prefill_logits"] = tshd.gather_leaf(logits, rows, mesh)
    # a copy: a leaf the rules keep whole gathers to itself
    out["prefill_cache"] = tree_map(torch.clone, tshd.gather_tree(
        cache, pb.specs["cache"], mesh))
    cache = tshd.grow_cache(cache, pb.specs["cache"], sb.specs["cache"],
                            tmodel.cache_len_for(cfg, SD), mesh)
    out["serve_logits"] = []
    for i in range(STEPS):
        dl, cache = sb.fn(p, tr0, cache, tsteps.shard_batch(feed[i], mesh),
                          torch.tensor(P + i, dtype=torch.int32))
        out["serve_logits"].append(tshd.gather_leaf(dl, rows, mesh))
    out["serve_cache"] = tshd.gather_tree(cache, sb.specs["cache"], mesh)
    return out


def _worker(rank, world, out_dir):
    torch.set_num_threads(1)
    for name, shape in MESHES.items():
        mesh = tmesh.Mesh(shape, ("data", "model"))
        for case in CASES:
            res = _run_mesh(case, mesh)
            if rank == 0:
                torch.save(res, os.path.join(out_dir, f"{case}-{name}.pt"))


def _spawn_world(out, errors):
    try:
        tmesh.spawn(_worker, 4, str(out), backend="gloo",
                    init_method=f"file://{out / 'rdv'}", timeout=600)
    except BaseException as e:          # re-raised by the fixture
        errors.append(e)


def _to_np(tree):
    """A copy in numpy (the serve step donates its cache)."""
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


def _reference():
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
    for case, (arch, repl, P, SD) in CASES.items():
        jcfg = jreg.get_config(arch, "smoke").replace(dtype="float32",
                                                      **repl)
        cfg = _cfg(case)
        depth = tmodel.cache_len_for(cfg, SD)
        params, trainable = _state(cfg)
        jp = jax.tree.map(jnp.asarray, to_numpy(params))
        ntr = to_numpy(trainable)

        def jtr():           # the train step donates its trainable tree
            return jax.tree.map(jnp.asarray, ntr)

        def grow(t):
            return jnp.pad(t, ((0, 0), (0, 0), (0, depth - t.shape[2]),
                               (0, 0), (0, 0)))
        tok, lab, mask, prompt, feed = _batches(cfg, P)
        with mesh:
            tb = jsteps.build_train(jcfg, JShape("t", S, B, "train"), mesh,
                                    n_micro=2, tc=JTrain())
            tr, opt, m = tb.fn(jp, jtr(), jadam.init(jtr()), tok, lab, mask)
            pb = jsteps.build_prefill(jcfg, JShape("p", P, BP, "prefill"),
                                      mesh)
            logits, cache = pb.fn(jp, jtr(), prompt)
            pre_cache = _to_np(cache)
            sb = jsteps.build_serve(jcfg, JShape("d", SD, BP, "decode"),
                                    mesh)
            cache = jax.tree.map(grow, cache)
            serve = []
            for i in range(STEPS):
                dl, cache = sb.fn(jp, jtr(), cache, feed[i],
                                  jnp.int32(P + i))
                serve.append(np.asarray(dl))
        out[case] = {"loss": float(m["loss"]), "trainable": _to_np(tr),
                     "mu": _to_np(opt.mu), "nu": _to_np(opt.nu),
                     "prefill_logits": np.asarray(logits),
                     "prefill_cache": pre_cache, "serve_logits": serve,
                     "serve_cache": _to_np(cache)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo world (in processes of its own) while this process
    computes the references."""
    out = tmp_path_factory.mktemp("mesh_cache")
    errors = []
    world = threading.Thread(target=_spawn_world, args=(out, errors))
    world.start()
    try:
        ref = _reference()
    finally:
        world.join()
    if errors:
        raise errors[0]
    return out, ref


def _pairs(got, want):
    g = list(leaves(got))
    w = [np.asarray(x) for x in leaves(want)]
    assert len(g) == len(w)
    return [(a.detach().numpy(), b) for a, b in zip(g, w)]


PAIRS = [(case, mesh) for mesh in MESHES for case in CASES]


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_mesh_train_step_matches_the_reference(runs, case, mesh):
    got = torch.load(runs[0] / f"{case}-{mesh}.pt")
    want = runs[1][case]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for what in ("mu", "nu"):
        for a, b in _pairs(got[what], want[what]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
    for a, b in _pairs(got["trainable"], want["trainable"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-5)


@pytest.mark.parametrize("case,mesh", PAIRS)
def test_mesh_prefill_and_decode_match_the_reference(runs, case, mesh):
    got = torch.load(runs[0] / f"{case}-{mesh}.pt")
    want = runs[1][case]
    np.testing.assert_allclose(got["prefill_logits"].numpy(),
                               want["prefill_logits"], rtol=1e-4, atol=1e-4)
    assert len(got["serve_logits"]) == len(want["serve_logits"]) == STEPS
    for a, b in zip(got["serve_logits"], want["serve_logits"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4)
    for key in ("prefill_cache", "serve_cache"):
        for a, b in _pairs(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_the_cases_reach_the_layouts_they_name(case):
    """What each case exercises, from the rules alone: the cache's depth
    split or whole on each mesh, and an empty slice on the meshes that
    split a linear cache."""
    cfg = _cfg(case)
    _, _, P, SD = CASES[case]
    depth = tmodel.cache_len_for(cfg, SD)
    split = {name: depth % m == 0 for name, (_, m) in MESHES.items()}
    if cfg.attention_window:
        assert P > cfg.attention_window == depth and all(split.values())
        return
    for name, (_, m) in MESHES.items():
        if split[name]:
            # the last decode step's position lies below the last slice
            assert P + STEPS - 1 < depth - depth // m, name
    assert {"granite": {"1x4": False, "2x2": True}}.get(
        case, {"1x4": True, "2x2": True}) == split
