"""The port's sharded train, prefill and serve steps for the SSM, hybrid
and codebook archs (``mamba2-smoke``, ``jamba-smoke``, ``musicgen-smoke``)
on gloo worlds of 2 and 4 CPU ranks, against the JAX package's
``repro.launch.steps`` on a 1x1 local mesh, at float32.

Two worlds are spawned once for the module (``launch.mesh.spawn`` with a
``file://`` rendezvous under the test's temporary directory): 2 ranks run
the mesh (1, 2), 4 ranks (2, 2).  Every rank builds the same seeded whole
trees, takes its shard and its rows, and runs two train steps
(``n_micro`` 2, the adapters' ``b`` drawn nonzero, jamba's rescalers at
0.7), a prefill and one decode step (every arch: the reference's steps
run an audio model's prefill and decode too); rank 0 gathers the shards
and writes them for the parent.  On (2, 2) also: jamba's train step in
``act_mode`` dmodel and sp (bit-equal to batch), ``init_sharded_params``
for mamba2 and musicgen (the Mamba leaves from ``mamba2.mamba_leaf``'s
distributions, replicated leaves alike on every rank), the collectives
of jamba's steps counted for the dry run.  A block whose 17 heads do not
divide the model axis runs whole on (1, 4), where the rules keep its
projections whole (against the port's single-device steps: the registry
has no such config), and is refused on (1, 2), where they split
``out_proj``.  The dry run traces jamba's steps on a fake (2, 2) world in
a subprocess (``fake`` never starts in a test worker) and counts the
calls and bytes by kind the gloo world counts.

Tolerances, as ``test_torch_mesh_steps.py``'s (float32; only the
summation order across ranks differs): the loss within 1e-5 relative,
the activation counts exactly, Adam's moments within 1e-5 relative to
each element and to the leaf's largest, the updated adapters within 3e-5
absolute, logits and caches within 1e-4.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.base import SSMConfig
from repro_torch.core import lora as tlora
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models import parallel
from repro_torch.optim import adam as tadam
from repro_torch.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-780m", "jamba-v0.1-52b", "musicgen-large")
ODD = "mamba2-odd"          # 17 heads of 30: whole on (1, 4), refused on 2
WORLDS = {2: (1, 2), 4: (2, 2)}
MODES = ("batch", "dmodel", "sp")
B, S = 8, 16                # train: two microbatches of 4 rows
BP, SD = 4, 24              # prefill rows; the decode cache's depth


def _odd(cfg):
    return cfg.replace(name=ODD, d_model=255,
                       ssm=SSMConfig(d_state=32, head_dim=30, expand=2,
                                     conv_width=4, chunk_size=64,
                                     n_groups=1))


def _cfg(arch):
    if arch == ODD:
        return _odd(_cfg("mamba2-780m"))
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
    shp = tsteps.token_shape(cfg, B, S)
    tok = rng.integers(0, cfg.vocab_size, shp).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size,
                          tsteps.token_shape(cfg, BP, S)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1), mask, prompt


def _train(cfg, mesh, params, trainable, batch, act_mode="batch", steps=2):
    tb = tsteps.build_train(cfg, tconfigs.ShapeConfig("t", S, B, "train"),
                            n_micro=2, num_groups=_num_groups(cfg),
                            device="cpu", mesh=mesh, memory_bytes=2 ** 34,
                            act_mode=act_mode)
    sp = tb.specs
    p = tshd.shard_tree(params, sp["params"], mesh)
    tr = tshd.shard_tree(trainable, sp["trainable"], mesh)
    opt = tadam.init(tr)
    batch = [tsteps.shard_batch(t, mesh, 2) for t in batch]
    losses = []
    for _ in range(steps):
        tr, opt, m = tb.fn(p, tr, opt, *batch)
        losses.append(float(m["loss"]))
    return {"loss": losses, "counts": m["counts"], "tokens": m["tokens"],
            "trainable": tshd.gather_tree(tr, sp["trainable"], mesh),
            "mu": tshd.gather_tree(opt.mu, sp["trainable"], mesh),
            "nu": tshd.gather_tree(opt.nu, sp["trainable"], mesh)}


def _rows(t, mesh):
    return tshd.gather_leaf(t, tshd.batch_spec(t.shape[0], mesh,
                                               t.dim() - 1), mesh)


def _run_mesh(cfg, mesh):
    """Every output of the three steps, gathered whole."""
    params, trainable = _state(cfg)
    tok, lab, mask, prompt = (torch.tensor(a) for a in _batches(cfg))
    out = _train(cfg, mesh, params, trainable, (tok, lab, mask))
    _, tr0 = _state(cfg)
    pb = tsteps.build_prefill(cfg, tconfigs.ShapeConfig("p", S, BP,
                                                        "prefill"),
                              mesh=mesh)
    p = tshd.shard_tree(params, pb.specs["params"], mesh)
    tr0 = tshd.shard_tree(tr0, pb.specs["trainable"], mesh)
    logits, cache = pb.fn(p, tr0, tsteps.shard_batch(prompt, mesh))
    out["prefill_logits"] = _rows(logits, mesh)
    # a copy: a leaf the rules keep whole gathers to itself, and the
    # decode step writes the cache in place
    out["prefill_cache"] = tree_map(torch.clone, tshd.gather_tree(
        cache, pb.specs["cache"], mesh))
    sb = tsteps.build_serve(cfg, tconfigs.ShapeConfig("d", SD, BP, "decode"),
                            mesh=mesh)
    cache = tshd.grow_cache(cache, pb.specs["cache"], sb.specs["cache"], SD,
                            mesh)
    nxt = logits.argmax(-1).to(torch.int32)
    dl, cache = sb.fn(p, tr0, cache, nxt, torch.tensor(S, dtype=torch.int32))
    out["serve_logits"] = _rows(dl, mesh)
    out["serve_cache"] = tshd.gather_tree(cache, sb.specs["cache"], mesh)
    return out


def _counted(fn):
    parallel.comm_start()
    fn()
    return {k: v[:2] for k, v in parallel.comm_stop()["by_kind"].items()}


def _jamba_counts(mesh):
    """The collectives of jamba's train (each act_mode), prefill and
    decode steps, as the dry run's subprocess traces them."""
    cfg = _cfg("jamba-v0.1-52b")
    params, trainable = _state(cfg)
    tok = torch.randint(0, cfg.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    out = {}
    for mode in MODES:
        tb = tsteps.build_train(cfg, tconfigs.ShapeConfig("t", S, B, "train"),
                                n_micro=2, num_groups=2, device="cpu",
                                mesh=mesh, memory_bytes=2 ** 34, act_mode=mode)
        p = tshd.shard_tree(params, tb.specs["params"], mesh)
        tr = tshd.shard_tree(trainable, tb.specs["trainable"], mesh)
        batch = [tsteps.shard_batch(t, mesh, 2)
                 for t in (tok, tok.roll(-1, 1), torch.ones((B, S)))]
        out[f"train {mode}"] = _counted(
            lambda: tb.fn(p, tr, tadam.init(tr), *batch))
    pb = tsteps.build_prefill(cfg, tconfigs.ShapeConfig("p", S, BP,
                                                        "prefill"), mesh=mesh)
    prompt = tsteps.shard_batch(tok[:BP], mesh)
    out["prefill"] = _counted(lambda: pb.fn(p, tr, prompt))
    sb = tsteps.build_serve(cfg, tconfigs.ShapeConfig("d", SD, BP, "decode"),
                            mesh=mesh)
    cache = tshd.shard_tree(tmodel.init_cache(cfg, BP, SD, device="cpu"),
                            sb.specs["cache"], mesh)
    out["decode"] = _counted(lambda: sb.fn(
        p, tr, cache, prompt[:, :1], torch.tensor(S, dtype=torch.int32)))
    return out


def _inits(mesh, rank, out_dir):
    """``init_sharded_params`` of mamba2 and musicgen: rank 0 writes the
    whole trees, every rank its replicated Mamba leaves."""
    for arch in ("mamba2-780m", "musicgen-large"):
        cfg = _cfg(arch)
        params = tshd.init_sharded_params(cfg, mesh, 5, "cpu")
        specs = tshd.param_specs(cfg, tsteps.abstract_params(cfg), mesh)
        whole = tshd.gather_tree(params, specs, mesh)
        if rank == 0:
            torch.save(whole, os.path.join(out_dir, f"init-{arch}.pt"))
        if "ssm" in params["blocks"]["pos0"]:
            ssm = params["blocks"]["pos0"]["ssm"]
            torch.save({k: v for k, v in ssm.items()
                        if k not in ("in_proj", "out_proj")},
                       os.path.join(out_dir, f"repl-{arch}-{rank}.pt"))


def _worker(rank, world, out_dir):
    torch.set_num_threads(1)
    mesh = tmesh.Mesh(WORLDS[world], ("data", "model"))
    tag = "x".join(map(str, WORLDS[world]))

    def save(obj, name):
        if rank == 0:
            torch.save(obj, os.path.join(out_dir, name))
    for arch in ARCHS:
        save(_run_mesh(_cfg(arch), mesh), f"{arch}-{tag}.pt")
    odd = _cfg(ODD)
    if world == 2:
        try:
            _run_mesh(odd, mesh)
            save("ran", "odd-refused.pt")
        except NotImplementedError as e:
            save(str(e), "odd-refused.pt")
        return
    cfg = _cfg("jamba-v0.1-52b")
    params, trainable = _state(cfg)
    tok, lab, mask, _ = (torch.tensor(a) for a in _batches(cfg))
    save({mode: _train(cfg, mesh, params, trainable, (tok, lab, mask), mode,
                       steps=1) for mode in MODES}, "jamba-modes.pt")
    _inits(mesh, rank, out_dir)
    counts = _jamba_counts(mesh)
    if rank == 0:
        (Path(out_dir) / "gloo.json").write_text(json.dumps(counts))
    whole = tmesh.Mesh((1, 4), ("data", "model"))
    save(_run_mesh(odd, whole), f"{ODD}-1x4.pt")


DRY = """
import json, sys
from repro_torch.configs import ShapeConfig
from repro_torch.launch import dryrun
B, S, BP, SD = 8, 16, 4, 24
cfg = {"dtype": "float32"}
recs = {}
for mode in ("batch", "dmodel", "sp"):
    recs[f"train {mode}"] = dryrun.run_pair(
        "jamba-v0.1-52b", "t", shape=ShapeConfig("t", S, B, "train"),
        mesh_shape=(2, 2), variant="smoke", cfg_replace=cfg,
        memory_bytes=2 ** 34,
        overrides={"n_micro": 2, "act_mode": mode, "num_groups": 2})
recs["prefill"] = dryrun.run_pair(
    "jamba-v0.1-52b", "p", shape=ShapeConfig("p", S, BP, "prefill"),
    mesh_shape=(2, 2), variant="smoke", cfg_replace=cfg)
recs["decode"] = dryrun.run_pair(
    "jamba-v0.1-52b", "d", shape=ShapeConfig("d", SD, BP, "decode"),
    mesh_shape=(2, 2), variant="smoke", cfg_replace=cfg)
json.dump(recs, open(sys.argv[1], "w"), default=str)
"""


def _spawn_worlds(out, errors):
    try:
        for world in WORLDS:
            tmesh.spawn(_worker, world, str(out), backend="gloo",
                        init_method=f"file://{out / f'rdv{world}'}",
                        timeout=600)
    except BaseException as e:          # re-raised by the fixture
        errors.append(e)


def _to_np(tree):
    """A copy in numpy (a decode step writes the port's cache in place)."""
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return np.array(tree, np.float32)


def _jax_cfg(arch):
    from repro.configs import registry as jreg
    return jreg.get_config(arch, "smoke").replace(dtype="float32")


def _reference():
    """The JAX package's steps on ``make_local_mesh()``, on the same
    weights, trainable trees and batches."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrain
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_local_mesh
    from repro.optim import adam as jadam
    from repro_torch.convert import to_numpy

    def grow(path, t):
        if any(getattr(k, "key", None) == "attn" for k in path):
            return jnp.pad(t, ((0, 0), (0, 0), (0, SD - S), (0, 0), (0, 0)))
        return t

    mesh = make_local_mesh()
    out = {}
    for arch in ARCHS:
        jcfg = _jax_cfg(arch)
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
            pre_cache = _to_np(cache)     # the serve step donates its cache
            sb = jsteps.build_serve(jcfg, JShape("d", SD, BP, "decode"),
                                    mesh)
            padded = jax.tree_util.tree_map_with_path(grow, cache)
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            dl, dcache = sb.fn(jp, jtr(), padded, nxt, jnp.int32(S))
        out[arch] = {"loss": losses, "counts": _to_np(m["counts"]),
                     "tokens": float(m["tokens"]),
                     "trainable": _to_np(tr), "mu": _to_np(opt.mu),
                     "nu": _to_np(opt.nu),
                     "prefill_logits": np.asarray(logits),
                     "prefill_cache": pre_cache,
                     "serve_logits": np.asarray(dl),
                     "serve_cache": _to_np(dcache)}
    return out


def _one_device(cfg):
    """The port's single-device steps (held to the JAX package's by
    ``test_torch_steps.py`` and ``test_torch_mamba.py``) on ``cfg``: the
    reference for a config the registry lacks."""
    params, trainable = _state(cfg)
    tok, lab, mask, prompt = (torch.tensor(a) for a in _batches(cfg))
    tb = tsteps.build_train(cfg, tconfigs.ShapeConfig("t", S, B, "train"),
                            n_micro=2, device="cpu", memory_bytes=2 ** 34)
    tr, opt = trainable, tadam.init(trainable)
    losses = []
    for _ in range(2):
        tr, opt, m = tb.fn(params, tr, opt, tok, lab, mask)
        losses.append(float(m["loss"]))
    pb = tsteps.build_prefill(cfg, tconfigs.ShapeConfig("p", S, BP,
                                                        "prefill"))
    logits, cache = pb.fn(params, trainable, prompt)
    pre_cache = _to_np(cache)
    sb = tsteps.build_serve(cfg, tconfigs.ShapeConfig("d", SD, BP, "decode"))
    dl, dcache = sb.fn(params, trainable, tmodel.grow_cache(cache, SD),
                       logits.argmax(-1).to(torch.int32),
                       torch.tensor(S, dtype=torch.int32))
    return {"loss": losses, "counts": _to_np(m["counts"]),
            "tokens": float(m["tokens"]), "trainable": _to_np(tr),
            "mu": _to_np(opt.mu), "nu": _to_np(opt.nu),
            "prefill_logits": logits.numpy(), "prefill_cache": pre_cache,
            "serve_logits": dl.numpy(), "serve_cache": _to_np(dcache)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo worlds and the dry run (in processes of their own) while
    this process computes the references."""
    import threading
    out = tmp_path_factory.mktemp("mesh_ssm")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dry = subprocess.Popen([sys.executable, "-c", DRY, str(out / "dry.json")],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    errors = []
    worlds = threading.Thread(target=_spawn_worlds, args=(out, errors))
    worlds.start()
    try:
        ref = _reference()
        ref[ODD] = _one_device(_cfg(ODD))
    finally:
        worlds.join()
        log = dry.communicate(timeout=600)[0]
    if errors:
        raise errors[0]
    assert dry.returncode == 0, log[-3000:]
    return out, ref


def _pairs(got, want):
    g = list(leaves(got))
    w = [np.asarray(x) for x in leaves(want)]
    assert len(g) == len(w)
    return [(a.detach().numpy(), b) for a, b in zip(g, w)]


CASES = ([(arch, "x".join(map(str, shape))) for shape in WORLDS.values()
          for arch in ARCHS] + [(ODD, "1x4")])


@pytest.mark.parametrize("arch,mesh", CASES)
def test_mesh_train_step_matches_the_reference(runs, arch, mesh):
    got = torch.load(runs[0] / f"{arch}-{mesh}.pt")
    want = runs[1][arch]
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
def test_mesh_prefill_and_serve_match_the_reference(runs, arch, mesh):
    got = torch.load(runs[0] / f"{arch}-{mesh}.pt")
    want = runs[1][arch]
    for key in ("prefill_logits", "serve_logits"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=1e-4)
    for key in ("prefill_cache", "serve_cache"):
        for a, b in _pairs(got[key], want[key]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", MODES[1:])
def test_jamba_act_modes_are_bit_equal_to_batch(runs, mode):
    got = torch.load(runs[0] / "jamba-modes.pt")
    for what in ("counts", "trainable", "mu", "nu"):
        for a, b in zip(leaves(got[mode][what]), leaves(got["batch"][what])):
            assert torch.equal(a, b), what
    assert got[mode]["loss"] == got["batch"]["loss"]


def test_an_indivisible_block_runs_whole_or_is_refused(runs):
    msg = torch.load(runs[0] / "odd-refused.pt")
    assert ODD in msg and "17 SSM heads" in msg and "'model': 2" in msg
    # on (1, 4) neither projection divides: the block ran whole, and its
    # results are checked against one device by the cases above
    assert (runs[0] / f"{ODD}-1x4.pt").exists()


def test_sharded_init_draws_the_one_card_distributions(runs):
    out = runs[0]
    cfg = _cfg("mamba2-780m")
    whole = torch.load(out / "init-mamba2-780m.pt")
    ssm = whole["blocks"]["pos0"]["ssm"]
    one = tmodel.init_params(cfg, torch.Generator().manual_seed(5),
                             "cpu")["blocks"]["pos0"]["ssm"]
    assert {k: (v.shape, v.dtype) for k, v in ssm.items()} == \
        {k: (v.shape, v.dtype) for k, v in one.items()}
    for name, fan_in in (("in_proj", cfg.d_model),
                         ("out_proj", ssm["out_proj"].shape[-2])):
        w = ssm[name]
        sigma = fan_in ** -0.5
        assert float(w.abs().max()) <= 3 * sigma * (1 + 1e-6)
        # a ±3σ truncated normal's std is 0.9866 σ
        assert abs(float(w.std()) / sigma - 0.9866) < 0.02
    W = cfg.ssm.conv_width
    assert abs(float(ssm["conv_w"].std()) * W ** 0.5 - 1.0) < 0.05
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert float(ssm["A_log"].min()) >= 0.0
    assert float(ssm["A_log"].max()) <= math.log(16.0) + 1e-6
    assert torch.equal(ssm["D"], torch.ones_like(ssm["D"]))
    assert torch.equal(ssm["norm"], torch.ones_like(ssm["norm"]))
    assert torch.equal(ssm["conv_b"], torch.zeros_like(ssm["conv_b"]))
    # replicated leaves come out alike on every rank
    ranks = [torch.load(out / f"repl-mamba2-780m-{r}.pt")
             for r in range(4)]
    for r in ranks[1:]:
        for key, v in ranks[0].items():
            assert torch.equal(r[key], v), key
    emb = torch.load(out / "init-musicgen-large.pt")["embed"][
        "tokens"]
    mg = _cfg("musicgen-large")
    assert emb.shape == (mg.num_codebooks, mg.vocab_size, mg.d_model)
    assert abs(float(emb.std()) / 0.02 - 1.0) < 0.05


@pytest.mark.parametrize("pair", [f"train {m}" for m in MODES]
                         + ["prefill", "decode"])
def test_jamba_dry_run_counts_equal_a_gloo_world(runs, pair):
    rec = json.loads((runs[0] / "dry.json").read_text())[pair]
    want = json.loads((runs[0] / "gloo.json").read_text())[pair]
    assert rec["ok"]
    got = {k: [rec["collectives"]["execs_by_kind"][k],
               rec["collectives"]["bytes_by_kind"][k]]
           for k in rec["collectives"]["execs_by_kind"]}
    assert got == want
