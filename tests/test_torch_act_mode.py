"""The sharded train step's activation modes ("dmodel", "sp") on gloo
worlds of 2 and 4 CPU ranks, at float32: bit-equal to the "batch" step of
the same world, and against the JAX package's
``repro.launch.steps.build_train(act_mode=...)`` on a 1x1 local mesh.

Two worlds are spawned once for the module (``launch.mesh.spawn``, a
``file://`` rendezvous under the test's temporary directory): 2 ranks run
the mesh (1, 2), 4 ranks (2, 2), each on ``qwen3-moe-smoke`` and
``llama3-smoke``.  Every rank takes its shard of the same seeded whole
trees and its rows of the batch and runs one train step (``n_micro`` 2,
the adapters' ``b`` drawn nonzero, the rescalers at 0.7, two-level
checkpointing: the smoke configs at 4 layers, ``remat_chunk`` 2) in
each mode; rank 0 gathers the updated adapters and Adam's moments and
writes them with the loss and the counts.  The workers also run
``split_to`` / ``gather_from`` on a toy graph (gradients exact) and an
uneven split (``ValueError``).

Tolerances against the reference (float32; only the summation order
across ranks differs), as ``test_torch_mesh_steps.py``'s after one step:
the loss within 1e-5 relative, the counts exactly, Adam's moments within
1e-5 relative to each element and to the leaf's largest, the adapters
within 3e-5 absolute.  Against the batch step: bit for bit.

The knob chooser's fallback (``steps._mesh_knobs``) is checked on a stub
mesh at memory sizes either side of each mode's need.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import lora as tlora
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models import parallel
from repro_torch.optim import adam as tadam
from repro_torch.tree import leaves

ARCHS = ("qwen3-moe-235b-a22b", "llama3-405b")
WORLDS = {2: ((1, 2),), 4: ((2, 2),)}
MODES = ("dmodel", "sp")
B, S = 8, 16                # two microbatches of 4 rows


def _cfg(arch):
    return tconfigs.get_config(arch, "smoke").replace(dtype="float32",
                                                      num_layers=4)


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


def _batch(cfg):
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return tok, np.roll(tok, -1, axis=1), mask


def _step(cfg, mesh, mode):
    params, trainable = _state(cfg)
    batch = [torch.tensor(a) for a in _batch(cfg)]
    tb = tsteps.build_train(cfg, tconfigs.ShapeConfig("t", S, B, "train"),
                            n_micro=2, num_groups=_num_groups(cfg),
                            remat_chunk=2, device="cpu", mesh=mesh,
                            memory_bytes=2 ** 34, act_mode=mode)
    sp = tb.specs
    p = tshd.shard_tree(params, sp["params"], mesh)
    tr = tshd.shard_tree(trainable, sp["trainable"], mesh)
    parallel.comm_start()
    tr, opt, m = tb.fn(p, tr, tadam.init(tr),
                       *(tsteps.shard_batch(t, mesh, 2) for t in batch))
    comm = parallel.comm_stop()
    return {"loss": m["loss"], "counts": m["counts"],
            "act_mode": tb.meta["act_mode"],
            "comm": {k: v[:2] for k, v in comm["by_kind"].items()},
            "trainable": tshd.gather_tree(tr, sp["trainable"], mesh),
            "mu": tshd.gather_tree(opt.mu, sp["trainable"], mesh),
            "nu": tshd.gather_tree(opt.nu, sp["trainable"], mesh)}


def _toy(mesh):
    """split_to / gather_from on a toy graph: (split, scale, gather) and
    (gather, square) with their exact gradients; an uneven split's
    error."""
    group = mesh.group("model")
    M, mi = mesh.size("model"), mesh.index("model")
    gen = torch.Generator().manual_seed(5)
    out = {}
    for name, dim in (("dmodel", -1), ("sp", 1)):
        x = torch.randn((2, 4 * M, 6 * M), generator=gen, requires_grad=True)
        w = torch.randn((2, 4 * M, 6 * M), generator=gen)
        v = parallel.gather_from(parallel.split_to(x, group, dim) * 3.0,
                                 group, dim)
        (v * w).sum().backward()
        whole_ok = torch.equal(v, x.detach() * 3.0)
        split_grad_ok = torch.equal(x.grad, w * 3.0)
        piece = parallel.split_to(x.detach(), group, dim).requires_grad_()
        full = parallel.gather_from(piece, group, dim)
        (full ** 2).sum().backward()
        gather_grad_ok = torch.equal(piece.grad, 2.0 * piece.detach())
        own = x.detach().chunk(M, dim=dim)[mi]
        slice_ok = torch.equal(piece.detach(), own)
        try:
            parallel.split_to(torch.zeros((2, 4 * M + 1, 6 * M + 1)), group,
                              dim)
            err = None
        except ValueError as e:
            err = str(e)
        out[name] = {"whole": whole_ok, "split_grad": split_grad_ok,
                     "gather_grad": gather_grad_ok, "slice": slice_ok,
                     "uneven": err}
    return out


def _worker(rank, world, out_dir):
    torch.set_num_threads(1)
    for shape in WORLDS[world]:
        mesh = tmesh.Mesh(shape, ("data", "model"))
        tag = "x".join(map(str, shape))
        res = {"toy": _toy(mesh)}
        for arch in ARCHS:
            cfg = _cfg(arch)
            res[arch] = {mode: _step(cfg, mesh, mode)
                         for mode in ("batch",) + MODES}
        if rank == 0:
            torch.save(res, os.path.join(out_dir, f"{tag}.pt"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("act")
    for world in WORLDS:
        tmesh.spawn(_worker, world, str(out), backend="gloo",
                    init_method=f"file://{out / f'rdv{world}'}", timeout=600)
    return {p.stem: torch.load(p) for p in out.glob("*.pt")}


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's train step on ``make_local_mesh()`` in each mode,
    one step on the same weights, trainable tree and batch."""
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
        jcfg = jreg.get_config(arch, "smoke").replace(dtype="float32",
                                                      num_layers=4)
        params, trainable = _state(_cfg(arch))
        jp = jax.tree.map(jnp.asarray, to_numpy(params))
        ntr = to_numpy(trainable)
        tok, lab, mask = _batch(_cfg(arch))
        out[arch] = {}
        for mode in MODES:
            tr = jax.tree.map(jnp.asarray, ntr)
            with mesh:
                tb = jsteps.build_train(
                    jcfg, JShape("t", S, B, "train"), mesh, n_micro=2,
                    num_groups=_num_groups(_cfg(arch)), remat_chunk=2,
                    act_mode=mode, tc=JTrain())
                tr, opt, m = tb.fn(jp, tr, jadam.init(tr), tok, lab, mask)
            assert tb.meta["act_mode"] == mode
            out[arch][mode] = {"loss": float(m["loss"]),
                               "counts": _to_np(m["counts"]),
                               "trainable": _to_np(tr), "mu": _to_np(opt.mu),
                               "nu": _to_np(opt.nu)}
    return out


def _pairs(got, want):
    g = list(leaves(got))
    w = [np.asarray(x) for x in leaves(want)]
    assert len(g) == len(w)
    return [(a.detach().numpy(), b) for a, b in zip(g, w)]


CASES = [(arch, "x".join(map(str, shape)), mode) for world in WORLDS
         for shape in WORLDS[world] for arch in ARCHS for mode in MODES]


@pytest.mark.parametrize("arch,mesh,mode", CASES)
def test_act_mode_step_is_bit_equal_to_batch(results, arch, mesh, mode):
    got, want = results[mesh][arch][mode], results[mesh][arch]["batch"]
    assert got["act_mode"] == mode and want["act_mode"] == "batch"
    assert torch.equal(got["loss"], want["loss"])
    for key in want["counts"]:
        assert torch.equal(got["counts"][key], want["counts"][key])
    for what in ("trainable", "mu", "nu"):
        for a, b in zip(leaves(got[what]), leaves(want[what])):
            assert torch.equal(a, b), what
    # the carries' split and gather add all-gathers and nothing else
    assert got["comm"]["all_reduce"] == want["comm"]["all_reduce"]
    assert got["comm"]["reduce_scatter"] == want["comm"]["reduce_scatter"]
    assert got["comm"]["all_gather"][0] > want["comm"]["all_gather"][0]


@pytest.mark.parametrize("arch,mesh,mode", CASES)
def test_act_mode_step_matches_the_reference(results, reference, arch,
                                             mesh, mode):
    got, want = results[mesh][arch][mode], reference[arch][mode]
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5)
    assert set(got["counts"]) == set(want["counts"])
    for key, c in want["counts"].items():
        np.testing.assert_array_equal(got["counts"][key].numpy(), c)
    for what in ("mu", "nu"):
        for a, b in _pairs(got[what], want[what]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
    for a, b in _pairs(got["trainable"], want["trainable"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-5)


TOY = [(mesh, mode) for world in WORLDS
       for mesh in ("x".join(map(str, s)) for s in WORLDS[world])
       for mode in MODES]


@pytest.mark.parametrize("mesh,mode", TOY)
def test_split_to_and_gather_from_have_exact_gradients(results, mesh, mode):
    toy = results[mesh]["toy"][mode]
    assert toy["whole"] and toy["slice"]
    assert toy["split_grad"] and toy["gather_grad"]


@pytest.mark.parametrize("mesh,mode", TOY)
def test_uneven_split_raises_and_names_the_dim(results, mesh, mode):
    err = results[mesh]["toy"][mode]["uneven"]
    assert err is not None
    assert ("dim -1" if mode == "dmodel" else "dim 1") in err
    assert "does not split" in err


# --------------------------------------------------------------------------
# the knob chooser's fallback
# --------------------------------------------------------------------------

STUB = SimpleNamespace(shape={"data": 2, "model": 2},
                       axis_names=("data", "model"))


def _needs(arch):
    """(a rank's fixed bytes, one sequence's activations in batch and in
    dmodel mode) for a global batch of one sequence a data rank."""
    cfg = tconfigs.get_config(arch, "smoke")
    shape = tconfigs.ShapeConfig("t", 64, 2, "train")
    fixed = tsteps._mesh_knobs(cfg, shape, STUB, 2 ** 40,
                               None)["rank_fixed_bytes"]
    chunk = tsteps._remat_chunk(cfg.num_layers // cfg.pattern_period)
    per = {mode: tsteps.activation_bytes(cfg, 64, chunk, None, model_ways=2,
                                         carry_ways=ways)
           for mode, ways in (("batch", 1), ("dmodel", 2))}
    return cfg, shape, fixed, per


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("room", ["batch", "dmodel", "neither"])
def test_mesh_knobs_fall_back_to_dmodel(arch, room):
    cfg, shape, fixed, per = _needs(arch)
    assert per["dmodel"] < per["batch"]
    memory = {"batch": fixed + per["batch"],
              "dmodel": fixed + per["batch"] - 1,
              "neither": fixed + per["dmodel"] - 1}[room]
    if room == "neither":
        with pytest.raises(tsteps.DoesNotFit) as e:
            tsteps._mesh_knobs(cfg, shape, STUB, memory, None)
        assert "next multi-chip" not in str(e.value)
        assert tsteps.deepest_fit(cfg, shape, STUB, memory) < cfg.num_layers
        return
    knobs = tsteps._mesh_knobs(cfg, shape, STUB, memory, None)
    assert knobs["act_mode"] == room
    assert knobs["act_bytes"] == per[room]
    assert knobs["n_micro"] == 1


def test_one_device_step_runs_batch_only():
    cfg = _cfg("llama3-405b")
    shape = tconfigs.ShapeConfig("t", S, B, "train")
    assert tsteps.build_train(cfg, shape, device="cpu",
                              memory_bytes=2 ** 34).meta["act_mode"] == "batch"
    with pytest.raises(ValueError, match="act_mode"):
        tsteps.build_train(cfg, shape, device="cpu", memory_bytes=2 ** 34,
                           act_mode="dmodel")
