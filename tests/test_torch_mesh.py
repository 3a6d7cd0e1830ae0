"""The port's card mesh and sharding rules against the JAX package's
(``repro.launch.mesh``, ``repro.launch.sharding``, ``repro.launch.steps``),
on the CPU with no process group.

Spec trees are compared leaf for leaf by path: a port spec is a tuple,
the reference's a ``PartitionSpec`` (``tuple(spec)`` equals the port's).
The reference's rule functions take a stub mesh (a namespace with
``shape`` and ``axis_names``), as do the port's.  The 4-D grouped expert
product is checked at float32 within 1e-5 against the reference's
grouped einsums; ``shard_tree`` exactly.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import registry as jreg
from repro.launch import mesh as jmesh
from repro.launch import sharding as jshd
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch.convert import config_from_jax
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.tree import tree_map_with_path

MESHES = {
    "2x2": ({"data": 2, "model": 2}, ("data", "model")),
    "1x4": ({"data": 1, "model": 4}, ("data", "model")),
    "16x16": ({"data": 16, "model": 16}, ("data", "model")),
    "2x16x16": ({"pod": 2, "data": 16, "model": 16},
                ("pod", "data", "model")),
}


def stub(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(shape=dict(shape), axis_names=axes)


def _jflat(tree):
    """{path: tuple(spec)} of a reference spec tree."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        out[jshd._path_str(path)] = tuple(spec)
    return out


def _tflat(tree):
    out = {}
    tree_map_with_path(lambda p, s: out.__setitem__("/".join(p), s), tree)
    return out


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    jcfg = jreg.get_config(arch, "full")
    tcfg = tconfigs.get_config(arch, "full")
    return (jcfg, jspecs.abstract_params(jcfg),
            jspecs.abstract_trainable(jcfg, jcfg.moe.top_k or 0),
            tcfg, tsteps.abstract_params(tcfg),
            tsteps.abstract_trainable(tcfg, tcfg.moe.top_k or 0))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jreg.list_archs())
def test_spec_trees_equal_the_reference(arch, mesh):
    jcfg, jp, jt, tcfg, tp, tt = _abstract(arch)
    m = stub(mesh)
    want = _jflat(jshd.param_specs(jcfg, jp, m))
    assert _tflat(tshd.param_specs(tcfg, tp, m)) == want
    jts = jshd.trainable_specs(jcfg, jt, m)
    tts = tshd.trainable_specs(tcfg, tt, m)
    assert _tflat(tts) == _jflat(jts)
    jo, to = jshd.opt_specs(jts), tshd.opt_specs(tts)
    assert tuple(jo.step) == to.step == ()
    assert _tflat(to.mu) == _jflat(jo.mu)
    assert _tflat(to.nu) == _jflat(jo.nu)
    for batch in (256, 32, 1):
        for extra in (1, 2):
            assert tshd.batch_spec(batch, m, extra) == tuple(
                jshd.batch_spec(batch, m, extra))
    for mode in ("batch", "dmodel", "seq"):
        assert tshd.activation_spec(m, mode) == tuple(
            jshd.activation_spec(m, mode))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "llama3-405b"])
def test_new_configs_equal_the_reference(arch):
    from importlib import import_module
    for variant in ("full", "smoke", "swa"):
        assert tconfigs.get_config(arch, variant) == config_from_jax(
            jreg.get_config(arch, variant)), variant
    jmod = import_module(f"repro.configs.{arch.replace('-', '_')}")
    tmod = import_module(f"repro_torch.configs.{arch.replace('-', '_')}")
    assert tmod.SWA_WINDOW == jmod.SWA_WINDOW


def test_mesh_helpers_and_knobs_follow_the_reference():
    """batch_axes / fsdp_axis / model_axis on every stub mesh, the local
    mesh, the production shapes over four cards, and the routing-group
    rule's data-parallel rounding."""
    for name in MESHES:
        m = stub(name)
        assert tmesh.batch_axes(m) == jmesh.batch_axes(m)
        assert tmesh.fsdp_axis(m) == jmesh.fsdp_axis(m) == "data"
        assert tmesh.model_axis(m) == jmesh.model_axis(m) == "model"
    local = tmesh.make_local_mesh()
    jl = jmesh.make_local_mesh()
    assert local.axis_names == jl.axis_names
    assert local.shape == dict(jl.shape) == {"data": 1, "model": 1}
    assert local.group("model") is None and local.index("data") == 0
    assert tmesh.production_shape(4) == (2, 2)
    assert tmesh.production_shape(4, multi_pod=True) == (2, 1, 2)
    assert tmesh.production_shape(1) == (1, 1)
    assert tmesh.production_shape(8) == (2, 4)
    for arch in ("qwen3-moe-235b-a22b", "olmoe-1.3b-6.9b"):
        jcfg = jreg.get_config(arch, "full")
        tcfg = tconfigs.get_config(arch, "full")
        for name in MESHES:
            m = stub(name)
            for B, S in ((256, 4096), (8, 4096), (32, 64), (2, 16)):
                assert tsteps.choose_num_groups(tcfg, B, S, mesh=m) == \
                    jsteps.choose_num_groups(jcfg, B, S, m), (name, B, S)


@functools.lru_cache(maxsize=None)
def _caches(arch, batch, depth):
    jcfg = jreg.get_config(arch, "full")
    tcfg = tconfigs.get_config(arch, "full")
    return (jcfg, jspecs.abstract_cache(jcfg, batch, depth), tcfg,
            tsteps.abstract_cache(tcfg, batch, depth))


@pytest.mark.parametrize("batch", [256, 32, 1])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jreg.list_archs())
def test_cache_specs_equal_the_reference(arch, mesh, batch):
    """The reference's rule: K/V's sequence on ``model`` where it divides
    (a 30-deep cache stays whole on 4 and 16 ways), the batch on the batch
    axes where it divides; Mamba state by channel and head."""
    m = stub(mesh)
    for depth in (32768, 30):
        jcfg, jc, tcfg, tc = _caches(arch, batch, depth)
        want = _jflat(jshd.cache_specs(jcfg, jc, m, batch))
        assert _tflat(tshd.cache_specs(tcfg, tc, m, batch)) == want
        assert set(want) == set(_tflat(tc))


ATTN_ARCHS = [a for a in jreg.list_archs()
              if tconfigs.get_config(a, "full").n_heads]


@pytest.mark.parametrize("ways", [2, 4, 16])
@pytest.mark.parametrize("arch", ATTN_ARCHS + ["6/2 heads", "10/5 heads"])
def test_kv_layout_keeps_each_rank_its_columns(arch, ways):
    """Every rank's heads cover its columns of ``wo`` (the reference's
    contiguous split of H·hd), at most ceil(H/M) + 1 of them, and each
    local query head reads its own KV head (h // rep) in the layout the
    flash kernel takes (local head i reads head i // (nh / nkv))."""
    from repro_torch.models import attention as tattn
    if "/" in arch:
        # 1.5 heads a rank on 4 ways; 2.5 (a rank's heads end mid-group)
        H, KV = (int(n) for n in arch.split()[0].split("/"))
        cfg = tconfigs.get_config("phi4-mini-3.8b", "smoke").replace(
            n_heads=H, n_kv_heads=KV)
    else:
        cfg = tconfigs.get_config(arch, "full")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    C, rep = H * hd // ways, H // KV
    labels = torch.arange(KV, dtype=torch.float32)[:, None]
    for r in range(ways):
        sh = SimpleNamespace(M=ways, mi=r)
        h0, nh, off, kv_split = tattn.kv_layout(cfg, sh)
        assert kv_split == (KV % ways == 0)
        assert h0 * hd + off == r * C and off + C <= nh * hd
        assert nh <= -(-H // ways) + 1
        got = tattn._local_kv(labels, cfg, sh)[:, 0]
        per = nh // got.shape[0]
        assert [int(got[i // per]) for i in range(nh)] == [
            h // rep for h in range(h0, h0 + nh)]


class _RankMesh:
    """A stub mesh at one rank's coordinates (no process group)."""

    def __init__(self, shape, axes, rank):
        self.shape, self.axis_names = dict(zip(axes, shape)), axes
        self.coords = {}
        for ax in reversed(axes):
            self.coords[ax] = rank % self.shape[ax]
            rank //= self.shape[ax]

    def index(self, axes):
        i = 0
        for ax in self.axis_names:
            if ax in axes:
                i = i * self.shape[ax] + self.coords[ax]
        return i


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 1, 2), ("pod", "data", "model")),
                                        ((1, 4), ("data", "model"))])
def test_shard_tree_slices_and_reassembles_exactly(shape, axes):
    cfg = tconfigs.get_config("qwen3-moe-235b-a22b", "smoke")
    params = tsteps.abstract_params(cfg)
    gen = torch.Generator().manual_seed(0)
    full = {key: torch.randn(t.shape, generator=gen) for key, t in
            (("embed", params["embed"]["tokens"]),
             ("wq", params["blocks"]["pos0"]["attn"]["wq"]),
             ("experts", params["blocks"]["pos0"]["moe"]["experts"]["w2"]))}
    specs = {"embed": ("model", None), "wq": (None, "data", "model"),
             "experts": (None, "model", "data", None)}
    n = int(np.prod(shape))
    meshes = [_RankMesh(shape, axes, r) for r in range(n)]
    for key, t in full.items():
        back = torch.full_like(t, float("nan"))
        for m in meshes:
            piece = tshd.shard_leaf(t, specs[key], m)
            assert piece.shape == tshd.local_shape(t.shape, specs[key], m)
            idx = []
            for dim, entry in enumerate(specs[key]):
                ways = 1 if entry is None else m.shape[entry]
                size = t.shape[dim] // ways
                at = 0 if entry is None else m.index((entry,))
                idx.append(slice(at * size, (at + 1) * size))
            back[tuple(idx)] = piece
        assert torch.equal(back, t), key
    # the whole-tree form takes the same slices
    sharded = tshd.shard_tree(full, specs, meshes[-1])
    assert torch.equal(sharded["wq"],
                       tshd.shard_leaf(full["wq"], specs["wq"], meshes[-1]))


@pytest.mark.parametrize("adapter", [False, True])
def test_grouped_expert_einsum_matches_the_reference(adapter):
    rng = np.random.default_rng(0)
    G, E, C, K, N, r = 3, 4, 8, 16, 24, 4
    x = rng.normal(size=(G, E, C, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32) * 0.2
    lp = ({"a": rng.normal(size=(E, K, r)).astype(np.float32) * 0.2,
           "b": rng.normal(size=(E, r, N)).astype(np.float32) * 0.2}
          if adapter else None)
    want = jlayers.lora_expert_einsum(
        jnp.asarray(x), jnp.asarray(w),
        None if lp is None else {k: jnp.asarray(v) for k, v in lp.items()},
        0.5)
    got = tlayers.lora_expert_einsum(
        torch.tensor(x), torch.tensor(w),
        None if lp is None else {k: torch.tensor(v) for k, v in lp.items()},
        0.5)
    assert got.shape == (G, E, C, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
