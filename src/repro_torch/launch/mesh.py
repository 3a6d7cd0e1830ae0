"""The card mesh: a port of ``repro/launch/mesh.py``.

The reference lays its chips out as a ``jax.sharding.Mesh`` and lets GSPMD
place the collectives.  Here a :class:`Mesh` is a view of the ranks of one
``torch.distributed`` process group (one process a card) as a grid with
the reference's axis names:

  * ``data``  — the batch and FSDP axis: the batch is split over it, and
    the frozen weights' input features are stored split over it and
    gathered just before a layer uses them;
  * ``model`` — the tensor / expert parallel axis: heads, FFN columns,
    experts and the vocabulary are split over it;
  * ``pod``   — (``multi_pod``) a second data-parallel axis in front:
    weights are replicated across pods, only the batch and the gradient
    all-reduce cross it.

Ranks are laid out row-major over the axes (``model`` fastest), as
``jax.make_mesh`` orders devices, so a rank's coordinate on an axis is its
rank inside that axis's process group.  The mesh holds one process group
for every set of axes whose ranks share the other coordinates (``None``
where such a group would have one rank): ``mesh.group("model")``,
``mesh.group(("pod", "data"))`` (the batch axes), ``mesh.group(("data",
"model"))`` and so on.

Workers: :func:`spawn` starts one process a card with the ``spawn`` start
method and a ``file://`` rendezvous, or :func:`init_from_env` joins the
world ``torchrun`` describes in the environment.  The dry run
(``launch/dryrun.py``) plays rank 0 of a world of any size in one
process instead (:func:`fake_world`).
"""
from __future__ import annotations

import itertools
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]
AXIS_ORDER = ("pod", "data", "model")


class Mesh:
    """A grid view of the current process group's ranks (or of this
    process alone, for a mesh of one)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        n = 1
        for s in shape:
            n *= s
        if n == 1:
            rank, world = 0, 1
        elif dist.is_available() and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
        else:
            raise RuntimeError(f"a {shape} mesh needs an initialised process "
                               f"group of {n} ranks (launch.mesh.spawn)")
        if n != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} has {n} "
                             f"ranks, the process group {world}")
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.rank = rank
        coords, rest = {}, rank
        for ax in reversed(axis_names):
            coords[ax] = rest % self.shape[ax]
            rest //= self.shape[ax]
        self.coords = {ax: coords[ax] for ax in axis_names}
        self._groups = {}
        # every rank creates every group, in the same order
        for r in range(1, len(axis_names) + 1):
            for sub in itertools.combinations(axis_names, r):
                self._groups[sub] = self._make_groups(sub, world)

    def _make_groups(self, sub: Tuple[str, ...], world: int):
        if self.size(sub) == 1:
            return None
        classes: Dict[tuple, list] = {}
        for q in range(world):
            c = self._coords_of(q)
            key = tuple(c[ax] for ax in self.axis_names if ax not in sub)
            classes.setdefault(key, []).append(q)
        mine = None
        for key in sorted(classes):
            g = dist.new_group(classes[key])
            if self.rank in classes[key]:
                mine = g
        return mine

    def _coords_of(self, q: int) -> Dict[str, int]:
        out = {}
        for ax in reversed(self.axis_names):
            out[ax] = q % self.shape[ax]
            q //= self.shape[ax]
        return out

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(ax for ax in self.axis_names if ax in axes)

    def size(self, axes: Axes) -> int:
        n = 1
        for ax in self._axes(axes):
            n *= self.shape[ax]
        return n

    def index(self, axes: Axes) -> int:
        """This rank's row-major coordinate over ``axes`` (its rank in
        ``group(axes)``)."""
        i = 0
        for ax in self._axes(axes):
            i = i * self.shape[ax] + self.coords[ax]
        return i

    def group(self, axes: Axes):
        """The process group over ``axes`` holding this rank; None when it
        would hold this rank alone."""
        sub = self._axes(axes)
        return self._groups.get(sub) if sub else None

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"


def make_local_mesh() -> Mesh:
    """A mesh of this process alone with the production axis names: the
    mesh steps on one device."""
    return Mesh((1, 1), ("data", "model"))


def production_shape(n: int, multi_pod: bool = False) -> Tuple[int, ...]:
    """The grid over ``n`` cards with both axes acting: ``model`` takes the
    larger half of the power of two (2 of 2 cards, 2 of 4, 4 of 8) and
    ``data`` the rest; ``multi_pod`` puts a 2-way ``pod`` axis in front and
    splits each pod's half alike: (2, 2) and (2, 1, 2) on four cards."""
    if multi_pod:
        if n % 2:
            raise ValueError(f"multi_pod needs an even number of cards, "
                             f"not {n}")
        return (2,) + production_shape(n // 2)
    model = 1
    while model * model < n and n % (model * 2) == 0:
        model *= 2
    return (n // model, model)


def make_production_mesh(*, multi_pod: bool = False,
                         mesh_shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh over every rank of the process group (one a card):
    :func:`production_shape`, or ``mesh_shape`` (the role of the
    reference's dry-run override), with axes ``("data", "model")`` or
    ``("pod", "data", "model")``.  On a world of 256 (512) ranks that is
    the reference's 16 x 16 (2 x 16 x 16) mesh; on four cards (2, 2) or
    (2, 1, 2)."""
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    axes = AXIS_ORDER if multi_pod else AXIS_ORDER[1:]
    shape = (tuple(mesh_shape) if mesh_shape is not None
             else production_shape(world, multi_pod))
    return Mesh(shape, axes)


def fake_world(world: int) -> None:
    """Make this process rank 0 of a world of ``world`` ranks on torch's
    ``fake`` process-group backend (``torch.testing._internal.distributed
    .fake_pg``): every collective returns at once and moves nothing, so
    a step on ``meta`` tensors traces the collectives rank 0 would make.
    For the dry run only; a process that has started another backend
    (NCCL, gloo) cannot start this one too.  An earlier fake world is
    replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes that shard the global batch dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def fsdp_axis(mesh: Mesh) -> str:
    return "data"


def model_axis(mesh: Mesh) -> str:
    return "model"


def rank_peaks(device) -> list:
    """Every rank's peak allocated bytes on its card since the last reset
    (an all-gather over the whole process group)."""
    mine = torch.tensor([float(torch.cuda.max_memory_allocated(device))],
                        device=device)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [mine.item()]
    out = mine.new_empty(dist.get_world_size())
    dist.all_gather_into_tensor(out, mine)
    return out.tolist()


# --------------------------------------------------------------------------
# workers
# --------------------------------------------------------------------------

def _worker(rank, fn, world, init_method, backend, args):
    init_process(rank, world, init_method, backend)
    # not in a ``finally``: a rank that raised must exit at once (``spawn``
    # then stops the others and raises its error); tearing its group down
    # first would wait on peers blocked in a collective it never joins
    fn(rank, world, *args)
    dist.destroy_process_group()


def init_process(rank: int, world: int, init_method: str,
                 backend: str) -> None:
    """Join a world of ``world`` ranks; an NCCL rank takes card ``rank``
    (of those it sees) as its device, a gloo rank its share of the CPU
    cores for PyTorch's threads."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def spawn(fn: Callable, world: int, *args, backend: str = "nccl",
          init_method: Optional[str] = None,
          timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method: a parent that has touched CUDA must not fork)
    joined in one process group, and wait for them; a worker's exception
    is raised here.  ``init_method`` defaults to a ``file://`` rendezvous
    in a temporary directory (no port to race for).  ``timeout`` (s):
    past it the workers are killed and ``TimeoutError`` raised."""
    import tempfile
    import time

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        init_method = init_method or f"file://{tmp}/rendezvous"
        ctx = mp.start_processes(_worker,
                                 args=(fn, world, init_method, backend, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} workers ran past {timeout} s")


def init_from_env(backend: str) -> Tuple[int, int]:
    """Under ``torchrun``: join the world its environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``).
    Returns (rank, world)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return rank, world
