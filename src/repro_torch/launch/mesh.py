"""Production mesh construction on ``torch.distributed``, the counterpart of
``repro.launch.mesh``.

A FUNCTION, not a module-level constant: importing this module touches no
process group.  The mesh spans the ranks of the initialized world, one
process per card under NCCL (its ``DeviceMesh`` on the rank's card) or one
CPU process per rank under gloo.

The reference's pod shapes are (data=16, model=16) for 256 chips and
(pod=2, data=16, model=16) for 512.  A world of exactly that size gets that
shape.  A smaller world gets ``(world, 1)`` (two pods: ``(2, world / 2,
1)``): every rank on "data", which is FSDP only (ROADMAP.md §3, a
departure).  A world that cannot carry the axis names raises
``ValueError``; there is no quiet fallback to one process.

``fake_world(world, rank)`` starts a world of ``world`` ranks inside this
one process, on torch's ``"fake"`` backend, whose collectives move nothing:
the dry run (``launch.dryrun``) runs one rank's step there under
``FakeTensorMode``, so that the step traces every collective and every op
of that rank on a world of any size, with no card and no storage.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_mesh", "production_shape", "POD_CHIPS", "describe",
           "fake_world"]

POD_CHIPS = 256  # the reference's 16 x 16 pod

# The device type of the meshes of the running fake world (None: no fake
# world runs; the process group, like it, is one per process).
_fake_device: str | None = None


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0, *, device: str = "cuda"):
    """A ``torch.distributed`` world of ``world`` ranks in this process, as
    rank ``rank``, on the ``"fake"`` backend (its collectives return at once
    and move nothing); destroyed on exit.  Meshes made in it lie on
    ``device``: "cuda" traces the card's path (a fake card under
    ``FakeTensorMode``), "cpu" the CPU's.  A process that already has a
    world raises ``RuntimeError``."""
    global _fake_device
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("this process already has a torch.distributed world")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"a fake world's meshes lie on cuda or cpu, not {device!r}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    _fake_device = device
    try:
        yield
    finally:
        _fake_device = None
        dist.destroy_process_group()


def production_shape(world: int, *, multi_pod: bool = False) -> tuple[tuple[int, ...],
                                                                       tuple[str, ...]]:
    """(shape, axis names) of the production mesh on ``world`` ranks."""
    if multi_pod:
        axes = ("pod", "data", "model")
        if world == 2 * POD_CHIPS:
            return (2, 16, 16), axes
        if world < 2 * POD_CHIPS and world % 2 == 0:
            return (2, world // 2, 1), axes
        raise ValueError(f"two pods need an even world of at most {2 * POD_CHIPS} ranks, "
                         f"not {world}")
    axes = ("data", "model")
    if world == POD_CHIPS:
        return (16, 16), axes
    if 1 <= world < POD_CHIPS:
        return (world, 1), axes
    raise ValueError(f"one pod holds at most {POD_CHIPS} ranks, not {world}; use multi_pod")


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    initialized world (the counterpart of ``jax.make_mesh``): on the rank's
    card under NCCL, on the CPU under gloo, on ``fake_world``'s device in a
    fake world."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized torch.distributed world "
                           "(torchrun, or init_process_group)")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = dist.get_world_size()
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh {shape} over axes {axes} does not cover a world of {world}")
    backend = str(dist.get_backend())
    kind = (_fake_device or "cpu") if backend == "fake" else ("cuda" if "nccl" in backend else "cpu")
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(data, model) for one pod; (pod, data, model) for two.  The "pod"
    axis carries only data parallelism, which the sharding rules encode."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("the production mesh needs an initialized torch.distributed "
                           "world (torchrun, or init_process_group)")
    return make_mesh(*production_shape(dist.get_world_size(), multi_pod=multi_pod))


def describe(mesh) -> str:
    return "x".join(f"{a}={s}" for a, s in zip(mesh.mesh_dim_names, mesh.shape))
