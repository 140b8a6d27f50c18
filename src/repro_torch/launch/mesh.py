"""Mesh construction (port of ``repro/launch/mesh.py``).

Every mesh is a ``DeviceMesh`` over the current process group, which the
caller starts first: NCCL or gloo ranks (``distributed/ranks.py``), or,
for the dry-run, a fake group of the production size in one process
(``fake_process_group``). Importing this module touches no group.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the process group; the last
    axis varies fastest over consecutive ranks."""
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh: 16x16 ("data", "model") or 2x16x16 ("pod",
    "data", "model"); the group must have 256 or 512 ranks."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def host_device_mesh(model_parallel: int = 1) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the group."""
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel="
                         f"{model_parallel}")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"))


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A process group of ``world_size`` ranks in this one process, this
    process rank 0, whose collectives move nothing (the counterpart of the
    reference dry-run's fake host devices). Use it with meta tensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
