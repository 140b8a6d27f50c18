"""Divisibility-aware logical-axis sharding resolver (port of
``repro/distributed/sharding.py``).

Parameters and inputs carry *logical* axis names (``configs/base.py``'s
specs); the resolver maps them to the axes of a ``DeviceMesh`` with an
ordered preference list, skipping any candidate whose size does not divide
the dimension or whose mesh axes another dimension of the same tensor
already took. That is what lets one rule set cover qwen1.5 (40 KV heads,
not divisible by model=16: falls back) and llama3 (8 KV heads) without
per-arch placements.

``resolve_spec`` gives the reference's per-dimension assignment (a mesh
axis name, a tuple of names used jointly, or None; trailing Nones
dropped). ``tree_shardings`` turns it into each leaf's DTensor placements
(one per mesh axis) and its shard shape on a device. A mesh is a
``DeviceMesh`` (a real one or one over a fake process group) or a mapping
of axis name to size.

``use_mesh(mesh)`` makes a mesh ambient, the counterpart of the
reference's ``with mesh:``; ``ambient_axes_size`` and ``constrain`` read
it inside model code. ``constrain`` redistributes a DTensor to the
resolved placements. The sharded train step (``train/sharded.py``) hands
the model each rank's own block as a plain tensor, already where the step
put it, and ``constrain`` passes such a tensor through.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections.abc import Mapping
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

# Ordered candidates per logical axis. Each candidate is a tuple of mesh
# axes used jointly (their sizes multiply).
DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    # FSDP: weight 'embed' dims shard over the data axes (pod+data jointly
    # when available: params and optimizer state scale down with the full
    # data-parallel world size)
    "embed": (("pod", "data"), ("data",)),
    "mlp": (("model",),),
    "heads": (("model",),),
    "kv": (("model",),),
    "vocab": (("model",),),
    "experts": (("model",),),
    "expert_cap": (("pod", "data"), ("data",)),   # MoE buffer capacity dim
    # data-parallel batch over pod+data jointly, falling back to data
    "batch": (("pod", "data"), ("data",)),
    "seq": (("model",),),          # sequence parallelism (long contexts)
    "kv_seq": (("model",),),       # decode cache sequence dim
    "kv_heads": (("model",),),
    "nodes": (("pod", "data", "model"), ("data", "model")),
    "edges": (("pod", "data", "model"), ("data", "model")),
    "candidates": (("pod", "data", "model"), ("data", "model")),
}


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping of them."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_size(sizes: dict, axes: tuple[str, ...]) -> int | None:
    total = 1
    for a in axes:
        if a not in sizes:
            return None
        total *= sizes[a]
    return total


def resolve_spec(shape: tuple[int, ...], logical, mesh,
                 rules=None) -> tuple:
    """Map per-dim logical names to mesh axes for ``shape``: per dim a
    name, a tuple of names, or None; trailing Nones dropped."""
    rules = rules or DEFAULT_RULES
    if logical is None:
        return ()
    if len(logical) != len(shape):
        raise ValueError(f"spec {logical} for shape {shape}")
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out: list[Any] = []
    for dim, name in zip(shape, logical):
        assigned = None
        if name is not None:
            for cand in rules.get(name, ()):
                size = _axes_size(sizes, cand)
                if size is None or size == 1 or dim % size != 0:
                    continue
                if any(a in used for a in cand):
                    continue
                assigned = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def batch_axes(mesh) -> tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


class LeafSharding(NamedTuple):
    """One leaf's place on the mesh."""
    spec: tuple            # resolve_spec's per-dim assignment
    placements: tuple      # a DTensor placement per mesh axis
    local_shape: tuple     # the shard one device holds
    local_bytes: int       # its bytes


def leaf_sharding(t: torch.Tensor, logical, mesh,
                  rules=None) -> LeafSharding:
    shape = tuple(t.shape)
    spec = resolve_spec(shape, logical, mesh, rules)
    sizes = axis_sizes(mesh)
    placements = [Replicate()] * len(sizes)
    local = list(shape)
    names = list(sizes)
    for dim, assigned in enumerate(spec):
        if assigned is None:
            continue
        for a in (assigned if isinstance(assigned, tuple) else (assigned,)):
            placements[names.index(a)] = Shard(dim)
            local[dim] //= sizes[a]
    return LeafSharding(spec, tuple(placements), tuple(local),
                        math.prod(local) * t.element_size())


def _tensor_leaves(tree, path=()):
    """(path, tensor) of every tensor in a nest of dicts, lists, tuples and
    dataclasses (a ``GraphBatch``); other leaves (its ``n_graphs``) are no
    arrays and are skipped."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensor_leaves(v, path + (i,))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensor_leaves(getattr(tree, f.name), path + (f.name,))


def _at(tree, path):
    for key in path:
        tree = (getattr(tree, key) if dataclasses.is_dataclass(tree)
                else tree[key])
    return tree


def tree_shardings(shapes_tree, specs_tree, mesh, rules=None) -> dict:
    """{dotted path: ``LeafSharding``} for every tensor of ``shapes_tree``
    (e.g. ``step_arg_specs``' first half), its logical spec read at the
    same path of ``specs_tree``."""
    return {".".join(map(str, path)): leaf_sharding(
                t, _at(specs_tree, path), mesh, rules)
            for path, t in _tensor_leaves(shapes_tree)}


# ------------------------------------------------------------ ambient mesh

# the ``use_mesh`` stack: a process-wide list, not a context variable,
# because autograd runs a CUDA backward (and the layers it recomputes) on a
# thread of its own, which must see the mesh its forward saw
_AMBIENT: list = [None]


def mesh_size(mesh) -> int:
    """Devices of a ``DeviceMesh`` (1 for None)."""
    return 1 if mesh is None else math.prod(axis_sizes(mesh).values())


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh inside the block (None: no mesh)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def ambient_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _AMBIENT[-1]


def ambient_axes_size(axes: tuple[str, ...] = ("model",)) -> int:
    """Product of the named ambient-mesh axis sizes (1 when no mesh; an
    axis the mesh lacks counts 1)."""
    mesh = ambient_mesh()
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in axes)


def constrain(x, logical, rules=None):
    """Mesh-aware layout pin inside model code: a DTensor is redistributed
    to ``resolve_spec``'s placements on the ambient mesh. Without an
    ambient mesh of more than one device, and for a plain tensor (a rank's
    own block), ``x`` comes back unchanged."""
    mesh = ambient_mesh()
    if mesh is None or mesh_size(mesh) <= 1 or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, leaf_sharding(x, logical, mesh,
                                              rules).placements)
