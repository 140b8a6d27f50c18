"""Parameters as flat dicts of tensors.

The reference keeps a model's parameters as a nest of dicts and lists
(``{"mlps": [[{"w", "b"}, ...], ...], "eps": ...}``). The port keeps them
flat, one tensor a dotted name (``mlps.0.1.w``, ``layers.2.phi_e.0.b``,
``gru.wx``), which is what the optimizer, the checkpoints and the Trainer
walk; a model's forward rebuilds the nest with ``unflatten`` and reads it
as the reference does. The names follow the reference's tree, so its
parameters, gradients and optimizer state carry across by name.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def flat_items(tree, prefix: str = ""):
    """(dotted path, leaf) pairs of a nest of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from flat_items(v, f"{prefix}.{k}" if prefix else str(k))


def flatten(tree) -> dict:
    return dict(flat_items(tree))


def prefixed(prefix: str, flat: dict) -> dict:
    """``flat`` with every name under ``prefix``."""
    return {f"{prefix}.{k}": v for k, v in flat.items()}


def unflatten(flat: dict):
    """The nest of dicts and lists that ``flatten`` came from: a level
    whose keys are 0..k-1 is a list, any other a dict."""
    root: dict = {}
    for name, leaf in flat.items():
        node = root
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and sorted(out) == sorted(map(str, range(len(out)))):
        return [out[str(i)] for i in range(len(out))]
    return out


# numpy dtypes torch cannot take directly (the reference's ml_dtypes
# arrays): carried bit for bit through an integer view of the same width
_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _tensor(a, device):
    a = np.array(a)
    if a.dtype.name in _BITS:
        bits, dtype = _BITS[a.dtype.name]
        return torch.from_numpy(a.view(bits)).view(dtype).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device=None) -> dict:
    """The reference's parameter tree (any arrays, bfloat16 and float8
    ones bit for bit) as the port's flat dict on ``device`` (default: the
    GPU)."""
    device = resolve_device(device)
    return {name: _tensor(a, device) for name, a in flat_items(tree)}


def opt_state_from_numpy(state, device=None) -> dict:
    """The reference's AdamW state ({"step", "per_param": tree of {"m",
    "v"}}, or "vr" and "vc" in place of "v" where it is factored) as the
    port's ({"step", "per_param": {name: {"m", "v"}}})."""
    device = resolve_device(device)
    per = {}
    for path, a in flat_items(state["per_param"]):
        name, moment = path.rsplit(".", 1)
        per.setdefault(name, {})[moment] = _tensor(a, device)
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                        device=device)
    return {"step": step, "per_param": per}
