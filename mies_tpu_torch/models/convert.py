"""Carry denoiser weights between the reference's flax trees and the port.

``flax_to_torch`` takes the reference's parameter tree as numpy arrays
(``{"params": {...}}`` as ``init`` and orbax give it, or its inner dict)
and returns the port's state dict; ``torch_to_flax`` is its inverse. The
tree is walked by module order, with the names read from the tree: flax
numbers each submodule per class in call order (``Conv_0``, ``Conv_1``,
``_ConvBlock_0``, ...), and ``nn.remat`` renames the class it wraps
(``Checkpoint_MidBlock_0``, ``Checkpoint_ConvBlock_0``). Kernels are HWIO
in flax and OIHW in PyTorch: ``transpose(3, 2, 0, 1)``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_NUMBERED = re.compile(r"^(.*)_(\d+)$")


def _groups(tree: dict) -> dict[str, list[str]]:
    """The tree's keys grouped by module name, each group in call order."""
    out: dict[str, list[tuple[int, str]]] = {}
    for key in tree:
        m = _NUMBERED.match(key)
        if m is None:
            raise ValueError(f"unexpected flax module name {key!r}")
        out.setdefault(m.group(1), []).append((int(m.group(2)), key))
    return {k: [name for _, name in sorted(v)] for k, v in out.items()}


def _remat_group(groups: dict, plain: set[str]) -> list[str]:
    """The one group that is not a plain module class: the remat-wrapped
    blocks."""
    rest = [g for g in groups if g not in plain]
    if len(rest) != 1:
        raise ValueError(f"expected one remat-wrapped module group, got {rest}")
    return groups[rest[0]]


def _conv_paths(tree: dict, arch: str, depth: int) -> list[tuple[tuple, str]]:
    """[(flax path of a conv's dict, torch prefix)] in module order."""
    g = _groups(tree)
    convs = g.get("Conv", [])
    if arch == "dncnn":
        mids = _remat_group(g, {"Conv"})
        if len(convs) != 2 or len(mids) != depth - 2:
            raise ValueError(f"dncnn depth {depth}: tree has {convs}, {mids}")
        names = [(convs[0],)] + [(m, "Conv_0") for m in mids] + [(convs[1],)]
        return [(p, f"convs.{i}") for i, p in enumerate(names)]
    if arch == "unet":
        blocks = g.get("_ConvBlock", [])
        mid = _remat_group(g, {"Conv", "_ConvBlock"})
        if len(convs) != 2 * depth + 1 or len(blocks) != 2 * depth or len(mid) != 1:
            raise ValueError(f"unet levels {depth}: tree has {sorted(tree)}")
        out = []

        def block(name, prefix):
            out.append(((name, "Conv_0"), f"{prefix}.conv1"))
            out.append(((name, "Conv_1"), f"{prefix}.conv2"))

        for lvl in range(depth):
            block(blocks[lvl], f"enc.{lvl}")
            out.append(((convs[lvl],), f"down.{lvl}"))
        block(mid[0], "mid")
        for i in range(depth):
            out.append(((convs[depth + i],), f"up.{i}"))
            block(blocks[depth + i], f"dec.{i}")
        out.append(((convs[2 * depth],), "out"))
        return out
    raise ValueError(f"unknown denoiser arch {arch!r}; use 'dncnn' or 'unet'")


def _at(tree: dict, path: tuple) -> dict:
    for k in path:
        tree = tree[k]
    return tree


def flax_to_torch(params, arch: str, features: int, depth: int
                  ) -> dict[str, torch.Tensor]:
    """The port's state dict of a flax parameter tree of numpy arrays."""
    tree = params.get("params", params)
    state = {}
    for path, prefix in _conv_paths(tree, arch, depth):
        conv = _at(tree, path)
        kernel = np.asarray(conv["kernel"], np.float32)
        if kernel.shape[:2] != (3, 3):
            raise ValueError(f"{path}: kernel {kernel.shape} is not 3x3 HWIO")
        state[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        state[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(conv["bias"], np.float32).copy())
    if arch == "dncnn" and state["convs.0.weight"].shape[0] != features:
        raise ValueError(f"tree has {state['convs.0.weight'].shape[0]} "
                         f"features, not {features}")
    return state


def _flax_names(arch: str, depth: int) -> dict:
    """The flax tree's skeleton ({name: {...}} of empty conv dicts) as the
    reference's init names it."""
    if arch == "dncnn":
        tree = {"Conv_0": {}, "Conv_1": {}}
        tree.update({f"Checkpoint_MidBlock_{i}": {"Conv_0": {}}
                     for i in range(depth - 2)})
        return tree
    tree = {f"Conv_{i}": {} for i in range(2 * depth + 1)}
    tree.update({f"_ConvBlock_{i}": {"Conv_0": {}, "Conv_1": {}}
                 for i in range(2 * depth)})
    tree["Checkpoint_ConvBlock_0"] = {"Conv_0": {}, "Conv_1": {}}
    return tree


def torch_to_flax(state: dict, arch: str, features: int, depth: int) -> dict:
    """The reference's ``{"params": ...}`` tree of numpy arrays of a port
    state dict (the inverse of ``flax_to_torch``)."""
    tree = _flax_names(arch, depth)
    for path, prefix in _conv_paths(tree, arch, depth):
        conv = _at(tree, path)
        w = state[f"{prefix}.weight"].detach().cpu().numpy()
        conv["kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        conv["bias"] = state[f"{prefix}.bias"].detach().cpu().numpy().copy()
    return {"params": tree}
