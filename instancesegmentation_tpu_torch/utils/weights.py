"""Weight carrying between the flax variable tree and the port's state dict.

The port's ``nn.Module`` attributes are named after the state-dict keys of
the PyTorch reference Segment, so carrying flax variables over is the key
mapping ``flax_to_torch_key`` plus the layout transforms below.  This module
keeps its own copy of the mapping of
``instancesegmentation_tpu/utils/torch_import.py`` (the port imports nothing
of the JAX package).

The int8 input scales (JAX's ``quant`` collection) carry over with
``jax_quant_to_torch`` and back with ``torch_quant_to_jax``.

Layouts:
- Conv2d            flax HWIO ``[kh, kw, in/g, out]``  <->  torch ``[out, in/g, kh, kw]``
- ConvTranspose2d   flax conv-ready HWIO, spatially flipped  <->  torch
  ``[in, out, kh, kw]``
- BatchNorm scale/bias + batch_stats mean/var  <->  weight/bias +
  running_mean/running_var
- PReLU alpha  <->  weight
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _conv_w(w) -> np.ndarray:
    """torch Conv2d weight -> flax HWIO kernel."""
    return np.asarray(w).transpose(2, 3, 1, 0)


def _convT_w(w) -> np.ndarray:
    """torch ConvTranspose2d weight ``[in, out, kh, kw]`` -> flax conv-ready
    HWIO kernel, spatially flipped."""
    k = np.asarray(w).transpose(2, 3, 0, 1)
    return k[::-1, ::-1].copy()


def _conv_w_inv(k) -> np.ndarray:
    """flax HWIO kernel -> torch Conv2d weight."""
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _convT_w_inv(k) -> np.ndarray:
    """flax conv-ready (flipped) HWIO kernel -> torch ConvTranspose2d weight."""
    return np.ascontiguousarray(np.asarray(k)[::-1, ::-1].transpose(2, 3, 0, 1))


def flax_to_torch_key(path: tuple, collection: str) -> tuple[str, str | None]:
    """Map a flax variable path to (torch state_dict key, transform name).

    ``path`` is the tuple of name components under the collection, e.g.
    ``('bottle4_1up', 'convs_1', 'kernel')``.
    """
    parts = list(path)
    top = parts[0]
    m = re.fullmatch(r"(bottle\d_x)_(\d+)", top)
    tparts = [f"{m.group(1)}.{m.group(2)}"] if m else [top]
    in_up = top.endswith("up")

    leaf = parts[-1]
    mids = parts[1:-1]

    # leaf directly under the top module: bottle6_1 ConvTranspose
    if not mids:
        if top == "bottle6_1":
            return (
                f"{tparts[0]}.{'weight' if leaf == 'kernel' else 'bias'}",
                "convT" if leaf == "kernel" else None,
            )
        raise KeyError(f"unexpected flax path {path}")

    for mid in mids:
        if mid in ("layer1", "layer2"):
            tparts.append(mid)
        elif mid == "convm":
            tparts.append("convm.0")
        elif mid == "resconv":
            tparts.append("resconv.0")
        elif mid == "conv2":
            tparts.append("conv2.0")
        elif mid == "uppool_conv":
            tparts.append("uppool.1")
        elif mid == "convs_bn":
            tparts.append("convs.2")  # raw BN inside the Up convs Sequential
        elif mid.startswith("convs_"):
            idx = int(mid.split("_")[1])
            if in_up and idx == 1:
                # ConvTranspose2d at Sequential index 1
                tparts.append("convs.1")
            elif in_up and idx == 2:
                # final 1x1 Conv sits at Sequential index 4 (after BN+ReLU)
                tparts.append("convs.4")
            else:
                tparts.append(f"convs.{idx}")
        elif mid == "conv":
            # inner conv of ConvBN / RawConv; the torch 'Conv' wrapper nests
            # it as '.conv', but raw Conv2d modules (uppool.1, bottle6_2,
            # Bottleneck5x5 convs.1) hold their weights directly
            prev = tparts[-1]
            is_raw = (
                prev == "uppool.1"
                or tparts[0] == "bottle6_2"
                or (prev == "convs.1" and _is_5x5_block(tparts[0]))
            )
            if not is_raw:
                tparts.append("conv")
        elif mid in ("bn", "act", "prelu"):
            tparts.append(mid)
        else:
            raise KeyError(f"unknown module component {mid!r} in {path}")

    base = ".".join(tparts)
    if leaf == "kernel":
        transform = "convT" if (in_up and "convs.1" in tparts) else "conv"
        return f"{base}.weight", transform
    if leaf == "bias" and collection == "params":
        # BN bias and conv bias both map to '.bias'
        return f"{base}.bias", None
    if leaf in ("scale", "alpha"):
        return f"{base}.weight", None
    if leaf == "mean":
        return f"{base}.running_mean", None
    if leaf == "var":
        return f"{base}.running_var", None
    raise KeyError(f"unknown leaf {leaf!r} in {path}")


def _is_5x5_block(torch_top: str) -> bool:
    """True if this top module is a Bottleneck5x5 (its convs.1 is a raw
    Conv2d with no BN/act wrapper).  In the Segment net the 5x5 blocks are
    exactly the last entries of the section-2/3 Sequentials."""
    return torch_top in ("bottle2_x.4", "bottle3_x.4")


def _leaves(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def port_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Segment weights as a port state dict of CPU tensors: flax-layout
    variables (``{"params", "batch_stats"}``) carried over with
    ``jax_variables_to_torch``, or a port state dict copied (its floating
    tensors as float32)."""
    if "params" in variables:
        return jax_variables_to_torch(variables)
    return {k: (v.detach().cpu().float() if v.is_floating_point() else v.detach().cpu())
            for k, v in variables.items()}


def jax_quant_to_torch(quant: Mapping) -> dict[str, float]:
    """JAX's ``quant`` collection (``{"init_conv": {"layer1": {"conv":
    {"amax": a}}}, ...}``) -> the port's input scales keyed by the conv's
    module path (``{"init_conv.layer1.conv": a, ...}``), through
    ``flax_to_torch_key``'s naming of the conv's kernel."""
    out = {}
    for path, leaf in _leaves(quant):
        if path[-1] != "amax":
            raise KeyError(f"unexpected quant leaf {path}")
        key, _ = flax_to_torch_key(path[:-1] + ("kernel",), "params")
        out[key.removesuffix(".weight")] = float(np.asarray(leaf, np.float32))
    return out


def torch_quant_to_jax(scales: Mapping) -> dict:
    """Inverse of ``jax_quant_to_torch``: the port's scales nested as JAX's
    ``quant`` collection (0-d float32 arrays, keys sorted)."""
    tree: dict = {}
    for key, amax in scales.items():
        _, path, _ = torch_to_flax_key(f"{key}.weight", "conv")
        node = tree
        for k in path[:-2]:
            node = node.setdefault(k, {})
        node.setdefault(path[-2], {})["amax"] = np.asarray(amax, np.float32)
    return _sorted(tree)


def port_quant(quant: Mapping) -> dict[str, float]:
    """Input scales in either form (JAX's nested ``quant`` collection, or
    the port's dict by module path) as the port's dict."""
    if quant and all(isinstance(v, Mapping) for v in quant.values()):
        return jax_quant_to_torch(quant)
    return {k: float(v) for k, v in quant.items()}


def jax_variables_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    """Carry flax variables ``{"params", "batch_stats"}`` (nested dicts of
    arrays) into a port state dict of float32 CPU tensors.

    Every leaf is mapped; a leaf without a torch key raises ``KeyError``.
    """
    sd: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            key, transform = flax_to_torch_key(path, collection)
            val = np.asarray(leaf, np.float32)
            if transform == "conv":
                val = _conv_w_inv(val)
            elif transform == "convT":
                val = _convT_w_inv(val)
            if key in sd:
                raise ValueError(f"two flax leaves map to {key}")
            sd[key] = torch.from_numpy(np.array(val, np.float32))
    return sd


def torch_to_jax_variables(state_dict: Mapping, template: Mapping) -> dict:
    """Inverse of ``jax_variables_to_torch``: copy a port state dict into the
    flax layout of ``template`` (flax variables giving the tree and shapes).

    Asserts a bijection: every template leaf receives one tensor of the
    matching shape and every state-dict entry except the
    ``num_batches_tracked`` counters is consumed.
    """
    sd = {
        k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
        for k, v in state_dict.items()
        if not k.endswith("num_batches_tracked")
    }
    used = set()
    out: dict = {}
    for collection in ("params", "batch_stats"):
        if collection not in template:
            continue
        tree: dict = {}
        for path, leaf in _leaves(template[collection]):
            key, transform = flax_to_torch_key(path, collection)
            if key not in sd:
                raise KeyError(f"state dict key {key} (for flax {path}) missing")
            val = sd[key]
            if transform == "conv":
                val = _conv_w(val)
            elif transform == "convT":
                val = _convT_w(val)
            if val.shape != tuple(np.shape(leaf)):
                raise ValueError(
                    f"shape mismatch {path}: {val.shape} vs {np.shape(leaf)}"
                )
            used.add(key)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = np.array(val, np.float32)
        out[collection] = tree
    unused = set(sd) - used
    if unused:
        raise ValueError(f"unconsumed state dict keys: {sorted(unused)[:8]}")
    return out


def torch_to_flax_key(key: str, kind: str) -> tuple[str, tuple, str | None]:
    """Inverse of ``flax_to_torch_key``: map a port state-dict key to
    ``(collection, flax path, transform)``.

    ``kind`` names the module that owns the key: ``"conv"`` (Conv2d),
    ``"convT"`` (ConvTranspose2d), ``"bn"`` (BatchNorm2d) or ``"prelu"``.
    The result is checked against ``flax_to_torch_key``, so the two mappings
    stay each other's inverse.
    """
    parts = key.split(".")
    mods, leaf = parts[:-1], parts[-1]
    if re.fullmatch(r"bottle\d_x", mods[0]):
        path, rest = [f"{mods[0]}_{mods[1]}"], mods[2:]
    else:
        path, rest = [mods[0]], mods[1:]
    in_up = path[0].endswith("up")
    i = 0
    while i < len(rest):
        name = rest[i]
        if name in ("convm", "resconv", "conv2", "uppool", "convs"):
            idx = int(rest[i + 1])
            if name == "uppool":
                path.append("uppool_conv")
            elif name != "convs":
                path.append(name)
            elif in_up:
                path.append({0: "convs_0", 1: "convs_1", 2: "convs_bn", 4: "convs_2"}[idx])
            else:
                path.append(f"convs_{idx}")
            i += 2
        else:
            path.append(name)
            i += 1
    # a raw Conv2d (no ConvBN around it) still sits under "conv" in flax,
    # apart from the ConvTranspose2d layers
    if kind == "conv" and path[-1] != "conv":
        path.append("conv")
    if leaf in ("running_mean", "running_var"):
        collection, fleaf = "batch_stats", leaf.removeprefix("running_")
    elif leaf == "bias":
        collection, fleaf = "params", "bias"
    elif leaf == "weight":
        collection = "params"
        fleaf = {"conv": "kernel", "convT": "kernel", "bn": "scale", "prelu": "alpha"}[kind]
    else:
        raise KeyError(f"unknown state dict leaf {leaf!r} in {key}")
    path = tuple(path) + (fleaf,)
    back, transform = flax_to_torch_key(path, collection)
    if back != key:
        raise KeyError(f"{key} maps to flax {path}, which maps back to {back}")
    return collection, path, transform


def flax_layout(model: torch.nn.Module) -> dict[str, tuple[str, tuple, str | None]]:
    """``torch_to_flax_key`` of every state-dict entry of ``model`` except
    the ``num_batches_tracked`` counters, in state-dict order."""
    kinds = {torch.nn.ConvTranspose2d: "convT", torch.nn.Conv2d: "conv",
             torch.nn.BatchNorm2d: "bn"}
    out = {}
    for key in model.state_dict():
        if key.endswith("num_batches_tracked"):
            continue
        owner = model.get_submodule(key.rsplit(".", 1)[0])
        kind = next((k for cls, k in kinds.items() if isinstance(owner, cls)), "prelu")
        out[key] = torch_to_flax_key(key, kind)
    return out


def torch_to_flax_tree(tensors: Mapping, layout: Mapping) -> dict:
    """Nest ``tensors`` (state-dict keys -> tensors) into the flax tree of
    ``layout`` (``flax_layout``), as float32 numpy arrays in flax layouts:
    ``{"params": ..., "batch_stats": ...}``; the collections of keys absent
    from ``tensors`` stay empty.  Keys are sorted at every level, as in the
    trees that JAX transformations return (what the JAX trainer saves)."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, (collection, path, transform) in layout.items():
        if key not in tensors:
            continue
        val = np.asarray(tensors[key].detach().cpu().numpy(), np.float32)
        if transform == "conv":
            val = _conv_w(val)
        elif transform == "convT":
            val = _convT_w(val)
        node = out[collection]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(val)
    return {c: _sorted(tree) for c, tree in out.items()}


def _sorted(tree: dict) -> dict:
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}
