"""Carry weights from the JAX package's param trees into the port.

`load_jax_params(module, tree, state=None)` takes a JAX param pytree as
nested dicts/lists of numpy arrays (what `jax.tree.map(np.asarray, params)`
gives) and fills the port module whose attributes follow the same keys:

  conv "w" (HWIO) → weight (OIHW);  dense "w" (out, in) → weight;
  norm "g" → weight;  "b" → bias;   a bare array → the parameter of that name;
  any other key of a dict of arrays (BatchNorm's "mean", "var") → the
  parameter of that name.

An integer scalar (a Python int, or its 0-d numpy form) in a dict of the
tree is static structure, not a weight (a RepVGG layer's "stride" and
"groups"): it must equal the module's attribute of that name (a conv's
(s, s) tuple counts as s), and loads nothing.

A quantized leaf of `ops/quant.py` in JAX, {"q": int8, "s": fp32 (out,)[,
"a": scalar]} in place of "w", replaces the layer's weight with a
`QuantizedWeight` holding the same codes and scales (a conv's q from HWIO to
OIHW, still int8), so a tree quantized and calibrated in JAX carries over
as it is.

`state` (the BatchNorm running statistics of IResNet, MobileFaceNet and the
face ViT's head) is merged into the tree key by key first. It is strict: a
shape that differs, a key the module lacks, or a parameter the tree leaves
unfilled raises. `jax_tree_to_torch`
carries a JAX `init_lora` tree into the port's LoRA tree, and
`export_jax_params(module)` is the inverse of `load_jax_params`: the
(params, state) trees of numpy arrays a JAX `init` would hold (what an FR
checkpoint stores). No JAX is imported: this walks dicts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..ops.quant import QuantizedWeight, is_quantized

_LEAF_NAMES = {"w": "weight", "g": "weight", "b": "bias"}


def _tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 has no torch.from_numpy route
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _copy(param: nn.Parameter, arr, path: str, filled: set) -> None:
    t = _tensor(arr)
    if t.dim() == 4:
        t = t.permute(3, 2, 0, 1)  # HWIO → OIHW
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{path}: tree shape {tuple(t.shape)} != module shape {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(t)
    filled.add(id(param))


def _is_quantized_leaf(node) -> bool:
    return (isinstance(node, dict) and {"q", "s"} <= set(node) <= {"q", "s", "a"}
            and getattr(node["q"], "dtype", None) == np.int8)


def _quantized(mod, node: dict, path: str, filled: set) -> None:
    q = torch.from_numpy(np.array(node["q"]))
    if q.dim() == 4:
        q = q.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)  # HWIO → OIHW
    w = getattr(mod, "weight", None)
    if tuple(q.shape) != tuple(getattr(w, "shape", ())):
        raise ValueError(f"{path}: quantized shape {tuple(q.shape)} != module shape {tuple(getattr(w, 'shape', ()))}")
    device = w.q.device if is_quantized(w) else w.device
    a = node.get("a")
    if isinstance(w, nn.Parameter):
        del mod.weight  # a registered parameter cannot be reassigned a module
    mod.weight = QuantizedWeight(q.to(device), _tensor(node["s"]).float().to(device),
                                 None if a is None else float(np.asarray(a)))
    filled.add(id(mod.weight))


def _is_leaf(node: dict) -> bool:
    """A dict of arrays ({"w"/"g", "b"}, BatchNorm's {"g", "b", "mean",
    "var"}): one layer's parameters."""
    return bool(node) and all(hasattr(v, "__array__") for v in node.values())


def _static(mod, node: dict, path: str) -> dict:
    """`node` without its Python-int entries, each checked against `mod`."""
    rest = {}
    for key, value in node.items():
        if isinstance(value, (bool, dict, list, tuple)) or not (isinstance(value, int) or (
                np.ndim(value) == 0 and np.issubdtype(np.asarray(value).dtype, np.integer))):
            rest[key] = value
            continue
        value = int(value)
        have = getattr(mod, key, None)
        if isinstance(have, tuple) and len(set(have)) == 1:
            have = have[0]
        if have != value:
            raise ValueError(f"{path}.{key}: tree has {value}, module has {have}")
    return rest


def _walk(mod, node, path: str, filled: set) -> None:
    if node is None or mod is None:
        if node is not None or mod is not None:
            raise ValueError(f"{path}: tree has {type(node).__name__}, module has {type(mod).__name__}")
        return
    if isinstance(node, (list, tuple)):
        if len(node) != len(mod):
            raise ValueError(f"{path}: tree has {len(node)} entries, module {len(mod)}")
        for i, sub in enumerate(node):
            _walk(mod[i], sub, f"{path}.{i}", filled)
        return
    if isinstance(node, dict):
        node = _static(mod, node, path)
    if isinstance(node, dict) and _is_quantized_leaf(node.get("w")):
        _quantized(mod, node["w"], f"{path}.w", filled)
        node = {k: v for k, v in node.items() if k != "w"}
    if isinstance(node, dict) and _is_leaf(node):
        for key, arr in node.items():
            name = _LEAF_NAMES.get(key, key)
            if not isinstance(getattr(mod, name, None), nn.Parameter):
                raise KeyError(f"{path}.{key}: the module has no parameter {name!r}")
            _copy(getattr(mod, name), arr, f"{path}.{key}", filled)
        return
    if isinstance(node, dict):
        for key, sub in node.items():
            if not hasattr(mod, key):
                raise KeyError(f"{path}.{key}: the module has no such attribute")
            child = getattr(mod, key)
            if isinstance(child, nn.Parameter):
                _copy(child, sub, f"{path}.{key}", filled)
            else:
                _walk(child, sub, f"{path}.{key}", filled)
        return
    raise TypeError(f"{path}: unexpected tree node {type(node).__name__}")


def _merge(tree, state, path: str):
    if state is None:
        return tree
    if isinstance(tree, dict) and isinstance(state, dict):
        out = dict(tree)
        for key, sub in state.items():
            out[key] = _merge(tree.get(key), sub, f"{path}.{key}") if key in tree else sub
        return out
    if isinstance(tree, (list, tuple)) and isinstance(state, (list, tuple)) and len(tree) == len(state):
        return [_merge(a, b, f"{path}.{i}") for i, (a, b) in enumerate(zip(tree, state))]
    raise ValueError(f"{path}: the state does not follow the param tree")


def load_jax_params(module: nn.Module, tree, state=None) -> nn.Module:
    """Fill every parameter of `module` from the JAX param tree `tree` (and
    the state tree `state`, merged into it). A module with a
    `jax_tree_layout(tree, state)` method first rewrites the trees into its
    own attribute layout."""
    if hasattr(module, "jax_tree_layout"):  # a model whose JAX tree carries structure (MobileFaceNet's stages)
        tree, state = module.jax_tree_layout(tree, state)
    tree = _merge(tree, state, type(module).__name__)
    filled: set = set()
    _walk(module, tree, type(module).__name__, filled)
    missing = [n for n, p in module.named_parameters() if id(p) not in filled]
    missing += [n for n, m in module.named_modules() if is_quantized(m) and id(m) not in filled]
    if missing:
        raise KeyError(f"parameters not in the tree: {missing[:8]}{' …' if len(missing) > 8 else ''}")
    return module


def jax_tree_to_torch(tree, device=None, dtype: torch.dtype = None):
    """The same nested dicts/lists with each array as a tensor (e.g. a JAX
    `init_lora` tree → the port's LoRA tree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: jax_tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_torch(v, device, dtype) for v in tree]
    return _tensor(tree).to(device=device, dtype=dtype)


_STATE_NAMES = ("mean", "var")  # BatchNorm's running statistics: JAX's state, not its params


def export_jax_params(module: nn.Module):
    """(params, state): `module`'s parameters as the JAX trees hold them,
    numpy arrays in fp32 (a conv weight HWIO, a dense one (out, in), a norm
    weight "g", biases "b", a ModuleList a list), the running statistics
    ("mean", "var") in the state tree."""

    def walk(mod):
        params, state = {}, {}
        for name, p in mod.named_parameters(recurse=False):
            arr = p.detach().float().cpu().numpy()
            if name in _STATE_NAMES:
                state[name] = arr
                continue
            if name == "weight":
                dense = isinstance(mod, (nn.Conv2d, nn.Linear))
                params["w" if dense else "g"] = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr
            else:
                params["b" if name == "bias" else name] = arr
        for name, child in mod.named_children():
            if isinstance(child, nn.ModuleList):
                pairs = [walk(c) for c in child]
                params[name] = [p for p, _ in pairs]
                if any(s for _, s in pairs):
                    state[name] = [s for _, s in pairs]
            else:
                p, s = walk(child)
                if p:
                    params[name] = p
                if s:
                    state[name] = s
        return params, state

    return walk(module)
