"""Checkpoint / resume (torch counterpart of
``metalrenderer_tpu.utils.checkpoint``): scenes (instances, materials,
textures), the analyzer and visual states for resuming an audio-reactive
stream mid-way (``engine.renderer.stream_audio_reactive``), framebuffers.

Format, the JAX package's: one ``.npz`` with the leaves as ``leaf_i``
arrays and a JSON ``__manifest__`` holding their count ``n`` (no pickle;
loadable anywhere). The leaves are flattened in the JAX pytree order of the
same class — a dataclass's fields in order, less the fields that are static
there (a material's kind and texture ids, an instance's shadow flags);
tuples and lists in order; dicts by sorted key; ``None`` holds no leaf — so
a checkpoint written by either package restores into the other.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..scene.materials import Material
from ..scene.scene import Instance

# Fields that are static metadata (not leaves) in the JAX pytrees.
STATIC_FIELDS = {Instance: ("cast_shadow", "use_displacement"),
                 Material: ("kind", "texture_id", "normal_map_id")}


def _data_fields(obj):
    static = STATIC_FIELDS.get(type(obj), ())
    return [f.name for f in dataclasses.fields(obj) if f.name not in static]


def flatten(tree):
    """The leaves of ``tree`` in JAX pytree order, and a string of its
    structure."""
    if tree is None:
        return [], "None"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        leaves, parts = [], []
        for name in _data_fields(tree):
            sub, desc = flatten(getattr(tree, name))
            leaves += sub
            parts.append(f"{name}={desc}")
        return leaves, f"{type(tree).__name__}({', '.join(parts)})"
    if isinstance(tree, (tuple, list)):
        leaves, parts = [], []
        for x in tree:
            sub, desc = flatten(x)
            leaves += sub
            parts.append(desc)
        return leaves, ("(%s)" if isinstance(tree, tuple) else "[%s]") \
            % ", ".join(parts)
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, desc = flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {desc}")
        return leaves, "{%s}" % ", ".join(parts)
    return [tree], "*"


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves``."""
    if template is None:
        return None
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            name: _unflatten(getattr(template, name), leaves)
            for name in _data_fields(template)})
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(x, leaves) for x in template)
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    arr = next(leaves)
    if isinstance(template, torch.Tensor):
        return arr.to(template.device)
    if isinstance(template, (bool, int, float)):
        return arr.item()
    return arr


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path, tree):
    """Write the leaves of ``tree`` (tensors on any device, numbers, arrays)
    to ``path`` (.npz) with the manifest."""
    leaves, desc = flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    arrays["__manifest__"] = np.frombuffer(
        json.dumps({"treedef": desc, "n": len(leaves)}).encode(),
        dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_leaves(path):
    """The flat leaves back, in order, as CPU tensors of the stored dtypes.
    Re-assembly uses the caller's structure: ``restore_like(template,
    path)``."""
    with np.load(path) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        return [torch.from_numpy(np.array(data[f"leaf_{i}"]))
                for i in range(manifest["n"])]


def restore_like(template, path):
    """Rebuild ``template``'s structure with the checkpointed leaf values:
    a tensor leaf on the template leaf's device, a number as a number.
    Raises ValueError when the leaf counts differ."""
    leaves = load_leaves(path)
    n = len(flatten(template)[0])
    if n != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template has "
                         f"{n}")
    return _unflatten(template, iter(leaves))
