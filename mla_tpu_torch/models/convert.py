"""Weight bridge between the flat ``.npz`` format and the port's
``state_dict``.

The JAX package writes its weights as one flat ``.npz`` of
``params/<module path>/<leaf>`` and ``batch_stats/<module path>/<leaf>``
arrays (``python -m mla_tpu weights --out``). The port's submodules
carry the flax modules' names, so a flat key maps to a ``state_dict`` key by
rule:

  params/.../kernel  (4-D, conv, HWIO)  -> ....weight  (OIHW)
  params/.../kernel  (2-D, Dense [in, out]) -> ....weight  ([out, in])
  params/.../bias                       -> ....bias
  params/.../scale   (batch / group norm) -> ....weight
  batch_stats/.../mean, var             -> ....running_mean, running_var

A batch norm's ``num_batches_tracked`` has no flat counterpart: import sets
it to 0, export drops it. Both directions are checked against the model's
own ``state_dict``: unknown keys, missing keys and wrong shapes raise.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def params_to_flat(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested param tree -> flat {'a/b/kernel': f32 array} dict."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if hasattr(v, "items"):
            flat.update(params_to_flat(v, f"{key}/"))
        else:
            flat[key] = np.asarray(v, np.float32)
    return flat


def flat_to_params(flat: Mapping) -> Dict:
    """Inverse of :func:`params_to_flat`."""
    params: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return params


def _torch_key(flat_key: str) -> str:
    collection, *path, leaf = flat_key.split("/")
    leaves = {"params": _PARAM_LEAVES, "batch_stats": _STAT_LEAVES}.get(collection)
    if leaves is None or leaf not in leaves or not path:
        raise KeyError(f"unknown flat weight key {flat_key!r}")
    return ".".join(path + [leaves[leaf]])


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:  # conv kernel HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:  # Dense [in, out] -> [out, in]
        return a.T
    return a


def _from_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:  # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


def flat_to_state_dict(flat: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Flat weights -> a complete ``state_dict`` for ``model`` (on the CPU;
    ``load_state_dict`` moves it). Raises on unknown or missing keys and on
    wrong shapes."""
    template = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        tkey = _torch_key(key)
        if tkey not in template:
            raise KeyError(f"flat weight {key!r} ({tkey!r}) has no place in the model")
        arr = np.ascontiguousarray(_to_torch_layout(np.asarray(value, np.float32)))
        if tuple(arr.shape) != tuple(template[tkey].shape):
            raise ValueError(f"flat weight {key!r}: shape {tuple(arr.shape)} does not fit "
                             f"{tkey!r} {tuple(template[tkey].shape)}")
        out[tkey] = torch.from_numpy(arr.copy())
    for tkey, t in template.items():
        if tkey.endswith("num_batches_tracked"):
            out[tkey] = torch.zeros_like(t, device="cpu")
        elif tkey not in out:
            raise KeyError(f"flat weights lack {tkey!r}")
    return out


def state_dict_to_flat(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` -> flat weights, the inverse of
    :func:`flat_to_state_dict`. A 1-D ``weight`` is a norm's scale (conv
    and Dense weights are 4-D and 2-D)."""
    flat: Dict[str, np.ndarray] = {}
    for tkey, t in state_dict.items():
        if tkey.endswith("num_batches_tracked"):
            continue
        prefix, leaf = tkey.rsplit(".", 1)
        path = prefix.replace(".", "/")
        if leaf == "running_mean":
            fkey = f"batch_stats/{path}/mean"
        elif leaf == "running_var":
            fkey = f"batch_stats/{path}/var"
        elif leaf == "weight":
            fkey = f"params/{path}/{'scale' if t.dim() == 1 else 'kernel'}"
        elif leaf == "bias":
            fkey = f"params/{path}/bias"
        else:
            raise KeyError(f"state_dict key {tkey!r} has no flat counterpart")
        arr = t.detach().to("cpu", torch.float32).numpy()
        flat[fkey] = np.ascontiguousarray(_from_torch_layout(arr))
    return flat


def load_flat_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a flat ``.npz`` weight file into {key: f32 array}."""
    with np.load(path) as npz:
        return {k: np.asarray(npz[k], np.float32) for k in npz.files}
