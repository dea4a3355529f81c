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

``torch_vggish_to_flax`` / ``flax_vggish_to_torch`` map a
``torchvggish``-layout state dict (``features`` / ``embeddings`` Sequential
indices) to and from the flax-side VGGish param tree (numpy, the
``params/trunk/...`` part of the flat format):

  features.0  conv1_1   features.3  conv2_1   features.6  conv3_1
  features.8  conv3_2   features.11 conv4_1   features.13 conv4_2
  embeddings.0 fc1_1    embeddings.2 fc1_2    embeddings.4 fc2

Conv kernels transpose OIHW <-> HWIO. The first FC's input ordering depends
on the flatten convention: a plain torch NCHW flatten is (C, H, W), the
flax-side one (H, W, C). ``flatten_order`` takes both ("nchw" for plain
torch models, "nhwc" for torchvggish, which permutes to NHWC before it
flattens, to match the original TF weights).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_CONV_MAP = {
    "features.0": "conv1_1",
    "features.3": "conv2_1",
    "features.6": "conv3_1",
    "features.8": "conv3_2",
    "features.11": "conv4_1",
    "features.13": "conv4_2",
}
_FC_MAP = {
    "embeddings.0": "fc1_1",
    "embeddings.2": "fc1_2",
    "embeddings.4": "fc2",
}
# VGGish's last feature map before the flatten: 6 x 4 spatial, 512 channels
_H, _W, _C = 6, 4, 512

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


def _flat_key(tkey: str, ndim: int) -> str:
    """The flat key of ``state_dict`` key ``tkey`` holding an ``ndim``-D
    tensor. A 1-D ``weight`` is a norm's scale (conv and Dense weights are
    4-D and 2-D)."""
    prefix, leaf = tkey.rsplit(".", 1)
    path = prefix.replace(".", "/")
    if leaf == "running_mean":
        return f"batch_stats/{path}/mean"
    if leaf == "running_var":
        return f"batch_stats/{path}/var"
    if leaf == "weight":
        return f"params/{path}/{'scale' if ndim == 1 else 'kernel'}"
    if leaf == "bias":
        return f"params/{path}/bias"
    raise KeyError(f"state_dict key {tkey!r} has no flat counterpart")


def _flat_shape(shape) -> tuple:
    """A torch-layout shape in the flat (flax) layout."""
    shape = tuple(int(d) for d in shape)
    if len(shape) == 4:  # OIHW -> HWIO
        return (shape[2], shape[3], shape[1], shape[0])
    if len(shape) == 2:
        return (shape[1], shape[0])
    return shape


def flat_shapes(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, tuple]:
    """{flat key: flat-layout shape} of a ``state_dict``, read from the
    tensors' shapes alone (so a model built on the meta device will do)."""
    return {_flat_key(k, t.dim()): _flat_shape(t.shape)
            for k, t in state_dict.items() if not k.endswith("num_batches_tracked")}


def state_dict_to_flat(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` -> flat weights, the inverse of
    :func:`flat_to_state_dict`."""
    flat: Dict[str, np.ndarray] = {}
    for tkey, t in state_dict.items():
        if tkey.endswith("num_batches_tracked"):
            continue
        arr = t.detach().to("cpu", torch.float32).numpy()
        flat[_flat_key(tkey, t.dim())] = np.ascontiguousarray(_from_torch_layout(arr))
    return flat


def load_flat_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a flat ``.npz`` weight file into {key: f32 array}."""
    with np.load(path) as npz:
        return {k: np.asarray(npz[k], np.float32) for k in npz.files}


def _to_np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def torch_vggish_to_flax(state_dict: Mapping, flatten_order: str = "nhwc") -> Dict:
    """torchvggish-layout state dict -> the flax-side VGGish param tree."""
    params: Dict = {}
    for tname, fname in _CONV_MAP.items():
        w = _to_np(state_dict[f"{tname}.weight"])  # [out, in, kh, kw]
        b = _to_np(state_dict[f"{tname}.bias"])
        params[fname] = {"kernel": w.transpose(2, 3, 1, 0).astype(np.float32),
                         "bias": b.astype(np.float32)}
    for tname, fname in _FC_MAP.items():
        w = _to_np(state_dict[f"{tname}.weight"])  # [out, in]
        b = _to_np(state_dict[f"{tname}.bias"])
        k = w.T.astype(np.float32)  # -> [in, out]
        if fname == "fc1_1":
            if flatten_order == "nchw":
                # torch flattened (C, H, W); the flax side flattens (H, W, C)
                k = k.reshape(_C, _H, _W, -1).transpose(1, 2, 0, 3).reshape(_H * _W * _C, -1)
            elif flatten_order != "nhwc":
                raise ValueError(f"unknown flatten_order {flatten_order!r}")
        params[fname] = {"kernel": k, "bias": b.astype(np.float32)}
    return params


def flax_vggish_to_torch(params: Mapping, flatten_order: str = "nhwc") -> Dict:
    """Inverse of :func:`torch_vggish_to_flax`."""
    out: Dict = {}
    for tname, fname in _CONV_MAP.items():
        out[f"{tname}.weight"] = params[fname]["kernel"].transpose(3, 2, 0, 1).copy()
        out[f"{tname}.bias"] = params[fname]["bias"].copy()
    for tname, fname in _FC_MAP.items():
        k = params[fname]["kernel"]
        if fname == "fc1_1" and flatten_order == "nchw":
            k = k.reshape(_H, _W, _C, -1).transpose(2, 0, 1, 3).reshape(_C * _H * _W, -1)
        out[f"{tname}.weight"] = k.T.copy()
        out[f"{tname}.bias"] = params[fname]["bias"].copy()
    return out
