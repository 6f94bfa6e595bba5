"""Keras h5 weight import for the U-Net checkpoints.

Port of ``tissue_image_processing_tpu/models/weights_io.py``: a Keras
``model.save_weights`` h5 file is mapped onto the ``state_dict`` of the
port's :class:`~.unet.UNet` by layer order. Keras creates its ``conv2d*``,
``conv2d_transpose*`` and ``batch_normalization*`` layers in the order the
U-Net creates its double convs (down, bottleneck, up), transposed convs and
head, so sorting each family by its numeric suffix pairs them up.

Layouts. A Keras conv kernel is ``(h, w, in, out)``; PyTorch's
``(out, in, h, w)`` is its transpose. A Keras ``Conv2DTranspose`` kernel is
``(h, w, out, in)`` in the gradient-of-conv convention, which is the
convention of ``F.conv_transpose2d`` (tap k lands at output 2i + k, cropped
like Keras' SAME): the JAX loader flips it spatially on its way to Flax and
``utils/state.py:unet_state_from_flax`` flips it back, so here the kernel is
only transposed to ``(in, out, h, w)``, with no flip.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from tissue_image_processing_tpu_torch.models.unet import UNet

__all__ = ["keras_layer_arrays", "keras_arrays_to_state",
           "load_keras_unet_weights"]

_BN_NAMES = ("gamma", "beta", "moving_mean", "moving_variance")
_BN_TO_TORCH = {"gamma": "weight", "beta": "bias",
                "moving_mean": "running_mean", "moving_variance": "running_var"}


def _layer_sort_key(name: str) -> Tuple[str, int]:
    m = re.match(r"^(.*?)(?:_(\d+))?$", name)
    base, idx = m.group(1), m.group(2)
    return base, int(idx) if idx else 0


def keras_layer_arrays(h5_path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Every layer's weight arrays of a Keras h5 checkpoint: layer name ->
    {short weight name ('kernel', 'bias', 'gamma', ...) -> array}. Reads the
    ``model_weights/<layer>/.../<name>:0`` layout and the Keras 3
    ``layers/<name>/vars/<index>`` one."""
    import h5py

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        if "layers" in root and "vars" in root:
            root = root["layers"]  # Keras 3: layers/<name>/vars/<index>
        for layer_name in root:
            ordered = []

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    short = name.split("/")[-1].split(":")[0]
                    ordered.append((short, np.array(obj)))

            root[layer_name].visititems(visit)
            if not ordered:
                continue
            if all(s.isdigit() for s, _ in ordered):
                # Keras 3 stores anonymous vars/0..n in variable order
                vals = [a for _, a in sorted(ordered, key=lambda t: int(t[0]))]
                names = (_BN_NAMES if layer_name.startswith("batch_normalization")
                         else ("kernel", "bias"))
                out[layer_name] = dict(zip(names, vals))
            else:
                out[layer_name] = dict(ordered)
    return out


def load_keras_unet_weights(model_or_state: Union[UNet, Mapping[str, torch.Tensor]],
                            h5_path: str) -> Dict[str, torch.Tensor]:
    """Map a Keras U-Net h5 checkpoint onto the port's ``UNet`` (``norm=
    "bn"``, ``up_kind="convt"``): ``model_or_state`` is the model or its
    ``state_dict``, which sets the expected names and shapes. Returns the
    new ``state_dict`` (float32, on the CPU); a model is loaded with it too.
    Raises ``ValueError`` when the layer counts or a shape do not match."""
    return keras_arrays_to_state(keras_layer_arrays(h5_path), model_or_state)


def keras_arrays_to_state(layers: Mapping[str, Mapping[str, np.ndarray]],
                          model_or_state: Union[UNet, Mapping[str, torch.Tensor]]
                          ) -> Dict[str, torch.Tensor]:
    """The mapping of :func:`load_keras_unet_weights` on layer arrays already
    read (layer name -> {weight name -> array}, as
    :func:`keras_layer_arrays` returns them)."""
    model = model_or_state if isinstance(model_or_state, UNet) else None
    template = dict(model.state_dict() if model is not None else model_or_state)

    def family(prefix, transposed):
        names = [n for n in layers if n.startswith(prefix)
                 and ("transpose" in n) == transposed]
        return sorted(names, key=_layer_sort_key)

    convs, tconvs = family("conv2d", False), family("conv2d_transpose", True)
    bns = family("batch_normalization", False)
    n_blocks = sum(1 for k in template if k.endswith(".conv0.weight"))
    depth = (n_blocks - 1) // 2
    conv_keys = [f"blocks.{k}.conv{i}" for k in range(n_blocks)
                 for i in (0, 1)] + ["head"]
    bn_keys = [f"blocks.{k}.bn{i}" for k in range(n_blocks) for i in (0, 1)]
    up_keys = [f"ups.{j}" for j in range(depth)]
    if (len(convs), len(bns), len(tconvs)) != (len(conv_keys), len(bn_keys),
                                               len(up_keys)):
        raise ValueError(
            f"layer count mismatch: keras convs={len(convs)} port="
            f"{len(conv_keys)}, bns={len(bns)}/{len(bn_keys)}, "
            f"tconvs={len(tconvs)}/{len(up_keys)}")

    state = {k: v.detach().to("cpu", copy=True) for k, v in template.items()}

    def assign(key, value: np.ndarray):
        if key not in state:
            raise KeyError(f"{key} is not in the U-Net's state_dict")
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"shape mismatch at {key}: keras {value.shape} vs "
                             f"port {tuple(state[key].shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(value, np.float32))

    for name, key in zip(convs, conv_keys):
        assign(f"{key}.weight", np.transpose(layers[name]["kernel"], (3, 2, 0, 1)))
        assign(f"{key}.bias", layers[name]["bias"])
    for name, key in zip(tconvs, up_keys):
        assign(f"{key}.weight", np.transpose(layers[name]["kernel"], (3, 2, 0, 1)))
        assign(f"{key}.bias", layers[name]["bias"])
    for name, key in zip(bns, bn_keys):
        for k_name, t_name in _BN_TO_TORCH.items():
            assign(f"{key}.{t_name}", layers[name][k_name])
    if model is not None:
        model.load_state_dict(state)
    return state
