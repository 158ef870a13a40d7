"""Move JAX-package weights into this package's modules.

``state_dict_from_jax(variables)`` turns the JAX package's flax
``{'params', 'batch_stats'}`` variables — given as nested dicts of numpy
arrays (``jax.device_get`` output) — into a ``state_dict`` in the reference
torch key grammar that :class:`..models.networks.SiameseUNet` loads with
``strict=True``. It is the counterpart of the JAX package's
``torch_port.export_reference_state_dict`` (reference networks.py:313-461),
written here against plain nested dicts:

  * Conv           flax ``[kh, kw, I, O]`` -> torch ``[O, I, kh, kw]``
  * ConvTranspose  flax ``[kh, kw, I, O]`` -> un-flipped taps, then torch
                   ``[I, O, kh, kw]`` (torch's transposed conv correlates
                   with the un-flipped kernel; ``lax.conv_transpose``
                   convolves)
  * BatchNorm      scale/bias -> weight/bias, mean/var ->
                   running_mean/running_var; ``num_batches_tracked``
                   (which flax does not keep) is synthesized as ``step``

``SiamUnetDiff`` keeps the reference's flat names (``conv11`` ...
``upconv4`` ... ``conv43d``, ``conv11d``): its flax modules ``enc{s}_{i}``,
``dec{s}_{k}``, ``upconv{s}`` and ``outc`` map onto them through
:func:`..models.networks.siamunet_diff_flax_names`, the inverse of the JAX
package's ``torch_port._siamunet_diff_key_map``; its decoder convs, its
upsamplers and its head are transposed convs.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .models.networks import siamunet_diff_flax_names

_FLAT_NAMES = siamunet_diff_flax_names()
# torch prefixes of transposed convs: a U-Net decoder's upsampler, and
# SiamUnetDiff's upsamplers, decoder convs and head
_TRANSPOSED = re.compile(r"(.*\.up|upconv\d|conv\d\dd)")

# flax DoubleConv submodule -> torch Sequential index (conv, BN, ReLU, conv,
# BN, ReLU; reference networks.py:392-398)
_DOUBLECONV_IDX = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}
_BN_LEAVES = {("params", "scale"): "weight", ("params", "bias"): "bias",
              ("batch_stats", "mean"): "running_mean",
              ("batch_stats", "var"): "running_var"}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_prefix(path: tuple) -> str:
    """A flax module path (without collection and leaf name) -> the
    reference state_dict prefix of that module."""
    top, rest = path[0], tuple(path[1:])
    if rest == ("conv",):                                    # OutConv
        return f"{top}.conv"
    if len(rest) == 2 and rest[0] == "conv" and rest[1] in _DOUBLECONV_IDX:
        return f"{top}.conv.conv.{_DOUBLECONV_IDX[rest[1]]}"  # InConv
    if len(rest) == 2 and rest[1] == "up":                   # upsample
        return f"{top}.up_seq.{rest[0]}.up"
    if len(rest) == 3 and rest[1] == "conv" and rest[2] in _DOUBLECONV_IDX:
        j = _DOUBLECONV_IDX[rest[2]]
        if rest[0].startswith("down"):                       # Encoder stage
            return f"{top}.down_seq.{rest[0]}.mpconv.1.conv.{j}"
        if rest[0].startswith("up"):                         # Decoder stage
            return f"{top}.up_seq.{rest[0]}.conv.conv.{j}"
    raise KeyError(f"no reference state_dict key for flax module path {path!r}")


def state_dict_from_jax(variables, step: int = 0) -> dict:
    """flax ``{'params', 'batch_stats'}`` (numpy leaves) -> torch
    ``state_dict`` of float32 tensors (``num_batches_tracked`` int64)."""
    out = {}
    bn_prefixes = set()
    for keys, leaf in _leaves(variables):
        coll, mod_path, name = keys[0], keys[1:-1], keys[-1]
        prefix = _FLAT_NAMES.get(tuple(mod_path)) or _torch_prefix(mod_path)
        arr = np.asarray(leaf, dtype=np.float32)
        if mod_path[-1].startswith("bn"):
            bn_prefixes.add(prefix)
            out[f"{prefix}.{_BN_LEAVES[(coll, name)]}"] = arr
        elif name == "kernel":
            if _TRANSPOSED.fullmatch(prefix):   # ConvTranspose2d: un-flip, permute
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            else:                      # Conv2d
                arr = arr.transpose(3, 2, 0, 1)
            out[f"{prefix}.weight"] = arr
        else:
            out[f"{prefix}.bias"] = arr
    state = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in out.items()}
    for prefix in bn_prefixes:
        state[f"{prefix}.num_batches_tracked"] = torch.tensor(step,
                                                              dtype=torch.int64)
    return state
