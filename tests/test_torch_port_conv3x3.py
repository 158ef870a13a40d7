"""The port's conv3x3 against the JAX package's, on the CPU.

The plain PyTorch version (what ``ops.conv3x3.conv3x3`` runs for CPU
tensors) is held against the JAX module ``tools/pallas_conv3x3_experiment``:
its XLA reference ``conv3x3_reference`` on bf16-rounded operands, and its
Pallas kernel ``conv3x3_pallas`` in interpret mode, as ``tests/test_ops.py``
runs it. The Pallas kernel needs Cin to be a multiple of 128, so the Cin 64
case zero-pads input and weights to 128 channels for it, as its docstring
asks. The CUDA kernel itself runs only on the card
(``test_torch_port_kernels.py``, and chip_smoke.py phase 3c).

Tolerances: float32 inputs give float32 outputs, atol 1e-4 (float32 sums in
another order); bf16 inputs give bf16 outputs, at most one bf16 ulp of the
reference plus 1e-4 where the sum cancels to near zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import import_tool
from multimodal_siamese_cd_tpu_torch.ops import conv3x3
from test_torch_port_kernels import bf16_ulp

torch.set_num_threads(1)


def _inputs(shape, seed):
    """``tests/test_ops.py``'s draw: images in [0, 1), weights N(0, 0.05²)."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    return x, wt


def _close(got: torch.Tensor, want: np.ndarray, dtype) -> None:
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    g = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(g, want, atol=1e-4, rtol=0)
    else:
        limit = bf16_ulp(torch.from_numpy(want)).numpy() + 1e-4
        assert (np.abs(g - want) <= limit).all(), np.abs(g - want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 64, 128, 16), (2, 16, 24, 64, 32)])
def test_plain_matches_reference_and_pallas(shape, dtype):
    mod = import_tool("pallas_conv3x3_experiment")
    x, w = _inputs(shape, seed=shape[3])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = conv3x3.conv3x3(torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype))

    # the XLA reference on bf16-rounded operands, in the input dtype
    xb = jnp.asarray(x).astype(jnp.bfloat16).astype(jdt)
    wb = jnp.asarray(w).astype(jnp.bfloat16).astype(jdt)
    _close(got, np.asarray(mod.conv3x3_reference(xb, wb), np.float32), dtype)

    # the Pallas kernel (interpret mode), Cin zero-padded to 128
    pad = -shape[3] % 128
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, 0), (0, pad))).astype(jdt)
    wp = jnp.pad(jnp.asarray(w), ((0, 0), (0, 0), (0, pad), (0, 0))).astype(jdt)
    pallas = mod.conv3x3_pallas(xp, wp, tile_rows=16, interpret=True)
    _close(got, np.asarray(pallas, np.float32), dtype)
