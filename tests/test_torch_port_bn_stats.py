"""The port's BatchNorm statistics and train-mode BatchNorm against the JAX
side, on the CPU.

* ``bn_stats_reference`` (the plain version the ``bn_stats`` wrapper runs on
  the CPU) against the Pallas probe's own plain reference,
  ``tools/bench_bn_reduce.xla_reduce``, on the same numpy inputs (NCHW in
  the port, NHWC in the probe). ``pallas_reduce`` has no interpret mode, so
  its XLA twin stands for it. Inputs are multiples of 1/16 in [1/16, 2]
  (exact in bf16), so every product and partial sum is exact in float32 and
  the two packages' sums, taken in different orders, agree within rtol 1e-6
  (in fact exactly).
* ``models.batchnorm.BatchNorm2d`` in train mode against flax
  ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: output, running statistics
  and the gradients of input, scale and bias, atol 1e-6 / rtol 1e-5 (float32
  sums in another order). ``torch.nn.BatchNorm2d`` updates the running
  variance with the unbiased batch variance and is shown to miss flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodal_siamese_cd_tpu_torch.models.batchnorm import BatchNorm2d
from multimodal_siamese_cd_tpu_torch.ops import bn_stats

torch.set_num_threads(1)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 17, 19, 3), (3, 7, 9, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_xla_reduce(shape, dtype):
    from conftest import import_tool

    xla_reduce = import_tool("bench_bn_reduce").xla_reduce
    rng = np.random.default_rng(sum(shape))
    dy = (rng.integers(1, 33, shape) / 16).astype(np.float32)
    x = (rng.integers(1, 33, shape) / 16).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = xla_reduce(jnp.asarray(dy, jdt), jnp.asarray(x, jdt))
    for same in (False, True):
        b = dy if same else x
        ours = bn_stats.bn_stats(_nchw(dy).to(tdt), _nchw(b).to(tdt))
        ref = want if not same else xla_reduce(jnp.asarray(dy, jdt),
                                               jnp.asarray(dy, jdt))
        for got, exp in zip(ours, ref):
            assert got.dtype == torch.float32 and got.shape == (shape[-1],)
            np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6)


def _flax_bn(x_nhwc, g_nhwc, scale, bias, mean, var):
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float32)

    def loss(params, x):
        y, upd = bn.apply({"params": params,
                           "batch_stats": {"mean": mean, "var": var}},
                          x, mutable=["batch_stats"])
        return jnp.sum(y * g_nhwc), (y, upd["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            {"scale": scale, "bias": bias}, x_nhwc)
    return y, stats, gx, gp


def _port_bn(module_cls, x_nhwc, g_nhwc, scale, bias, mean, var):
    c = x_nhwc.shape[-1]
    bn = module_cls(c, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    x = _nchw(x_nhwc).requires_grad_()
    y = bn(x)
    (y * _nchw(g_nhwc)).sum().backward()
    return bn, y.detach().numpy().transpose(0, 2, 3, 1), x.grad.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 5, 7, 3), (2, 32, 32, 8)])
def test_train_batchnorm_matches_flax(shape):
    rng = np.random.default_rng(shape[1] * shape[2])
    c = shape[-1]
    x = rng.normal(0.4, 1.3, shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    mean = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)

    y_ref, stats, gx_ref, gp_ref = _flax_bn(x, g, scale, bias, mean, var)
    bn, y, gx = _port_bn(BatchNorm2d, x, g, scale, bias, mean, var)
    tol = dict(atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(y, np.asarray(y_ref), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), **tol)
    np.testing.assert_allclose(gx, np.asarray(gx_ref), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp_ref["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp_ref["bias"]), **tol)
    assert int(bn.num_batches_tracked) == 1

    # the fault this module repairs: torch's BatchNorm2d keeps the UNBIASED
    # batch variance (factor n / (n - 1)) in its running average
    old, _, _ = _port_bn(torch.nn.BatchNorm2d, x, g, scale, bias, mean, var)
    n = shape[0] * shape[1] * shape[2]
    batch_var = (np.asarray(stats["var"]) - 0.9 * var) / 0.1
    np.testing.assert_allclose(old.running_var.numpy(),
                               0.9 * var + 0.1 * batch_var * n / (n - 1), rtol=1e-5)
    assert np.abs(old.running_var.numpy() - np.asarray(stats["var"])).max() > 1e-5


def test_eval_mode_is_torch_batchnorm():
    """Eval mode normalises with the running statistics exactly as
    ``torch.nn.BatchNorm2d`` does, and state dicts are interchangeable."""
    rng = np.random.default_rng(0)
    ours, ref = BatchNorm2d(6), torch.nn.BatchNorm2d(6)
    state = {"weight": rng.uniform(0.5, 1.5, 6), "bias": rng.uniform(-1, 1, 6),
             "running_mean": rng.uniform(-1, 1, 6),
             "running_var": rng.uniform(0.5, 1.5, 6)}
    state = {k: torch.from_numpy(v.astype(np.float32)) for k, v in state.items()}
    state["num_batches_tracked"] = torch.tensor(3)
    ours.load_state_dict(state, strict=True)
    ref.load_state_dict(state, strict=True)
    assert set(ours.state_dict()) == set(ref.state_dict())
    x = torch.from_numpy(rng.normal(size=(2, 6, 5, 7)).astype(np.float32))
    ours.eval()
    ref.eval()
    assert torch.equal(ours(x), ref(x))
    before = ours.running_mean.clone()
    ours(x)
    assert torch.equal(ours.running_mean, before)
