"""The PyTorch port's SiameseUNet against the JAX package's, from one set of
weights.

JAX side: ``create_network`` + ``init_variables`` at ``TRAINER.PRECISION
fp32`` and ``MODEL.PACKED_FULLRES False`` (the reference-shaped graph),
with numpy-seeded random weights AND random BatchNorm running statistics
(default 0/1 statistics would make BN the identity and hide mix-ups). The
port gets the same variables through ``weights.state_dict_from_jax`` and
``load_state_dict(strict=True)``. Both run eval-mode fp32 forwards on the
same numpy inputs on the CPU.

Tolerance: probabilities within atol 1e-5 (fp32 convolutions summed in a
different order by XLA and by PyTorch's CPU kernels; measured differences
are ~1e-7), logits within atol/rtol 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_siamese_cd_tpu import torch_port
from multimodal_siamese_cd_tpu.config import load_cfg as jax_load_cfg
from multimodal_siamese_cd_tpu.models import create_network as jax_create_network
from multimodal_siamese_cd_tpu.models import init_variables
from multimodal_siamese_cd_tpu_torch.config import load_cfg
from multimodal_siamese_cd_tpu_torch.models import blocks, factory
from multimodal_siamese_cd_tpu_torch.models.networks import SiameseUNet
from multimodal_siamese_cd_tpu_torch.train_lib import eval_forward
from multimodal_siamese_cd_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)


def _cfgs(topology):
    jcfg = jax_load_cfg("siamese")
    tcfg = load_cfg("siamese")
    for cfg in (jcfg, tcfg):
        cfg.MODEL.TOPOLOGY = list(topology)
        cfg.TRAINER.PRECISION = "fp32"
        cfg.MODEL.PACKED_FULLRES = False
    return jcfg, tcfg


def _random_variables(model, cfg, seed):
    """Random kernels (He-scaled so activations neither vanish nor blow up
    through the depth), biases, BN affine AND running statistics."""
    # shapes only: tracing init is far cheaper than running it on the CPU
    variables = jax.eval_shape(
        lambda: init_variables(model, cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def rnd(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(leaf.shape[:-1])
            return (rng.normal(size=leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.uniform(-0.2, 0.2, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(rnd, variables)


def _both_models(topology, seed=3):
    jcfg, tcfg = _cfgs(topology)
    jmodel = jax_create_network(jcfg)
    variables = _random_variables(jmodel, jcfg, seed)
    tmodel = factory.create_network(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("topology,h,w", [
    ([8, 16], 68, 76),
    ([8, 16], 33, 47),
    ([8, 16, 32, 64], 33, 47),
    ([8, 16, 32, 64], 68, 76),
    ([64, 128, 256, 512], 64, 72),
])
def test_eval_forward_matches_jax(topology, h, w):
    """Odd sizes exercise floor pooling and the pad-to-skip split."""
    jmodel, variables, tmodel = _both_models(topology)
    rng = np.random.default_rng(h * w)
    x1 = rng.uniform(0, 1, (2, h, w, 6)).astype(np.float32)
    x2 = rng.uniform(0, 1, (2, h, w, 6)).astype(np.float32)

    j_logits = np.asarray(jax.jit(
        lambda v, a, b: jmodel.apply(v, a, b, train=False))(variables, x1, x2))
    j_probs = np.asarray(jax.nn.sigmoid(j_logits))
    t1 = torch.from_numpy(x1.transpose(0, 3, 1, 2).copy())
    t2 = torch.from_numpy(x2.transpose(0, 3, 1, 2).copy())
    t_probs = eval_forward(tmodel, t1, t2)
    with torch.inference_mode():
        t_logits = tmodel(t1, t2)

    assert t_probs.shape == (2, 1, h, w) and t_probs.dtype == torch.float32
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy()[:, 0], j_logits[..., 0],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_probs.numpy()[:, 0], j_probs[..., 0], atol=1e-5)
    # the comparison is not vacuous: probabilities spread across the range
    assert j_probs.std() > 0.01


@pytest.mark.parametrize("topology", [[8, 16], [8, 16, 32, 64], [64, 128, 256, 512]])
def test_converter_matches_export_reference_state_dict(topology):
    """Same keys and values as the JAX package's own exporter; the port
    loads them strictly."""
    jcfg, tcfg = _cfgs(topology)
    jmodel = jax_create_network(jcfg)
    variables = _random_variables(jmodel, jcfg, seed=5)
    ours = state_dict_from_jax(variables, step=9)
    ref = torch_port.export_reference_state_dict(variables, step=9)
    assert set(ours) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)
    tmodel = factory.create_network(tcfg, device="cpu")
    result = tmodel.load_state_dict(ours, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(tmodel.state_dict()) == set(ref)


def test_fresh_init_is_lecun_normal_with_zero_bias():
    """Documented init choice: flax's lecun_normal kernels (truncated at 2
    std of the untruncated draw), zero biases; one seed, one set of
    weights."""
    model = SiameseUNet((16, 32), 6, generator=torch.Generator().manual_seed(0))
    again = SiameseUNet((16, 32), 6, generator=torch.Generator().manual_seed(0))
    for (name, p), (_, q) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(p, q), name
    convs = [m for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    assert len(convs) == 2 + 2 * 2 + 2 * 3 + 1   # inc, 2 down, 2 up (convT + 2), outc
    for m in convs:
        w = m.weight.detach()
        in_ch = w.shape[1] if isinstance(m, torch.nn.Conv2d) else w.shape[0]
        std = (1.0 / (in_ch * w.shape[2] * w.shape[3])) ** 0.5
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
        if w.numel() >= 1000:   # the truncated draw has the target variance
            assert abs(float(w.std()) / std - 1) < 0.15
        assert torch.count_nonzero(m.bias) == 0


def test_factory_contract():
    cfg = load_cfg("siamese")
    assert factory.input_channels(cfg) == 6          # bands, not IN_CHANNELS (3)
    assert factory.compute_dtype(cfg) == torch.bfloat16
    cfg.TRAINER.PRECISION = "fp32"
    assert factory.compute_dtype(cfg) == torch.float32
    cfg.MODEL.PACKED_FULLRES = True                  # accepted and ignored
    model = factory.create_network(cfg, device="cpu")
    assert model.compute_dtype == torch.float32
    assert next(model.parameters()).dtype == torch.float32
    assert blocks.encoder_widths([64, 128, 256, 512]) == [128, 256, 512, 512]
    assert blocks.decoder_up_topology([64, 128, 256, 512]) == [64, 128, 256, 512, 512]
    cfg.MODEL.TYPE = "siamunet_diff"      # every type of the JAX factory builds
    model = factory.create_network(cfg, device="cpu")
    assert type(model).__name__ == "SiamUnetDiff"
    # input channels from the bands, fixed published widths whatever TOPOLOGY
    assert model.conv11.in_channels == 6 and model.conv43.out_channels == 128
    assert model.conv11d.out_channels == 1
    cfg.MODEL.TYPE = "no_such_model"
    with pytest.raises(NotImplementedError, match="no_such_model"):
        factory.create_network(cfg, device="cpu")
