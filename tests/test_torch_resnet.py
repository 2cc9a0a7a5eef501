"""The port's ResNet (bluefog_tpu_torch/models/resnet.py) against the JAX
package's flax ResNet on tiny configs: the JAX init carried over by
``resnet_params_from_flax``, the same numpy images and labels, then
logits, loss, the new batch statistics and every parameter's gradient
compared, in train mode (batch statistics) and eval mode (running
statistics).  Covered: Bottleneck with ``pallas_conv1x1`` on (K1's plain
version on the CPU) and off, Basic blocks, the space-to-depth stem and
the plain stem (odd input, where flax's "SAME" padding is asymmetric at
stride 2).

Tolerances: f32 logits, loss and statistics within 1e-5 (the
convolutions sum in another order; measured ~6e-7); gradients within
1e-4 of each leaf's largest entry.  The bf16 forward is looser, 5e-2 on
the logits: both round activations to bf16 after every layer, at
different places inside the fused ops."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from bluefog_tpu.models import resnet as JR
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import resnet_params_from_flax
from bluefog_tpu_torch.models import resnet as TR

CASES = {
    "bottleneck_pallas": ("Bottleneck", True, True, 32),
    "bottleneck": ("Bottleneck", False, True, 32),
    "bottleneck_pallas_odd": ("Bottleneck", True, True, 33),
    "basic_odd": ("Basic", False, False, 33),
    "basic": ("Basic", False, True, 32),
}


def _models(block, pallas, s2d, hw, jdtype=jnp.float32,
            tdtype=torch.float32, stages=(1, 1)):
    jb = JR.BottleneckBlock if block == "Bottleneck" else JR.BasicBlock
    tb = TR.BottleneckBlock if block == "Bottleneck" else TR.BasicBlock
    jm = JR.ResNet(stage_sizes=stages, block_cls=jb, num_classes=10,
                   num_filters=8, dtype=jdtype, space_to_depth=s2d,
                   pallas_conv1x1=pallas)
    rng = np.random.RandomState(0)
    x = rng.randn(2, hw, hw, 3).astype(np.float32)
    labels = rng.randint(0, 10, (2,))
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))

    # move BN scales/biases and running stats off their init so zero
    # scales and unit variances hide nothing
    def jitter(path, a):
        key = jax.tree_util.keystr(path)
        if any(s in key for s in ("scale", "bias", "mean", "var")):
            a = a + 0.3 * np.abs(rng.randn(*a.shape)) * (
                1 if "var" in key else np.sign(rng.randn(*a.shape)))
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(jitter, v)
    tm = bt.ResNet(stage_sizes=stages, block_cls=tb, num_classes=10,
                   num_filters=8, dtype=tdtype, space_to_depth=s2d,
                   pallas_conv1x1=pallas, device="cpu")
    return jm, v, tm, x, labels


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_mode_logits_stats_and_grads_match_jax(case):
    jm, v, tm, x, labels = _models(*CASES[case])

    def loss(params):
        logits, upd = jm.apply({"params": params,
                                "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels))
        return jnp.mean(ce), (logits, upd["batch_stats"])

    (jl, (jlog, jstats)), jg = jax.value_and_grad(loss, has_aux=True)(
        v["params"])
    params, stats = resnet_params_from_flax(v, tm, device="cpu")
    leaves = {k: t.clone().requires_grad_(True) for k, t in params.items()}
    logits, new_stats = tm.apply(leaves, stats, torch.from_numpy(x),
                                 train=True)
    tl = F.cross_entropy(logits, torch.from_numpy(labels).long())
    grads = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlog),
                               rtol=1e-5, atol=1e-5)
    assert abs(tl.item() - float(jl)) < 1e-5
    jgrads, jnew = resnet_params_from_flax(
        {"params": jax.tree.map(np.asarray, jg),
         "batch_stats": jax.tree.map(np.asarray, jstats)}, tm, device="cpu")
    assert set(new_stats) == set(jnew) == set(stats)
    for k in jnew:
        np.testing.assert_allclose(new_stats[k].numpy(), jnew[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    for k in jgrads:
        scale = max(float(jgrads[k].abs().max()), 1e-6)
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_mode_uses_running_stats(case):
    jm, v, tm, x, _ = _models(*CASES[case])
    want = jm.apply(v, jnp.asarray(x), train=False)
    params, stats = resnet_params_from_flax(v, tm, device="cpu")
    got = tm.apply(params, stats, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the same through load_state_dict and the module's own forward
    tm.load_state_dict({**params, **stats})
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bf16_forward_matches_jax_loosely():
    jm, v, tm, x, _ = _models("Bottleneck", True, True, 32,
                              jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    want, jst = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    params, stats = resnet_params_from_flax(v, tm, device="cpu")
    got, new = tm.apply(params, stats, torch.from_numpy(x), train=True)
    assert got.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in new.values())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-2,
                               atol=5e-2)


def test_cross_naming_carry():
    """A tree from the nn.Conv layout (``Conv_2``) loads into a
    ``pallas_conv1x1`` model (``_PallasConv1x1_0``) and back, with the
    same function."""
    jm, v, tm, x, _ = _models("Bottleneck", False, True, 32)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tk = bt.ResNet(stage_sizes=(1, 1), block_cls=TR.BottleneckBlock,
                   num_classes=10, num_filters=8, dtype=torch.float32,
                   pallas_conv1x1=True, device="cpu")
    params, stats = resnet_params_from_flax(v, tk, device="cpu")
    assert "BottleneckBlock_0._PallasConv1x1_0.kernel" in params
    assert "BottleneckBlock_0.conv_proj.kernel" in params
    np.testing.assert_allclose(tk.apply(params, stats, torch.from_numpy(x))
                               .numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="missing"):
        resnet_params_from_flax({"params": {}, "batch_stats": {}}, tk,
                                device="cpu")


def test_resnet50_layout_and_k1_sites():
    """ResNet-50's parameter count and the 20 K1 sites per forward: 16
    expansions and 4 projections."""
    m = bt.ResNet50(num_classes=1000, pallas_conv1x1=True, device="cpu")
    n = sum(p.numel() for p in m.parameters())
    assert n == 25_557_032
    k1 = [name for name, mod in m.named_modules()
          if isinstance(mod, TR.PallasConv1x1)]
    assert len(k1) == 20
    assert sum(name.endswith("conv_proj") for name in k1) == 4
    jm = JR.ResNet50(num_classes=1000, pallas_conv1x1=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3), jnp.float32))
    jn = sum(int(np.prod(s.shape))
             for s in jax.tree.leaves(shapes["params"]))
    assert jn == n
