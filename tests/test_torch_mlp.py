"""The port's MLP and MnistNet (bluefog_tpu_torch/models/mlp.py) against
the JAX models (bluefog_tpu/models/mlp.py): the same parameters (the JAX
init, converted by ``interop.mlp_params_from_flax``, conv kernels HWIO to
OIHW) and the same numpy NHWC images give the same logits and the same
gradient of every leaf.  Tolerance 1e-5 of the logits and of each
leaf's largest gradient entry (f32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bluefog_tpu.models import mlp as jmlp
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import mlp_params_from_flax


def _images(seed, n=4):
    return np.random.RandomState(seed).randn(n, 28, 28, 1).astype(
        np.float32)


MODELS = {
    "mlp": (lambda: jmlp.MLP(), lambda: bt.MLP(784, device="cpu")),
    "mlp_wide": (lambda: jmlp.MLP(features=(32, 16, 8, 3)),
                 lambda: bt.MLP(784, (32, 16, 8, 3), device="cpu")),
    "mnist": (lambda: jmlp.MnistNet(), lambda: bt.MnistNet(device="cpu")),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_and_gradients_match_jax(name):
    make_j, make_t = MODELS[name]
    jmodel, model = make_j(), make_t()
    x = _images(0)
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), jnp.asarray(x)))
    model.load_state_dict(mlp_params_from_flax(variables, model,
                                               device="cpu"))
    ref = jmodel.apply(variables, jnp.asarray(x))
    out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)

    n_out = out.shape[1]
    labels = np.arange(4) % n_out

    def jloss(p):
        logp = jax.nn.log_softmax(jmodel.apply(p, jnp.asarray(x)))
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], axis=1))

    jgrads = mlp_params_from_flax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(jloss))(variables)), model,
        device="cpu")
    params = {k: v.requires_grad_(True) for k, v in model.state().items()}
    loss = F.cross_entropy(model.apply(params, torch.from_numpy(x)),
                           torch.from_numpy(labels))
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    assert set(grads) == set(jgrads)
    for k, w in jgrads.items():
        np.testing.assert_allclose(grads[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()) + 1e-9,
                                   err_msg=k)


def test_mnist_dropout_only_when_not_deterministic():
    model = bt.MnistNet(device="cpu")
    x = torch.from_numpy(_images(2))
    assert torch.equal(model(x), model(x, deterministic=True))
    torch.manual_seed(0)
    assert not torch.equal(model(x), model(x, deterministic=False))


def test_converter_refuses_a_tree_of_another_model():
    x = _images(3)
    variables = jax.tree.map(np.asarray, jmlp.MLP().init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    with pytest.raises(ValueError, match="missing"):
        mlp_params_from_flax(variables, bt.MnistNet(device="cpu"),
                             device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mlp_params_from_flax(variables, bt.MLP(100, device="cpu"),
                             device="cpu")
