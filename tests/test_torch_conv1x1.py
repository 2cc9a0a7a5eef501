"""The port's 1x1 convolution with the fused backward (bluefog_tpu_torch/
parallel/conv1x1.py, kernel K1) against the JAX package's
``pallas_conv.conv1x1`` / ``conv1x1_backward``, run as the JAX tests run
them on the CPU (the Pallas kernel in interpret mode).  On CPU tensors
the port's wrapper runs its plain version, so these tests hold the
plain arithmetic, the autograd wiring (stride slicing, dx scatter, the
casts around the kernel) and the launch counter to the reference.

Shapes and tolerances are those of tests/test_pallas_conv.py: forward
within 1e-5, gradients within 1e-4 (f32 sums in another order), and the
bf16 case held to the f32 ground truth within 2e-2 relative (bf16
inputs, f32 accumulation).  The card's kernel is held against the same
plain version in tests/test_torch_cuda_kernels.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluefog_tpu.parallel import pallas_conv as J
from bluefog_tpu_torch.parallel import conv1x1 as T


def _pair(rng, shape, dtype=np.float32, scale=1.0):
    a = (rng.randn(*shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.float32), torch.from_numpy(a)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 32), (1, 14, 14, 64, 24)])
def test_conv1x1_forward_and_grads_match_jax(stride, shape):
    b, h, w_, ci, co = shape
    rng = np.random.RandomState(0)
    jx, tx = _pair(rng, (b, h, w_, ci))
    jw, tw = _pair(rng, (ci, co), scale=0.1)

    jy = J.conv1x1(jx, jw, stride)
    jgx, jgw = jax.grad(lambda x, w: jnp.sum(jnp.sin(J.conv1x1(x, w, stride))),
                        argnums=(0, 1))(jx, jw)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    T.reset_launch_counts()
    ty = T.conv1x1(tx, tw, stride)
    gx, gw = torch.autograd.grad(torch.sin(ty).sum(), (tx, tw))
    assert T.conv1x1_backward.launches == 0   # CPU: the plain version
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    assert gx.shape == tx.shape and gw.shape == tw.shape
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-4,
                               atol=1e-4)
    if stride > 1:   # dx is zero off the stride grid, as the scatter gives
        mask = np.ones((h, w_), bool)
        mask[::stride, ::stride] = False
        assert not gx.numpy()[:, mask].any()


def test_conv1x1_backward_matches_jax_kernel():
    """The fused (dx, dw) against the JAX kernel in interpret mode."""
    rng = np.random.RandomState(1)
    n, ci, co = 64, 16, 8
    jx, tx = _pair(rng, (n, ci))
    jdy, tdy = _pair(rng, (n, co))
    jw, tw = _pair(rng, (ci, co))
    jdx, jdw = J.conv1x1_backward(jx, jdy, jw)
    dx, dw = T.conv1x1_backward(tx, tdy, tw)
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)


def test_conv1x1_bf16_accumulates_f32():
    """bf16 inputs: dw is float32 and within bf16-input error of the f32
    ground truth over 4096 rows, as in the JAX test; dx is bf16 and
    equal to the JAX kernel's within one bf16 ulp."""
    rng = np.random.RandomState(2)
    n, ci, co = 4096, 8, 8
    x = jnp.asarray(rng.randn(n, ci), jnp.bfloat16)
    dy = jnp.asarray(rng.randn(n, co), jnp.bfloat16)
    w = jnp.asarray(rng.randn(ci, co), jnp.bfloat16)
    jdx, jdw = J.conv1x1_backward(x, dy, w)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    dx, dw = T.conv1x1_backward(t(x), t(dy), t(w))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    ref = np.asarray(x, np.float32).T @ np.asarray(dy, np.float32)
    err = np.abs(dw.numpy() - ref) / np.maximum(np.abs(ref), 1e-3)
    assert err.max() < 2e-2, err.max()
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx, np.float32), rtol=2 ** -7,
                               atol=1e-2)


def test_conv1x1_odd_n_tile():
    """N = 98 (a 7x7 map), f32."""
    rng = np.random.RandomState(3)
    b, h, w_, ci, co = 2, 7, 7, 32, 16
    jx, tx = _pair(rng, (b, h, w_, ci))
    jw, tw = _pair(rng, (ci, co), scale=0.1)
    jg = jax.grad(lambda x, w: jnp.sum(J.conv1x1(x, w) ** 2),
                  argnums=(0, 1))(jx, jw)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    gx, gw = torch.autograd.grad((T.conv1x1(tx, tw) ** 2).sum(), (tx, tw))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jg[0]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jg[1]), rtol=1e-4,
                               atol=1e-4)


def test_bf16_weight_gradient_is_cast_to_w_dtype():
    """dy and w are cast to x's type before the kernel and dw back to w's
    type after, as the JAX custom VJP does."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 4, 4, 8).astype(np.float32))
    x = x.to(torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
    w = w.to(torch.bfloat16).requires_grad_(True)
    y = T.conv1x1(x, w, 2)
    assert y.dtype == torch.bfloat16 and y.shape == (1, 2, 2, 16)
    gx, gw = torch.autograd.grad(y.float().sum(), (x, w))
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.bfloat16


@pytest.mark.parametrize("n,ci,co", [(401408, 64, 256), (100352, 256, 512),
                                     (25088, 512, 1024), (6272, 1024, 2048),
                                     (98, 32, 16), (4096, 8, 8)])
@pytest.mark.parametrize("tile", [(128, 64), (64, 128), (128, 128),
                                  (64, 64), (64, 256)])
def test_split_plan_covers_rows_in_fixed_chunks(n, ci, co, tile):
    splits, chunk = T.split_plan(n, ci, co, tile, 132)
    assert chunk % 128 == 0 and splits >= 1
    assert (splits - 1) * chunk < n <= splits * chunk
    assert (splits, chunk) == T.split_plan(n, ci, co, tile, 132)
    if n < 2 * 256:
        assert splits == 1


def test_wrapper_refuses_other_devices():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        T.conv1x1_backward(x, torch.empty(4, 8, device="meta"),
                           torch.empty(8, 8, device="meta"))


@pytest.mark.parametrize("n", [401408, 100352, 6272, 1000, 300])
def test_split_plan_persistent_schedule_covers_n_exactly(n):
    """At the fused kernel's dw tile (all of [64, 256]) the plan is the
    persistent schedule: at most one block per SM, each a contiguous range
    of whole 128-row tiles but the last, the ranges covering [0, N) once
    with none empty."""
    splits, chunk = T.split_plan(n, 64, 256, (64, 256), 132)
    assert splits <= 132 and chunk % 128 == 0
    ranges = [(s * chunk, min(n, (s + 1) * chunk)) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))
    if n >= 132 * 256:
        assert splits >= 128   # every SM but a few holds a block


def test_kernel_dw_order_matches_jax_kernel():
    """K1's order of dw on the card, emulated on the host: one f32
    partial per block of split_plan's persistent schedule (here 16 blocks
    of 256 rows), summed in block order.  It agrees with the JAX kernel in
    interpret mode within phase 2b's dw tolerance, 1e-4 of the largest
    entry, and dx is the plain version's."""
    rng = np.random.RandomState(5)
    n, ci, co = 4096, 64, 256
    x = jnp.asarray(rng.randn(n, ci), jnp.bfloat16)
    dy = jnp.asarray(rng.randn(n, co), jnp.bfloat16)
    w = jnp.asarray(rng.randn(ci, co) * 0.1, jnp.bfloat16)
    jdx, jdw = J.conv1x1_backward(x, dy, w, interpret=True)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    splits, chunk = T.split_plan(n, ci, co, (64, 256), 132)
    assert (splits, chunk) == (16, 256)
    dx, dw = T.conv1x1_backward_split_plain(t(x), t(dy), t(w), splits, chunk)
    jdw = np.asarray(jdw)
    np.testing.assert_allclose(dw.numpy(), jdw, rtol=0,
                               atol=1e-4 * np.abs(jdw).max())
    plain_dx, plain_dw = T.conv1x1_backward_plain(t(x), t(dy), t(w))
    assert torch.equal(dx, plain_dx)
    assert not torch.equal(dw, plain_dw)   # another order of the same sum
