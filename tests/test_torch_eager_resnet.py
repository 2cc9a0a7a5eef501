"""The slice as a whole on the CPU: a tiny ResNet (one Bottleneck block,
``pallas_conv1x1=True``) trained 3 steps on 4 ranks through the eager
``bf.*`` API and the optimizer wrappers (ATC, CTA and push-sum) in both
packages, from the same initial parameters (``resnet_params_from_flax``)
and per-rank batches.

The JAX side runs ``bluefog_tpu.init`` over 4 virtual CPU devices, each
rank's forward and backward through ``jax.value_and_grad`` (K1 in
interpret mode, as the JAX package's own tests run it), and its optax
wrappers.  The port runs ``bf.init(size=4, device="cpu")``, each rank's
forward and backward through ``ResNet.apply`` (K1's plain version),
writes ``.grad`` rank-major and calls ``opt.step()`` on its
``torch.optim`` wrapper.  SGD(0.1, momentum 0.9) on both sides.

Tolerance: ``tests/test_torch_train_step.py``'s, 5e-4 of each leaf's
largest entry plus 5e-7 (losses 1e-5): f32 convolutions and reductions
sum in another order on the two sides, and three momentum steps carry it
forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import bluefog_tpu as jbf
import bluefog_tpu_torch as tbf
from bluefog_tpu import optim as JO
from bluefog_tpu import topology as JT
from bluefog_tpu.models import resnet as JR
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.interop import resnet_params_from_flax
from bluefog_tpu_torch.models import resnet as TR

N, B, HW, STEPS = 4, 2, 16, 3
WRAPPERS = {"atc": "DistributedAdaptThenCombineOptimizer",
            "cta": "DistributedNeighborAllreduceOptimizer",
            "push_sum": "DistributedPushSumOptimizer"}


def _setup():
    jm = JR.ResNet(stage_sizes=(1,), block_cls=JR.BottleneckBlock,
                   num_classes=10, num_filters=4, dtype=jnp.float32,
                   pallas_conv1x1=True)
    tm = tbf.ResNet(stage_sizes=(1,), block_cls=TR.BottleneckBlock,
                    num_classes=10, num_filters=4, dtype=torch.float32,
                    pallas_conv1x1=True, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(N, B, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, 10, (N, B)).astype(np.int32)
    v = jax.tree.map(np.asarray,
                     jm.init(jax.random.PRNGKey(0), jnp.asarray(x[0])))
    return jm, tm, x, y, v


_GRAD_FN = {}


def _grad_fn(jm):
    """One jitted per-rank value-and-grad for the module (K1 in interpret
    mode compiles once for the three wrappers)."""
    if "fn" not in _GRAD_FN:
        def loss_fn(p, s, xb, yb):
            logits, upd = jm.apply({"params": p, "batch_stats": s}, xb,
                                   train=True, mutable=["batch_stats"])
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, yb)
            return jnp.mean(ce), upd["batch_stats"]

        _GRAD_FN["fn"] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return _GRAD_FN["fn"]


def _run_jax(jm, x, y, v, which):
    jbf.init(devices=jax.devices()[:N])
    try:
        jbf.set_topology(JT.ExponentialTwoGraph(N))
        grad_fn = _grad_fn(jm)
        params = jax.tree.map(lambda a: jbf.rank_sharded(
            np.broadcast_to(a, (N,) + a.shape).copy()), v["params"])
        stats = [v["batch_stats"]] * N
        opt = getattr(JO, WRAPPERS[which])(optax.sgd(0.1, momentum=0.9))
        state = opt.init(params)
        losses = []
        for _ in range(STEPS):
            grads, step_losses = [], []
            for r in range(N):
                p_r = jax.tree.map(lambda a: a[r], params)
                (loss, stats[r]), g = grad_fn(p_r, stats[r], x[r], y[r])
                grads.append(g)
                step_losses.append(float(loss))
            grads = jax.tree.map(lambda *gs: jbf.rank_sharded(
                jnp.stack(gs)), *grads)
            params, state = opt.step(params, grads, state)
            losses.append(step_losses)
        params = jax.tree.map(np.asarray, params)
        stats = [jax.tree.map(np.asarray, s) for s in stats]
        return params, stats, np.asarray(losses)
    finally:
        jbf.win_free()
        jbf.shutdown()


def _run_port(tm, x, y, v, which):
    tbf.init(size=N, device="cpu")
    try:
        tbf.set_topology(TT.ExponentialTwoGraph(N))
        p0, s0 = resnet_params_from_flax(v, tm, device="cpu")
        params = {k: t.unsqueeze(0).repeat((N,) + (1,) * t.dim())
                  for k, t in p0.items()}
        stats = {k: t.unsqueeze(0).repeat((N,) + (1,) * t.dim())
                 for k, t in s0.items()}
        opt = getattr(tbf, WRAPPERS[which])(
            torch.optim.SGD(params.values(), lr=0.1, momentum=0.9), params)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
        losses = []
        for _ in range(STEPS):
            grads = {k: torch.empty_like(t) for k, t in params.items()}
            step_losses = []
            for r in range(N):
                p_r = {k: t[r].detach().requires_grad_(True)
                       for k, t in params.items()}
                logits, new = tm.apply(p_r, {k: t[r] for k, t in
                                             stats.items()}, xt[r],
                                       train=True)
                loss = F.cross_entropy(logits, yt[r])
                gs = torch.autograd.grad(loss, list(p_r.values()))
                with torch.no_grad():
                    for k, g in zip(p_r, gs):
                        grads[k][r] = g
                    for k, t in new.items():
                        stats[k][r] = t
                step_losses.append(float(loss.detach()))
            for k, t in params.items():
                t.grad = grads[k]
            opt.step()
            losses.append(step_losses)
        ps_sum = (float(opt.ps_weights().sum()) if which == "push_sum"
                  else None)
        return params, stats, np.asarray(losses), ps_sum
    finally:
        tbf.win_free()
        tbf.shutdown()


def _close(got, want, what):
    for k in want:
        w = want[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=5e-4 * scale + 5e-7,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("which", sorted(WRAPPERS))
def test_three_eager_steps_match_jax(which):
    jm, tm, x, y, v = _setup()
    jp, js, jl = _run_jax(jm, x, y, v, which)
    tp, ts, tl, ps_sum = _run_port(tm, x, y, v, which)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    for r in range(N):
        wp, ws = resnet_params_from_flax(
            {"params": jax.tree.map(lambda a: a[r], jp),
             "batch_stats": js[r]}, tm, device="cpu")
        _close({k: t[r] for k, t in tp.items()}, wp, f"rank {r} param")
        _close({k: t[r] for k, t in ts.items()}, ws, f"rank {r} stat")
    assert float(tbf.optim.consensus_distance(tp)) > 0.0
    if which == "push_sum":
        np.testing.assert_allclose(ps_sum, N, rtol=1e-6)
