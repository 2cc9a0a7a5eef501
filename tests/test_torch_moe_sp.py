"""The expert-sharded step over a sequence axis
(``build_train_step(moe=MoEConfig(...), sp_axis=SeqAxis("sp", 2))``)
against the JAX package's ``build_train_step(moe=, sp_axis="sp")`` on a
4 x 2 ("bf", "sp") CPU mesh, the same numpy-seeded params and tokens:

* ``batch_specs=("bf", "sp")`` splits each rank's tokens into its two
  sequence shards (``[n, 2, B / 2, D]``, JAX's per-device slices), the
  loss runs once over every rank with the axis bound, each shard's
  tokens dispatched over the compiled all-to-all on their own (their
  own capacity), and each rank's loss is its shards' mean (JAX's pmean
  over sp);
* 3 atc steps: the losses and every leaf within 1e-6 of JAX's (f32
  products summed in another order, as
  ``tests/test_torch_moe_dispatch.py``), the expert leaves rank-local
  and the router mixed."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import moe as jmoe
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.topology import RingGraph, uniform_topology_spec
from bluefog_tpu.topology import compiler as jcomp
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import moe as tmoe
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.parallel.collectives import bound_axis
from bluefog_tpu_torch.topology import compiler as tcomp

pytestmark = pytest.mark.moe

N, S, B, D, CAP, LR = 4, 2, 8, 4, 2, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params():
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    per_rank = [jmoe.init_moe_params(k, D, D, N) for k in keys]
    params = jax.tree.map(lambda *xs: np.asarray(jnp.stack(xs)), *per_rank)
    params["router"]["w"] = np.broadcast_to(
        params["router"]["w"][:1], (N, D, N)).copy()
    return params


def _tokens(step):
    return np.random.default_rng(step).normal(size=(N, B, D)).astype(
        np.float32)


def test_moe_step_over_a_sequence_axis_equals_jax():
    plan_j = jmoe.dispatch_plan(jcomp.compile_all_to_all(
        jcomp.PodSpec(2, 2, dcn_cost=4.0)).schedule)
    plan_t = tmoe.dispatch_plan(tcomp.compile_all_to_all(
        tcomp.PodSpec(2, 2, dcn_cost=4.0)).schedule)
    route = tmoe.default_route_table(N, N)
    np.testing.assert_array_equal(route, jmoe.default_route_table(N, N))
    live = tmoe.capacity_mask_of(np.zeros(N, bool))

    def j_loss(params, batch):
        (tokens,) = batch   # this device's sequence shard [B / S, D]
        r = jax.lax.axis_index("bf")
        out, _ = jmoe.moe_apply(params, tokens, jnp.asarray(route)[r],
                                jnp.asarray(live), plan=plan_j,
                                axis_name="bf", capacity=CAP)
        return jnp.mean(jnp.square(out - tokens))

    mesh = Mesh(np.array(jax.devices()[:N * S]).reshape(N, S), ("bf", "sp"))
    opt = optax.sgd(LR)
    step = JF.build_train_step(
        j_loss, opt, mesh, comm_mode="atc",
        topology=uniform_topology_spec(RingGraph(N)),
        moe=JF.MoEConfig(n_experts=N, capacity=CAP), sp_axis="sp",
        batch_specs=P("bf", "sp"))
    jp = _params()
    sh = NamedSharding(mesh, P("bf"))
    p = jax.tree.map(lambda x: jax.device_put(x, sh), jp)
    o = jax.tree.map(lambda x: jax.device_put(x, sh), jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[opt.init(jax.tree.map(lambda l: l[r], jp)) for r in range(N)]))
    j_losses = []
    for s in range(3):
        p, o, loss = step(p, o, (jax.device_put(
            _tokens(s), NamedSharding(mesh, P("bf", "sp"))),),
            jnp.int32(s))
        j_losses.append(np.asarray(loss))

    backend = bt.StackedBackend(N, device="cpu")
    route_t = torch.from_numpy(np.asarray(route, np.int32))
    live_t = torch.from_numpy(np.broadcast_to(live[None], (N, N)).copy())
    seen = []

    def t_loss(params, batch):
        (tokens,) = batch   # every rank's shards, [n, S, B / S, D]
        axis = bound_axis("sp")
        seen.append(tuple(tokens.shape))
        losses = []
        for s in range(axis.size):
            out, _ = tmoe.moe_apply(params, tokens[:, s], route_t, live_t,
                                    plan=plan_t, backend=backend,
                                    capacity=CAP)
            losses.append(torch.square(out - tokens[:, s]).mean(dim=(1, 2)))
        return torch.stack(losses, dim=1)

    params = {"expert.wi": torch.from_numpy(jp["expert"]["wi"].copy()),
              "expert.wo": torch.from_numpy(jp["expert"]["wo"].copy()),
              "router.w": torch.from_numpy(jp["router"]["w"].copy())}
    t_opt = torch.optim.SGD(params.values(), lr=LR)
    t_step = bt.build_train_step(
        t_loss, t_opt, backend, comm_mode="atc",
        topology=TT.uniform_topology_spec(TT.RingGraph(N)),
        moe=bt.MoEConfig(n_experts=N, capacity=CAP),
        sp_axis=bt.SeqAxis("sp", S), batch_specs=("bf", "sp"))
    t_losses = []
    for s in range(3):
        params, t_opt, loss = t_step(params, t_opt,
                                     (torch.from_numpy(_tokens(s)),), s)
        t_losses.append(loss.numpy().copy())
    assert seen[0] == (N, S, B // S, D)
    np.testing.assert_allclose(np.stack(t_losses), np.stack(j_losses),
                               rtol=0, atol=1e-6)
    want = {"expert.wi": p["expert"]["wi"], "expert.wo": p["expert"]["wo"],
            "router.w": p["router"]["w"]}
    for k, w in want.items():
        np.testing.assert_allclose(params[k].numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6, err_msg=k)
    wi = params["expert.wi"].numpy()
    assert not np.allclose(wi[0], wi[1])       # experts stayed local
    rw = params["router.w"].numpy()
    assert np.abs(rw - rw.mean(0)).max() < np.abs(wi - wi.mean(0)).max()
