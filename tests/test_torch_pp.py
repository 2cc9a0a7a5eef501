"""Pipeline parallelism of the port (``llama_pp_loss_fn``,
``build_train_step(pp_axis=)``, ``llama_circular_layout``,
``llama_param_specs(pp_axis=)``) held to the JAX package's
``tests/test_pp.py`` contracts, on the same weights
(``llama_params_from_flax`` of JAX's scanned tree) and numpy-seeded
tokens:

* the per-rank losses of the first step at ``n_micro`` 1, 2 and 4 (dp 2 x
  pp 4) against JAX's pp step (``n_micro`` 2) and JAX's unsharded model;
* the one-step SGD update, leaf by leaf, layer stacks and the
  pp-replicated embedding, norm and head, against JAX's pp step;
* dp 4 x pp 2 under atc against JAX's dp-only atc step, after 2 steps;
* the circular schedule (2 stages x 2 loops, 4 microbatches): the layout
  round trip exact, the loss and the update (compared back in natural
  order) against JAX's;
* the specs: the leaves marked stage-owned are the leaves JAX shards over
  pp, name for name; the step's and the builder's errors are JAX's.

Tolerances are JAX's: 1e-5 for losses, 2e-5 for updates, 3e-5 after the
2 atc steps.  JAX's programs are built once for the module."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bluefog_tpu import models as jm
from bluefog_tpu.models.llama import (llama_param_specs as j_specs,
                                      llama_pp_loss_fn as j_pp_loss)
from bluefog_tpu.optim import functional as JF
from bluefog_tpu.topology import RingGraph, uniform_topology_spec
import bluefog_tpu_torch as bt
from bluefog_tpu_torch import topology as TT
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.llama import (llama_circular_layout,
                                            llama_param_specs,
                                            llama_pp_loss_fn)
from bluefog_tpu_torch.optim import functional as TF

B, T, L = 4, 16, 4
LR = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: its many tiny torch ops
    otherwise wait on torch's spinning thread pool whenever the host is
    shared (by the test run's other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcfg():
    return jm.LlamaConfig.tiny(dtype=jnp.float32, n_layers=L,
                               scan_layers=True)


def _tcfg(**over):
    return bt.LlamaConfig.tiny(dtype=torch.float32, n_layers=L,
                               scan_layers=True, **over)


def _data(n_bf, seed=0):
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, size=(n_bf, B, T + 1)).astype(np.int32)
    return raw[:, :, :-1], raw[:, :, 1:]


_REF = {}


def _ref():
    """JAX's side, built once: the variables, JAX's pp step (dp 2 x pp 4,
    n_micro 2, SGD) losses and updated params, the unsharded losses, and
    JAX's dp-only atc step (4 ranks, RingGraph) after 2 steps."""
    if _REF:
        return _REF
    cfg = _jcfg()
    model = jm.Llama(cfg)
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((B, 8), jnp.int32)))
    opt = optax.sgd(LR)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("bf", "pp"))
    specs = j_specs(variables, tp_axis=None, ep_axis=None, pp_axis="pp")
    ospecs = JF.optax_state_specs(opt, variables, specs)
    step = JF.build_train_step(
        j_pp_loss(cfg, pp_axis="pp", n_stages=4, n_micro=2), opt, mesh,
        comm_mode="none", pp_axis="pp", batch_specs=P("bf"),
        param_specs=specs, opt_state_specs=ospecs, donate=False)
    inp, tgt = _data(2)
    sh = NamedSharding(mesh, P("bf"))
    new, _, loss = step(JF.rank_major(variables, mesh, specs=specs),
                        JF.rank_major(opt.init(variables), mesh,
                                      specs=ospecs),
                        (jax.device_put(inp, sh), jax.device_put(tgt, sh)),
                        jnp.int32(0))

    def plain(v, i, t):
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            model.apply(v, i), t))

    unsharded = [float(jax.jit(plain)(variables, inp[r], tgt[r]))
                 for r in range(2)]

    mesh_dp = Mesh(np.array(jax.devices()[:4]), ("bf",))
    step_dp = JF.build_train_step(
        lambda v, b: plain(v, b[0], b[1]), opt, mesh_dp, comm_mode="atc",
        topology=uniform_topology_spec(RingGraph(4)))
    p_dp = JF.rank_major(variables, mesh_dp)
    o_dp = JF.rank_major(opt.init(variables), mesh_dp)
    inp4, tgt4 = _data(4)
    sh4 = NamedSharding(mesh_dp, P("bf"))
    for s in range(2):
        p_dp, o_dp, _ = step_dp(p_dp, o_dp, (jax.device_put(inp4, sh4),
                                             jax.device_put(tgt4, sh4)),
                                jnp.int32(s))
    _REF.update(variables=variables, loss=np.asarray(loss),
                unsharded=np.asarray(unsharded),
                new=jax.tree.map(np.asarray, new),
                atc=jax.tree.map(np.asarray, p_dp))
    return _REF


def _state(variables, cfg=None):
    cfg = cfg or _tcfg()
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, cfg,
                                                 device="cpu"))
    return model, model.state(release=True)


def _port(variables, n_ranks, n_stages, n_micro, comm_mode="none",
          n_loops=1, backend=None, **kw):
    """The port's pp step over ``n_ranks`` stacked ranks (or
    ``backend``'s): (step, params, optimizer)."""
    _, state = _state(variables)
    if n_loops > 1:
        state = llama_circular_layout(state, n_stages, n_loops)
    backend = backend or bt.StackedBackend(n_ranks, device="cpu")
    specs = llama_param_specs(state, tp_axis=None, ep_axis=None,
                              pp_axis="pp")
    params = bt.rank_major(state, backend, specs=specs)
    opt = torch.optim.SGD(params.values(), lr=LR)
    step = bt.build_train_step(
        llama_pp_loss_fn(_tcfg(), pp_axis="pp", n_stages=n_stages,
                         n_micro=n_micro, n_loops=n_loops),
        opt, backend, comm_mode=comm_mode,
        pp_axis=bt.MeshAxis("pp", n_stages), param_specs=specs,
        opt_state_specs=TF.optax_state_specs(opt, state, specs), **kw)
    return step, params, opt


def _batch(n):
    inp, tgt = _data(n)
    return torch.from_numpy(inp), torch.from_numpy(tgt)


def _rank_tree(tree, r, cfg=None):
    """Rank ``r`` of JAX's rank-major tree, as the port's state dict."""
    return llama_params_from_flax(jax.tree.map(lambda l: l[r], tree),
                                  cfg or _tcfg(), device="cpu")


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pp_loss_matches_jax(n_micro):
    """dp 2 x pp 4: each rank's first-step loss equals JAX's pp step's
    and JAX's unsharded model's."""
    ref = _ref()
    step, params, opt = _port(ref["variables"], 2, 4, n_micro)
    _, _, loss = step(params, opt, _batch(2), 0)
    np.testing.assert_allclose(loss.numpy(), ref["loss"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), ref["unsharded"], rtol=1e-5,
                               atol=1e-5)


def test_pp_one_step_update_matches_jax():
    """One SGD step under pp equals JAX's pp step leaf by leaf: the
    stage-owned layers and the pp-replicated embedding, norm and head."""
    ref = _ref()
    step, params, opt = _port(ref["variables"], 2, 4, 2)
    step(params, opt, _batch(2), 0)
    for r in range(2):
        for k, want in _rank_tree(ref["new"], r).items():
            np.testing.assert_allclose(params[k][r].numpy(), want.numpy(),
                                       rtol=2e-5, atol=2e-5, err_msg=k)


def test_pp_composes_with_decentralized_combine():
    """dp 4 x pp 2 under atc equals JAX's dp-only atc run after 2 steps:
    the pipeline changes the model's layout, not the algorithm."""
    ref = _ref()
    step, params, opt = _port(
        ref["variables"], 4, 2, 2, comm_mode="atc",
        topology=TT.uniform_topology_spec(TT.RingGraph(4)))
    batch = _batch(4)
    for s in range(2):
        params, opt, _ = step(params, opt, batch, s)
    for r in range(4):
        for k, want in _rank_tree(ref["atc"], r).items():
            np.testing.assert_allclose(params[k][r].numpy(), want.numpy(),
                                       rtol=3e-5, atol=3e-5,
                                       err_msg=f"rank {r}: {k}")


def test_circular_pp_loss_and_update_match_jax():
    """The circular schedule (2 stages x 2 loops, 4 microbatches): the
    layout round trip is exact, and the loss and the one-step update,
    read back in natural order, equal JAX's."""
    ref = _ref()
    _, state = _state(ref["variables"])
    circ = llama_circular_layout(state, 2, 2)
    assert list(circ) == list(state)
    assert circ["layers.1.attention.wq.kernel"] is \
        state["layers.2.attention.wq.kernel"]
    back = llama_circular_layout(circ, 2, 2, inverse=True)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    step, params, opt = _port(ref["variables"], 2, 2, 4, n_loops=2)
    _, _, loss = step(params, opt, _batch(2), 0)
    np.testing.assert_allclose(loss.numpy(), ref["loss"], rtol=1e-5,
                               atol=1e-5)
    for r in range(2):
        got = llama_circular_layout({k: v[r] for k, v in params.items()},
                                    2, 2, inverse=True)
        for k, want in _rank_tree(ref["new"], r).items():
            np.testing.assert_allclose(got[k].numpy(), want.numpy(),
                                       rtol=2e-5, atol=2e-5, err_msg=k)


def test_pp_specs_mark_the_leaves_jax_shards():
    """``llama_param_specs(pp_axis=)`` marks every ``layers.*`` leaf
    stage-owned on its rank entry and no other, the leaves JAX shards
    over pp name for name (each per-layer leaf of one scanned row); the
    optimizer state inherits the marks; the step needs param_specs and
    the axis itself, and the specs need the rank axis."""
    ref = _ref()
    variables = ref["variables"]
    jspec = j_specs(variables, tp_axis=None, ep_axis=None, pp_axis="pp")
    flat = jax.tree_util.tree_flatten_with_path(
        jspec, is_leaf=lambda x: isinstance(x, P))[0]
    j_marked = {"/".join(str(getattr(k, "key", k)) for k in path)
                for path, spec in flat if "pp" in tuple(spec)}
    _, state = _state(variables)
    specs = llama_param_specs(state, tp_axis=None, ep_axis=None,
                              pp_axis="pp")
    marked = {k for k, v in specs.items() if v[0] == ("bf", "pp")}
    assert marked == {k for k in state if k.startswith("layers.")}
    # JAX's marked scanned rows, mapped to the port's per-layer names
    want = set()
    for name in j_marked:
        parts = name.split("/")
        assert parts[:3] == ["params", "layers", "block"], name
        leaf = ".".join(parts[3:])
        for i in range(L):
            want.add(f"layers.{i}.{leaf}")
    assert marked == want
    assert set(state) - marked == {"tok_embeddings.embedding",
                                   "norm.scale", "output.kernel"}
    plain = llama_param_specs(state, tp_axis=None, ep_axis=None)
    for k, v in specs.items():
        assert v == (plain[k] if not k.startswith("layers.")
                     else (("bf", "pp"),) + plain[k][1:]), k
    opt = torch.optim.SGD([torch.zeros(1)], lr=LR, momentum=0.9)
    ospecs = TF.optax_state_specs(opt, state, specs)
    assert ospecs["layers.0.attention.wq.kernel"]["momentum_buffer"] == \
        (("bf", "pp"),)
    assert ospecs["norm.scale"]["momentum_buffer"] == ("bf",)
    with pytest.raises(ValueError, match="rank_axis"):
        llama_param_specs(state, rank_axis=None, pp_axis="pp")
    backend = bt.StackedBackend(2, device="cpu")
    params = bt.rank_major(state, backend, specs=specs)
    opt = torch.optim.SGD(params.values(), lr=LR)
    loss_fn = llama_pp_loss_fn(_tcfg(), pp_axis="pp", n_stages=2, n_micro=2)
    with pytest.raises(ValueError, match="pp_axis requires param_specs"):
        bt.build_train_step(loss_fn, opt, backend, comm_mode="none",
                            pp_axis=bt.MeshAxis("pp", 2))
    # the axis itself, as sp_axis: a bare name holds no size
    with pytest.raises(TypeError, match="MeshAxis"):
        bt.build_train_step(loss_fn, opt, backend, comm_mode="none",
                            pp_axis="pp", param_specs=specs)
    with pytest.raises(ValueError, match="taken"):
        bt.build_train_step(loss_fn, opt, backend, comm_mode="none",
                            pp_axis=bt.MeshAxis("pp", 2), param_specs=specs,
                            mesh_axes=(bt.MeshAxis("pp", 2),))
    # specs naming a pp axis the step does not have
    step = bt.build_train_step(loss_fn, opt, backend, comm_mode="none",
                               param_specs=specs)
    with pytest.raises(ValueError, match="pp_axis"):
        step(params, opt, _batch(2), 1)


def test_pp_builder_errors_equal_jax():
    """``scan_layers=False``, a depth that does not divide and a batch
    that does not split into the microbatches raise JAX's errors."""
    for j, t in ((jm.LlamaConfig.tiny(dtype=jnp.float32, n_layers=L),
                  bt.LlamaConfig.tiny(dtype=torch.float32, n_layers=L)),):
        for build in (j_pp_loss, llama_pp_loss_fn):
            cfg = j if build is j_pp_loss else t
            with pytest.raises(ValueError, match="scan_layers"):
                build(cfg, pp_axis="pp", n_stages=2, n_micro=2)
    for build, cfg in ((j_pp_loss, jm.LlamaConfig.tiny(
            dtype=jnp.float32, n_layers=3, scan_layers=True)),
            (llama_pp_loss_fn, bt.LlamaConfig.tiny(
                dtype=torch.float32, n_layers=3, scan_layers=True))):
        with pytest.raises(ValueError, match="divide"):
            build(cfg, pp_axis="pp", n_stages=2, n_micro=2)
    _, state = _state(_ref()["variables"])
    loss_fn = llama_pp_loss_fn(_tcfg(), pp_axis="pp", n_stages=2,
                               n_micro=3)
    inp, tgt = _batch(1)
    with bt.bind_axis(bt.MeshAxis("pp", 2)):
        with pytest.raises(ValueError, match="must divide by n_micro"):
            loss_fn(state, (inp[0], tgt[0]))
    with pytest.raises(NameError, match="unbound axis name"):
        llama_pp_loss_fn(_tcfg(), pp_axis="pp", n_stages=2, n_micro=2)(
            state, (inp[0], tgt[0]))


def test_pp_step_on_the_process_backend_equals_stacked():
    """dp 2 x pp 2 under atc through a ``ProcessBackend`` (one gloo
    process holding both ranks) takes the stacked backend's steps bit for
    bit: the pipeline lives inside a rank, the backend only mixes."""
    import socket

    import torch.distributed as dist

    ref = _ref()
    topo = TT.uniform_topology_spec(TT.ExponentialTwoGraph(2))
    out = {}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        for name in ("stacked", "process"):
            step, params, opt = _port(
                ref["variables"], 2, 2, 2, comm_mode="atc", topology=topo,
                backend=(bt.ProcessBackend(2, device="cpu")
                         if name == "process" else None))
            losses = []
            for s in range(2):
                params, opt, loss = step(params, opt, _batch(2), s)
                losses.append(loss.clone())
            out[name] = (params, torch.stack(losses))
    finally:
        dist.destroy_process_group()
    assert torch.equal(out["process"][1], out["stacked"][1])
    for k, v in out["stacked"][0].items():
        assert torch.equal(out["process"][0][k], v), k
