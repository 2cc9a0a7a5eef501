"""The port's pipeline composed with the other axes, each held to the
JAX package's contract for it on the same weights
(``llama_params_from_flax``) and numpy-seeded tokens:

* tp x pp with ``vocab_parallel`` (dp 2 x pp 2 x tp 2; JAX's
  ``tests/test_vocab_parallel.py::test_vocab_parallel_pp_loss_matches``):
  each rank's step-0 loss equals JAX's unsharded cross-entropy;
* MoE under pp (JAX's ``tests/test_moe.py::
  test_moe_pp_loss_includes_aux``): at ``n_micro`` 1 the summed stage
  losses equal JAX's plain cross-entropy plus ``w`` x the layers' summed
  aux, each stage routing its own tokens (capacity factor 1.0, so a
  routing over both stages' tokens at once would drop others); at
  ``n_micro`` 2 they equal JAX's own pipeline loss;
* dp x pp x ring sp (dp 2 x pp 2 x sp 2; JAX's ``tests/test_pp.py::
  test_pp_composes_with_ring_sequence_parallelism``): each rank's loss
  equals JAX's unsharded full-attention model's.

Tolerance: JAX's, 1e-5 on losses."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from bluefog_tpu import models as jm
from bluefog_tpu.models.llama import llama_pp_loss_fn as j_pp_loss
import bluefog_tpu_torch as bt
from bluefog_tpu_torch.interop import llama_params_from_flax
from bluefog_tpu_torch.models.llama import (llama_loss_fn,
                                            llama_param_specs,
                                            llama_pp_loss_fn)
from bluefog_tpu_torch.optim import functional as TF

B, T, L = 4, 16, 4
AUX_W = 0.5
MOE = dict(n_experts=4, moe_top_k=2, capacity_factor=1.0,
           moe_aux_weight=AUX_W)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n_bf, seed=0):
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, size=(n_bf, B, T + 1)).astype(np.int32)
    return raw[:, :, :-1], raw[:, :, 1:]


_REF = {}


def _ref(kind):
    """JAX's variables and each rank's plain loss (``kind`` "dense" or
    "moe": cross-entropy + w x aux), one program each, shared by the
    module's tests."""
    if kind in _REF:
        return _REF[kind]
    over = MOE if kind == "moe" else {}
    cfg = jm.LlamaConfig.tiny(dtype=jnp.float32, n_layers=L,
                              scan_layers=True, **over)
    model = jm.Llama(cfg)
    variables = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((B, 8), jnp.int32)))

    @jax.jit
    def plain(v, i, t):
        logits, mut = model.apply(v, i, mutable=["intermediates"])
        aux = sum(jnp.sum(x) for x in jax.tree.leaves(mut))
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, t)) + AUX_W * aux

    inp, tgt = _data(2)
    _REF[kind] = (variables, np.asarray([float(plain(variables, inp[r],
                                                     tgt[r]))
                                         for r in range(2)]))
    return _REF[kind]


def _port_step(variables, cfg, n_stages, n_micro, mesh_axes=(), **kw):
    """Step 0 of the port's pp step over 2 stacked ranks: the losses."""
    model = bt.Llama(_plain_cfg(cfg), device="cpu",
                     param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, model.cfg,
                                                 device="cpu"))
    state = model.state(release=True)
    backend = bt.StackedBackend(2, device="cpu")
    specs = llama_param_specs(
        state, tp_axis="tp" if cfg.tp_size > 1 else None, ep_axis=None,
        pp_axis="pp", vocab_axis="tp" if cfg.vocab_parallel else None)
    params = bt.rank_major(state, backend, specs=specs)
    opt = torch.optim.SGD(params.values(), lr=0.1)
    step = bt.build_train_step(
        llama_pp_loss_fn(cfg, pp_axis="pp", n_stages=n_stages,
                         n_micro=n_micro),
        opt, backend, comm_mode="none", pp_axis=bt.MeshAxis("pp", n_stages),
        mesh_axes=mesh_axes, param_specs=specs,
        opt_state_specs=TF.optax_state_specs(opt, state, specs), **kw)
    inp, tgt = _data(2)
    _, _, loss = step(params, opt, (torch.from_numpy(inp),
                                    torch.from_numpy(tgt)), 0)
    return loss.numpy()


def _plain_cfg(cfg):
    """The config of the same parameter tree without the layout knobs
    (the model whose weights the pipeline reads)."""
    return dataclasses.replace(cfg, tp_axis=None, tp_size=1,
                               vocab_parallel=False, attn_mode="full",
                               sp_axis=None)


def test_tp_pp_vocab_parallel_loss_matches_jax():
    """dp 2 x pp 2 x tp 2 with vocab_parallel: the loss equals JAX's
    unsharded cross-entropy on the same tokens."""
    variables, want = _ref("dense")
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, n_layers=L,
                              scan_layers=True, tp_axis="tp", tp_size=2,
                              vocab_parallel=True)
    loss = _port_step(variables, cfg, 2, 2,
                      mesh_axes=(bt.MeshAxis("tp", 2),))
    np.testing.assert_allclose(loss, want, rtol=1e-5, atol=1e-5)


def test_moe_pp_loss_includes_aux_as_jax():
    """pp 2 MoE: at n_micro 1 the summed stage losses are JAX's plain
    cross-entropy + w x total aux (each stage its own layers' aux, its
    tokens routed on their own); at n_micro 2 (per-microbatch routing
    groups) they equal JAX's pipeline loss, per stage too."""
    variables, want = _ref("moe")
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, n_layers=L,
                              scan_layers=True, **MOE)
    np.testing.assert_allclose(_port_step(variables, cfg, 2, 1), want,
                               rtol=1e-5, atol=1e-5)

    jcfg = jm.LlamaConfig.tiny(dtype=jnp.float32, n_layers=L,
                               scan_layers=True, **MOE)
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    specs = jax.tree_util.tree_map_with_path(
        lambda path, _: P("pp") if "layers" in jax.tree_util.keystr(path)
        else P(), variables)
    inp, tgt = _data(1)
    j_loss = jax.jit(jax.shard_map(
        lambda v, i, t: j_pp_loss(jcfg, pp_axis="pp", n_stages=2,
                                  n_micro=2)(v, (i, t))[None],
        mesh=mesh, in_specs=(specs, P(), P()), out_specs=P("pp"),
        check_vma=False))(variables, inp[0], tgt[0])
    model = bt.Llama(cfg, device="cpu", param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, cfg,
                                                 device="cpu"))
    with torch.no_grad(), bt.bind_axis(bt.MeshAxis("pp", 2)):
        loss = llama_pp_loss_fn(cfg, pp_axis="pp", n_stages=2, n_micro=2)(
            model.state(), (torch.from_numpy(inp[0]),
                            torch.from_numpy(tgt[0])))
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), rtol=1e-5,
                               atol=1e-5)


def test_pp_composes_with_ring_sequence_parallelism():
    """dp 2 x pp 2 x sp 2 in one step: pipelined stages whose blocks run
    ring attention over the sp axis (each stage's rows and the sequence
    shards folded into the batch); each rank's loss equals JAX's
    unsharded full-attention model's."""
    variables, want = _ref("dense")
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, n_layers=L,
                              scan_layers=True, attn_mode="ring",
                              sp_axis="sp")
    loss = _port_step(variables, cfg, 2, 2, sp_axis=bt.SeqAxis("sp", 2),
                      batch_specs=("bf", None, "sp"))
    np.testing.assert_allclose(loss, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_pp_sp_loss_and_grads_equal_the_plain_model(mode):
    """The pipeline's per-stage, per-shard losses under ring and
    Ulysses attention sum to the plain model's loss, and every gradient
    equals the plain model's (the stages' and shards' folds undone by
    autograd)."""
    variables, _ = _ref("dense")
    cfg = bt.LlamaConfig.tiny(dtype=torch.float32, n_layers=L,
                              scan_layers=True, attn_mode=mode,
                              sp_axis="sp")
    model = bt.Llama(_plain_cfg(cfg), device="cpu",
                     param_dtype=torch.float32)
    model.load_state_dict(llama_params_from_flax(variables, model.cfg,
                                                 device="cpu"))
    inp, tgt = (torch.from_numpy(x[0]) for x in _data(1))
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in model.state().items()}
    ref = llama_loss_fn(model)(p, (inp, tgt))
    g_ref = torch.autograd.grad(ref, list(p.values()))
    shard = lambda x: x.reshape(B, 2, T // 2).movedim(1, 0)  # noqa: E731
    with bt.bind_axis(bt.MeshAxis("pp", 2)), bt.bind_axis(
            bt.SeqAxis("sp", 2)):
        loss = llama_pp_loss_fn(cfg, pp_axis="pp", n_stages=2, n_micro=2)(
            p, (shard(inp), shard(tgt)))
        assert loss.shape == (2, 2)
        g = torch.autograd.grad(loss.sum(0).mean(), list(p.values()))
    np.testing.assert_allclose(loss.sum(0).mean().item(), ref.item(),
                               rtol=1e-5, atol=1e-5)
    for k, a, b in zip(p, g, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=k)


def test_pp_refuses_tp_seq_shard_as_jax():
    seq = dict(tp_axis="tp", tp_size=2, vocab_parallel=True,
               tp_seq_shard=True)
    for build, cfg in (
            (j_pp_loss, jm.LlamaConfig.tiny(scan_layers=True, **seq)),
            (llama_pp_loss_fn, bt.LlamaConfig.tiny(scan_layers=True,
                                                   **seq))):
        with pytest.raises(ValueError, match="tp_seq_shard"):
            build(cfg, pp_axis="pp", n_stages=2, n_micro=2)
