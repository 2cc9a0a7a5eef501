"""TensorFlow bridge: tf tensors over the port's data plane.

Port of ``bluefog_tpu/interop/tf_adapter.py``, the counterpart of the
reference's TensorFlow binding (reference
bluefog/tensorflow/mpi_ops.{py,cc}: allreduce / allgather / broadcast
custom ops with gradient registration; bluefog/tensorflow/optimizers.py:
``DistributedOptimizer``, ``DistributedGradientTape``,
``broadcast_variables``).  It accepts **rank-major tensors**
(``[n_ranks, ...]``) and converts through numpy into the port's eager
ops (``bluefog_tpu_torch.api``), which run on the device ``bf.init``
chose, and back.

GRAPH MODE: inside ``tf.function`` / compiled Keras ``model.fit`` the
ops lower to ``tf.py_function`` nodes that call back into the eager
numpy bridge at execution time.  Every op is a host round-trip (TF ->
numpy -> torch -> numpy -> TF), in eager AND graph mode: this surface is
a correctness/migration bridge, and the port's own torch API is the
performance surface.  Direct calls on symbolic tensors outside the
provided ops raise in ``_to_torch``.

Gradient flow matches the reference's registered gradients:
``allreduce``'s gradient is an allreduce (reference mpi_ops.py:95-106),
``broadcast``'s is a reduction onto the root (reference :163-178), and
``allgather``'s slices the gathered cotangent back per rank (reference
:204-230), through ``tf.custom_gradient`` over the numpy bridge.

JAX's adapter refuses float64 and int64 tensors unless ``jax_enable_x64``
is on; torch keeps 64-bit types, so that refusal has no counterpart here.

``tensorflow`` is imported by this module only, and only when it is
imported: ``import bluefog_tpu_torch`` (and ``bluefog_tpu_torch.interop``)
does not load it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import bluefog_tpu_torch as bf

try:  # tensorflow is an optional dependency of this module only
    import tensorflow as tf
except ImportError:  # pragma: no cover
    tf = None

__all__ = [
    "allreduce", "allgather", "broadcast", "neighbor_allreduce",
    "broadcast_variables", "DistributedOptimizer",
    "DistributedGradientTape", "TFAdapter",
]


def _require_tf():
    if tf is None:
        raise ImportError(
            "bluefog_tpu_torch.interop.tf_adapter requires tensorflow")


def _to_torch(tensor):
    _require_tf()
    if not tf.executing_eagerly():
        # symbolic tensors have no .numpy(); the module's public ops
        # route graph-mode calls through tf.py_function (see _bridge),
        # which re-enters eager execution: only a direct _to_torch on a
        # symbolic tensor can land here
        raise RuntimeError(
            "bluefog_tpu_torch.interop.tf_adapter: got a symbolic tensor "
            "outside tf.py_function. Use the adapter's public ops "
            "(they wrap graph-mode calls in tf.py_function) or call "
            "eagerly.")
    if not tf.is_tensor(tensor):
        tensor = tf.convert_to_tensor(tensor)
    return bf.rank_sharded(tensor.numpy())


def _to_tf(array, like=None):
    host = (array.detach().cpu().numpy() if isinstance(array, torch.Tensor)
            else np.asarray(array))
    out = tf.convert_to_tensor(host)
    if like is not None and tf.is_tensor(like):
        out = tf.cast(out, like.dtype)
    return out


def _bridge(eager_fn, x, out_shape=None):
    """Run ``eager_fn`` (the numpy/torch bridge) on ``x`` now if eager,
    or as a ``tf.py_function`` graph node if tracing: the reference's TF
    custom ops run inside graphs (reference tensorflow/mpi_ops.py:77-230);
    py_function is the equivalent graph hook, with the same host
    round-trip the eager path already takes."""
    if tf.executing_eagerly():
        return eager_fn(x)
    y = tf.py_function(eager_fn, [x], Tout=x.dtype)
    y.set_shape(x.shape if out_shape is None else out_shape)
    return y


def allreduce(tensor, average: bool = True, name: Optional[str] = None):
    """Rank-major tf tensor -> global (average) reduction.  Differentiable:
    the pulled-back cotangent is itself allreduced (reference
    tensorflow/mpi_ops.py:95-106)."""
    _require_tf()

    @tf.custom_gradient
    def _op(x):
        y = _bridge(
            lambda t: _to_tf(bf.allreduce(_to_torch(t), average=average,
                                          name=name), like=t), x)

        def grad(dy):
            return _bridge(
                lambda t: _to_tf(bf.allreduce(_to_torch(t), average=average),
                                 like=t), dy)

        return y, grad

    return _op(tf.convert_to_tensor(tensor))


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """Every rank's slice becomes the root's.  Gradient: cotangents
    reduce onto the root slice, zeros elsewhere (reference
    tensorflow/mpi_ops.py:163-178)."""
    _require_tf()

    @tf.custom_gradient
    def _op(x):
        y = _bridge(
            lambda t: _to_tf(bf.broadcast(_to_torch(t), root_rank,
                                          name=name), like=t), x)

        def grad(dy):
            def _g(t):
                summed = bf.allreduce(_to_torch(t), average=False)
                summed = summed.detach().cpu().numpy()
                g = np.zeros_like(summed)
                g[root_rank] = summed[root_rank]
                return _to_tf(g, like=t)

            return _bridge(_g, dy)

        return y, grad

    return _op(tf.convert_to_tensor(tensor))


def allgather(tensor, name: Optional[str] = None):
    """Concatenate all ranks' slices along dim 0 (per rank).  Gradient:
    each rank keeps its own slice of the cotangent, summed over the
    ranks that received it (reference tensorflow/mpi_ops.py:204-230)."""
    _require_tf()

    @tf.custom_gradient
    def _op(x):
        # output is [n, n*rows, ...] for [n, rows, ...] input; keep every
        # statically-unknown dim unknown rather than stamping the input
        # shape (rank<2 is rejected by the eager path at runtime)
        if x.shape.rank is not None and x.shape.rank > 1:
            n_static, rows_static = x.shape[0], x.shape[1]
            mid = (n_static * rows_static
                   if n_static is not None and rows_static is not None
                   else None)
            gathered = tf.TensorShape(
                [n_static, mid]).concatenate(x.shape[2:])
        else:
            gathered = tf.TensorShape(None)
        y = _bridge(
            lambda t: _to_tf(bf.allgather(_to_torch(t), name=name), like=t),
            x, out_shape=gathered)

        def grad(dy):
            n = bf.size()
            rows = tf.shape(x)[1]
            # dy is rank-major [n, n*rows, ...]: every rank j received a
            # copy of rank r's slice, so dL/dx[r] sums the cotangents all
            # ranks produced for that slice (the reference lowers this as
            # allreduce + slice-own-part, mpi_ops.py:204-230; rank-major
            # tensors make it one reshape-sum)
            dy_split = tf.reshape(
                dy, tf.concat([[n, n, rows], tf.shape(dy)[2:]], axis=0))
            return tf.cast(tf.reduce_sum(dy_split, axis=0), dy.dtype)

        return y, grad

    return _op(tf.convert_to_tensor(tensor))


def neighbor_allreduce(tensor, *, self_weight=None, src_weights=None,
                       dst_weights=None, enable_topo_check: bool = True,
                       name: Optional[str] = None):
    """Weighted neighbor combine (the op the reference's TF binding never
    had: its TF users were limited to allreduce; exposed here so the TF
    surface reaches capability parity with the torch one)."""
    _require_tf()
    return _bridge(
        lambda t: _to_tf(
            bf.neighbor_allreduce(_to_torch(t), self_weight=self_weight,
                                  src_weights=src_weights,
                                  dst_weights=dst_weights,
                                  enable_topo_check=enable_topo_check,
                                  name=name),
            like=t),
        tf.convert_to_tensor(tensor))


def broadcast_variables(variables, root_rank: int = 0):
    """In-place: assign every variable its root-rank slice (reference
    tensorflow/optimizers.py:64-85 broadcast_variables)."""
    _require_tf()
    for var in variables:
        var.assign(broadcast(var, root_rank))


class DistributedOptimizer:
    """Wrap a ``tf.keras.optimizers.Optimizer`` over rank-major replica
    stacks (reference tensorflow/optimizers.py:88-162).

    * ``communication="allreduce"``: average gradients globally before
      ``apply_gradients`` (the reference TF binding's only mode).
    * ``communication="neighbor_allreduce"``: apply the base step, then
      combine variables with graph neighbors (ATC) — the decentralized
      flavor the reference reserves for torch, exposed to TF here.
    """

    def __init__(self, optimizer, communication: str = "allreduce"):
        _require_tf()
        if communication not in ("allreduce", "neighbor_allreduce"):
            raise ValueError(f"unknown communication {communication!r}")
        self.optimizer = optimizer
        self.communication = communication

    def apply_gradients(self, grads_and_vars, *args, **kwargs):
        grads_and_vars = list(grads_and_vars)
        if self.communication == "allreduce":
            grads_and_vars = [
                (g if g is None else allreduce(g, average=True), v)
                for g, v in grads_and_vars]
        result = self.optimizer.apply_gradients(grads_and_vars, *args,
                                                **kwargs)
        if self.communication == "neighbor_allreduce":
            for _, v in grads_and_vars:
                v.assign(neighbor_allreduce(v))
        return result

    def apply(self, grads, trainable_variables=None, **kwargs):
        """Keras-3 entry point (``Model.train_step`` calls
        ``optimizer.apply``): route through the communicating
        ``apply_gradients`` so a compiled ``model.fit`` still averages
        gradients / combines neighbors."""
        if trainable_variables is None:
            # Keras-3 one-arg form: the built optimizer knows its
            # variables; bare grads must NOT reach apply_gradients
            # (it unpacks (grad, var) pairs)
            trainable_variables = getattr(
                self.optimizer, "_trainable_variables", None)
            if not trainable_variables:
                raise ValueError(
                    "apply(grads) without trainable_variables requires "
                    "the wrapped optimizer to be built; pass "
                    "trainable_variables explicitly")
        return self.apply_gradients(
            list(zip(grads, trainable_variables)), **kwargs)

    def minimize(self, loss, var_list, tape=None):
        """Route through the communicating ``apply_gradients`` — the
        base optimizer's ``minimize`` would silently skip it."""
        if callable(loss):
            with tf.GradientTape() as inner:
                value = loss()
            grads = inner.gradient(value, var_list)
        else:
            if tape is None:
                raise ValueError(
                    "minimize() with a loss tensor requires tape=")
            grads = tape.gradient(loss, var_list)
        self.apply_gradients(zip(grads, var_list))

    def __getattr__(self, name):
        if name == "optimizer" or (name.startswith("__")
                                   and name.endswith("__")):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "optimizer"), name)


class DistributedGradientTape:
    """``tf.GradientTape`` wrapper whose ``gradient()`` allreduces the
    results (reference tensorflow/optimizers.py:165-196)."""

    def __init__(self, tape):
        _require_tf()
        self.tape = tape

    def __enter__(self):
        self.tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self.tape.__exit__(*exc)

    def gradient(self, target, sources, output_gradients=None):
        grads = self.tape.gradient(target, sources, output_gradients)
        flat = tf.nest.flatten(grads)
        flat = [g if g is None else allreduce(g, average=True)
                for g in flat]
        return tf.nest.pack_sequence_as(grads, flat)

    def __getattr__(self, name):
        if name == "tape" or (name.startswith("__")
                              and name.endswith("__")):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "tape"), name)


class TFAdapter:
    """Module-style facade mirroring the reference's
    ``bluefog.tensorflow`` API object."""

    allreduce = staticmethod(allreduce)
    allgather = staticmethod(allgather)
    broadcast = staticmethod(broadcast)
    neighbor_allreduce = staticmethod(neighbor_allreduce)
    broadcast_variables = staticmethod(broadcast_variables)
    DistributedOptimizer = DistributedOptimizer
    DistributedGradientTape = DistributedGradientTape
