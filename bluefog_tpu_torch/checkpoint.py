"""Checkpoint / resume of rank-major train state.

Port of ``bluefog_tpu/checkpoint.py``, rebuilt on ``torch.save`` /
``torch.load`` in the place of orbax.  The whole rank-major train state
(params, the optimizer's state, the push-sum weight or ``MixState``, a
step count: every tensor with a leading rank axis) checkpoints as one
tree, so each rank's *divergent* parameters are kept exactly, which a
"save rank 0" scheme would lose.

**In place, as the port's train step is.**  The port's step updates its
state in place, so

* :meth:`Checkpointer.save` copies every tensor to host memory before it
  returns (pinned buffers on the card, one synchronize), and only then
  writes, on a thread when ``blocking=False``: the next step may run at
  once;
* :meth:`Checkpointer.restore` with ``like=`` (the live state) copies the
  saved values INTO the live tensors (``copy_``) and into the live
  optimizer's ``state``, and returns ``like`` itself: an optimizer built
  over the params goes on stepping the restored tensors.  State the
  checkpoint does not hold (a momentum buffer created after the save) is
  dropped from the optimizer, as it was at the save.

**On disk.**  Step ``s`` is the directory ``<directory>/<s>/`` holding one
shard per process, ``p<i>/`` with ``state.pt`` (the leaves) and
``manifest.json`` (the rank count, the process count and index, each
leaf's name, shape and dtype).  A shard is written into a temporary
directory and renamed into place, so a reader never sees half a shard.
Under ``ProcessBackend`` each process writes its own ``[k, ...]`` rows,
and :meth:`restore_latest` agrees through the job's key-value store on
one step every process can load before any process copies anything.

Usage::

    ckpt = Checkpointer("/path/ckpts", max_to_keep=3)
    ckpt.save(step, {"params": params, "opt_state": opt, "step": step})
    state = ckpt.restore_latest(like={"params": params, "opt_state": opt,
                                      "step": 0})
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from bluefog_tpu_torch import _tree
from bluefog_tpu_torch.logging_util import get_logger

__all__ = ["Checkpointer"]

logger = get_logger()

_FORMAT = 1


def _leaf_name(path) -> str:
    return "/".join(str(p) for p in path)


def _unflatten(items) -> Any:
    """Nested dicts from (path, value) pairs (restore without ``like``:
    plain containers, as orbax returns without a template)."""
    out: Dict[Any, Any] = {}
    for path, value in items:
        if not path:
            return value
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


class Checkpointer:
    """Rank-major train state to and from ``directory``.

    ``backend``: the state's :class:`~bluefog_tpu_torch.parallel.
    collectives.RankBackend` (default: the initialized context's, else one
    process).  Under a ``ProcessBackend`` of several processes every process
    constructs its Checkpointer over the same directory and calls
    ``save``/``restore_latest`` at the same steps."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 backend=None):
        if backend is None:
            from bluefog_tpu_torch import context

            if context.is_initialized():
                backend = context.get_context().backend
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.backend = backend
        self.process_index = int(getattr(backend, "process_index", 0))
        self.process_count = int(getattr(backend, "process_count", 1))
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict[tuple, torch.Tensor] = {}
        self._rounds = 0
        self._tag = hashlib.sha1(self.directory.encode()).hexdigest()[:12]
        #: seconds and bytes of the last save (``snapshot_s``: the copy
        #: to host memory; ``write_s``: the file write) and restore
        #: (``load_s``: reading the files; ``copy_s``: into the state)
        self.last_save: Dict[str, float] = {}
        self.last_restore: Dict[str, float] = {}

    # ---------------------------------------------------------------- #
    # layout
    # ---------------------------------------------------------------- #
    def _shard_dir(self, step: int, process: Optional[int] = None) -> str:
        p = self.process_index if process is None else process
        return os.path.join(self.directory, str(int(step)), f"p{p}")

    def all_steps(self) -> List[int]:
        """Steps whose shard of this process is committed."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.exists(os.path.join(
                    self._shard_dir(int(name)), "manifest.json")):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---------------------------------------------------------------- #
    # save
    # ---------------------------------------------------------------- #
    def _rank_count(self, items) -> Optional[int]:
        if self.backend is not None:
            return int(self.backend.size)
        for _, leaf in items:
            if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1:
                return int(leaf.shape[0])
        return None

    def _snapshot(self, state):
        """(path, host value) of every leaf, copied before return."""
        items = list(_tree.leaves(state))
        out, on_card = [], False
        for path, leaf in items:
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach()
                if leaf.device.type == "cuda":
                    key = (path, tuple(leaf.shape), leaf.dtype)
                    buf = self._pinned.get(key)
                    if buf is None:
                        buf = self._pinned[key] = torch.empty(
                            leaf.shape, dtype=leaf.dtype, pin_memory=True)
                    buf.copy_(leaf, non_blocking=True)
                    leaf, on_card = buf, True
                else:
                    leaf = leaf.clone()
            elif hasattr(leaf, "__array__") and not isinstance(
                    leaf, (int, float)):
                leaf = torch.as_tensor(leaf).clone()
            out.append((path, leaf))
        if on_card:
            torch.cuda.synchronize()
        return out

    def _write(self, step: int, items, rank_count) -> None:
        t0 = time.perf_counter()
        final = self._shard_dir(step)
        tmp = os.path.join(self.directory,
                           f".{step}.p{self.process_index}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = dict(
            format=_FORMAT, step=int(step), rank_count=rank_count,
            process_count=self.process_count,
            process_index=self.process_index,
            leaves=[dict(name=_leaf_name(p),
                         shape=list(v.shape) if isinstance(
                             v, torch.Tensor) else None,
                         dtype=str(v.dtype).replace("torch.", "")
                         if isinstance(v, torch.Tensor)
                         else type(v).__name__)
                    for p, v in items])
        torch.save({"paths": [p for p, _ in items],
                    "values": [v for _, v in items]},
                   os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._prune()
        self.last_save["write_s"] = time.perf_counter() - t0

    def _prune(self) -> None:
        if not self.max_to_keep:
            return
        for step in self.all_steps()[:-int(self.max_to_keep)]:
            shutil.rmtree(self._shard_dir(step), ignore_errors=True)
            try:
                os.rmdir(os.path.join(self.directory, str(step)))
            except OSError:  # another process's shard is still there
                pass

    def save(self, step: int, state: Any, force: bool = False,
             blocking: bool = True) -> bool:
        """Save the rank-major tree ``state`` at ``step``.

        The state is copied to host memory before this returns, so the
        caller may update it in place at once.  ``blocking=False`` writes
        the files on a thread:
        call :meth:`wait` (or the next ``save``, ``restore`` or
        ``close``, which wait first) before relying on them.  A step that
        exists already is overwritten with ``force``, else this raises."""
        self.wait()
        step = int(step)
        if step in self.all_steps() and not force:
            raise ValueError(f"checkpoint step {step} exists under "
                             f"{self.directory}; pass force=True")
        t0 = time.perf_counter()
        items = self._snapshot(state)
        nbytes = sum(v.numel() * v.element_size() for _, v in items
                     if isinstance(v, torch.Tensor))
        self.last_save = dict(snapshot_s=time.perf_counter() - t0,
                              bytes=float(nbytes))
        rank_count = self._rank_count(items)

        def write():
            try:
                self._write(step, items, rank_count)
            except BaseException as exc:  # surfaced by wait()
                self._error = exc

        if blocking:
            self._write(step, items, rank_count)
        else:
            self._thread = threading.Thread(target=write, daemon=True,
                                            name="bf-checkpoint")
            self._thread.start()
        return True

    def wait(self) -> None:
        """Block until every save has committed to disk (re-raises a
        failed background write)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    # ---------------------------------------------------------------- #
    # restore
    # ---------------------------------------------------------------- #
    def _load(self, step: int):
        """(manifest, {path: value}) of this process's shard."""
        shard = self._shard_dir(step)
        with open(os.path.join(shard, "manifest.json")) as fh:
            manifest = json.load(fh)
        blob = torch.load(os.path.join(shard, "state.pt"),
                          map_location="cpu", weights_only=True)
        paths = [tuple(p) for p in blob["paths"]]
        if len(paths) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint step {step}: {len(paths)} leaves "
                             f"against a manifest of "
                             f"{len(manifest['leaves'])}")
        return manifest, dict(zip(paths, blob["values"]))

    def _check_world(self, step: int, manifest) -> None:
        want = (self.backend.size if self.backend is not None else None)
        got = manifest.get("rank_count")
        if (want is not None and got is not None and got != want) or \
                manifest.get("process_count", 1) != self.process_count:
            raise ValueError(
                f"checkpoint step {step} has rank axis {got} over "
                f"{manifest.get('process_count', 1)} process(es) but this "
                f"job has {want} ranks over {self.process_count}; resume "
                "on a matching rank axis")

    @staticmethod
    def _check_rows(step, path, value, like_rows):
        if isinstance(value, torch.Tensor) and value.dim() >= 1 and \
                like_rows is not None and value.shape[0] != like_rows:
            raise ValueError(
                f"checkpoint leaf {_leaf_name(path)} of step {step} has rank "
                f"axis {value.shape[0]} but the state has {like_rows} ranks; "
                "resume on a matching rank axis")

    @classmethod
    def _plan(cls, step: int, like, saved):
        """Check ``saved`` against ``like`` before anything is written:
        [(live tensor, saved value)] and [(optimizer, {param index:
        {key: saved value}})]."""
        plan, opts = [], []
        for path, leaf in _tree.leaves(like, open_optimizers=False):
            if isinstance(leaf, torch.optim.Optimizer):
                params = _tree.optimizer_params(leaf)
                fresh: Dict[int, dict] = {}
                for key, value in saved.items():
                    if key[:len(path)] != path or len(key) != len(path) + 3:
                        continue
                    i = key[len(path) + 1]
                    if not 0 <= i < len(params):
                        raise ValueError(
                            f"checkpoint step {step}: optimizer state for "
                            f"param {i} of {len(params)}")
                    cls._check_rows(step, key, value, params[i].shape[0]
                                    if params[i].dim() else None)
                    fresh.setdefault(i, {})[key[len(path) + 2]] = value
                opts.append((leaf, fresh))
                continue
            if path not in saved:
                raise ValueError(f"checkpoint step {step} has no leaf "
                                 f"{_leaf_name(path)!r}")
            value = saved[path]
            if isinstance(leaf, torch.Tensor):
                if not isinstance(value, torch.Tensor):
                    raise ValueError(f"checkpoint leaf {_leaf_name(path)} "
                                     "is not a tensor")
                cls._check_rows(step, path, value,
                                leaf.shape[0] if leaf.dim() else None)
                if value.shape != leaf.shape or value.dtype != leaf.dtype:
                    raise ValueError(
                        f"checkpoint leaf {_leaf_name(path)} is "
                        f"{tuple(value.shape)} {value.dtype}, the state's "
                        f"{tuple(leaf.shape)} {leaf.dtype}")
                plan.append((leaf, value))
        return plan, opts

    @staticmethod
    def _apply(like, plan, opts, saved):
        """Copy into the live state; returns ``like`` with its other
        leaves (step counts) replaced by the saved values."""
        with torch.no_grad():
            for live, value in plan:
                live.copy_(value, non_blocking=True)
            for opt, fresh in opts:
                for i, p in enumerate(_tree.optimizer_params(opt)):
                    new = fresh.get(i)
                    if not new:
                        opt.state.pop(p, None)
                        continue
                    state = opt.state[p]
                    for k in list(state):
                        if k not in new:
                            del state[k]
                    for k, v in new.items():
                        cur = state.get(k)
                        if isinstance(v, torch.Tensor) and isinstance(
                                cur, torch.Tensor) and cur.shape == v.shape \
                                and cur.dtype == v.dtype:
                            cur.copy_(v, non_blocking=True)
                        else:
                            state[k] = (v.to(p.device)
                                        if isinstance(v, torch.Tensor)
                                        else v)
        return _tree.replace_leaves(
            like, lambda path, leaf: leaf if isinstance(
                leaf, (torch.Tensor, torch.optim.Optimizer)) else saved[path])

    def _read(self, step: int, like):
        """Load and check this process's shard of ``step``: a closure that
        applies it (nothing is written before every check passed)."""
        t0 = time.perf_counter()
        manifest, saved = self._load(step)
        self._check_world(step, manifest)
        load_s = time.perf_counter() - t0
        nbytes = float(sum(v.numel() * v.element_size()
                           for v in saved.values()
                           if isinstance(v, torch.Tensor)))
        if like is None:
            def apply():
                self.last_restore = dict(load_s=load_s, copy_s=0.0,
                                         bytes=nbytes)
                return _unflatten(saved.items())
            return apply
        plan, opts = self._plan(step, like, saved)

        def apply():
            t1 = time.perf_counter()
            out = self._apply(like, plan, opts, saved)
            if any(isinstance(v, torch.Tensor) and v.device.type == "cuda"
                   for _, v in _tree.leaves(like)):
                torch.cuda.synchronize()
            self.last_restore = dict(load_s=load_s,
                                     copy_s=time.perf_counter() - t1,
                                     bytes=nbytes)
            return out
        return apply

    def restore(self, step: int, like: Any = None) -> Any:
        """Restore the tree saved at ``step``.

        With ``like`` (the live state: its tensors, optimizers and
        containers), the saved values are copied into it in place and
        ``like`` is returned; every leaf is checked first (a leading
        rank axis that differs raises ``ValueError`` naming the "rank
        axis").  Without it, the leaves come back as host tensors in
        nested dicts."""
        self.wait()
        return self._read(int(step), like)()

    def _agree(self, what: str, value) -> list:
        """Every process's ``value`` (JSON), in process order, through the
        job's key-value store; ``[value]`` in a one-process job."""
        if self.process_count <= 1:
            return [value]
        from bluefog_tpu_torch import api

        store = api._default_store()
        if store is None:
            raise RuntimeError("restore_latest across processes needs the "
                               "job's key-value store")
        key = f"bf_ckpt/{self._tag}/{self._rounds}/{what}"
        store.set(f"{key}/{self.process_index}", json.dumps(value))
        return [json.loads(store.get(f"{key}/{p}"))
                for p in range(self.process_count)]

    def restore_latest(self, like: Any = None) -> Any:
        """Restore the newest step every process can restore.

        A corrupt or partly written newest step (a truncated file, a
        shard that does not load) must not kill a rollback when an older
        intact step exists: it falls back to the next-newest step with a
        warning.  A rank-axis mismatch is a caller error, not damage, and
        raises at once — falling back would resume a mismatched world.
        If no step restores, the newest step's error is raised.  Under a
        multi-process backend the processes first agree on the steps all
        of them hold, then on each candidate's outcome, so all restore
        the same step."""
        self.wait()
        self._rounds += 1
        held = self._agree("steps", self.all_steps())
        steps = sorted(set.intersection(*(set(s) for s in held)))
        if not steps:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        first_error: Optional[Exception] = None
        for step in reversed(steps):
            error = None
            try:
                apply = self._read(step, like)
            except ValueError as exc:
                error = exc
            except Exception as exc:  # torch.load surfaces many types
                error = exc
            verdicts = self._agree(
                f"step{step}",
                "ok" if error is None else
                ("axis" if "rank axis" in str(error) else "bad"))
            if "axis" in verdicts:
                if error is not None and "rank axis" in str(error):
                    raise error
                raise ValueError(
                    f"checkpoint step {step}: another process found a "
                    "rank axis that does not match this job")
            if error is None and all(v == "ok" for v in verdicts):
                return apply()
            if error is None:
                error = RuntimeError(
                    f"checkpoint step {step} does not restore on process "
                    f"{verdicts.index('bad')}")
            first_error = first_error or error
            logger.warning(
                "checkpoint step %d under %s is not restorable "
                "(%s: %s); falling back to the next-newest step",
                step, self.directory, type(error).__name__, error)
        raise first_error

    def close(self):
        self.wait()
        self._pinned.clear()
