"""The port's input pipeline (bluefog_tpu_torch/data.py) against the JAX
package's ``bluefog_tpu/data.py`` on the CPU, bit for bit.

* ``DistributedSampler`` indices across world, shuffle, ``drop_last`` and
  epochs (padding that tiles the dataset included).
* ``DataLoader`` batches — native and Python pipelines, rank-major and
  per-rank, ``drop_last``, the padded rank-major tail, the transform, two
  epochs — equal JAX's (its native pipeline and its Python one).
* ``state_dict`` resume mid-epoch replays the uninterrupted stream.
* ``load_mnist`` / ``load_cifar10`` on tiny files the test writes.
* ``device_prefetch`` on the CPU: the same batches as tensors, in order.
* ``use_native=True`` raises when the native build fails; the default
  falls back to the Python pipeline.
"""

import gzip
import pickle
import struct

import numpy as np
import pytest
import torch

from bluefog_tpu import data as JD

import bluefog_tpu_torch as bt
from bluefog_tpu_torch import data as D
from bluefog_tpu_torch import native


def _dataset(n=97, shape=(4, 5), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n,) + shape).astype(np.uint8),
            rng.randint(0, 1000, (n,)).astype(np.int32))


@pytest.mark.parametrize("world", [1, 3, 4, 8])
def test_sampler_indices_equal_jax(world):
    for n in (2, 97, 104):
        for shuffle in (True, False):
            for drop_last in (True, False):
                for rank in range(world):
                    kw = dict(rank=rank, world=world, shuffle=shuffle,
                              seed=7, drop_last=drop_last)
                    a = D.DistributedSampler(n, **kw)
                    b = JD.DistributedSampler(n, **kw)
                    assert len(a) == len(b)
                    for epoch in range(3):
                        np.testing.assert_array_equal(a.indices(epoch),
                                                      b.indices(epoch))


_LOADERS = [
    dict(batch_size=16, world=4, rank_major=True, seed=4),
    dict(batch_size=8, world=4, rank_major=True, seed=0, shuffle=False),
    dict(batch_size=12, world=3, rank=1, seed=9),
    dict(batch_size=16, world=1, drop_last=True, seed=5),
    dict(batch_size=10, world=2, rank_major=True, drop_last=True, seed=2,
         num_workers=3, prefetch_depth=2),
]


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("cfg", range(len(_LOADERS)))
def test_loader_batches_equal_jax(cfg, use_native):
    assert native.available(), native.build_error()
    x, y = _dataset()
    kw = _LOADERS[cfg]
    a = D.DataLoader((x, y), use_native=use_native, **kw)
    b = JD.DataLoader((x, y), use_native=True, **kw)
    c = JD.DataLoader((x, y), use_native=False, **kw)
    assert a.native is use_native and len(a) == len(b)
    for _ in range(2):  # two epochs: the sampler's epoch advances
        ours, theirs, plain = list(a), list(b), list(c)
        assert len(ours) == len(theirs) == len(plain)
        for p, q, r in zip(ours, theirs, plain):
            for u, v, w in zip(p, q, r):
                assert u.dtype == v.dtype and u.shape == v.shape
                assert u.tobytes() == v.tobytes() == w.tobytes()
    for loader in (a, b, c):
        loader.close()


def test_loader_transform_and_errors():
    x, y = _dataset(20, (2,))
    kw = dict(batch_size=10, shuffle=False, world=1,
              transform=lambda bx, by: (bx * 2, by))
    a = next(iter(D.DataLoader((x, y), **kw)))
    b = next(iter(JD.DataLoader((x, y), **kw)))
    np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(ValueError, match="rank_major"):
        D.DataLoader((x,), batch_size=8, world=4, rank=1, rank_major=True)
    with pytest.raises(ValueError, match="batch_size % world"):
        D.DataLoader((x,), batch_size=6, world=4, rank_major=True)
    # world defaults to the initialized context's size
    bt.init(size=4, device="cpu")
    try:
        loader = D.DataLoader((np.zeros((64, 2), np.float32),),
                              batch_size=16, rank_major=True)
        assert loader.world == 4
        assert next(iter(loader))[0].shape == (4, 4, 2)
    finally:
        bt.shutdown()


@pytest.mark.parametrize("use_native", [True, False])
def test_state_dict_resume_equals_uninterrupted(use_native):
    x = np.arange(40, dtype=np.float32).reshape(40, 1)
    ref = D.DataLoader([x], batch_size=8, seed=3, world=1,
                       use_native=use_native)
    it = iter(ref)
    next(it), next(it)
    state = ref.state_dict()
    assert state == {"epoch": 0, "batch": 2}
    rest_ref = list(it) + list(ref)
    fresh = D.DataLoader([x], batch_size=8, seed=3, world=1,
                         use_native=use_native)
    fresh.load_state_dict(state)
    assert fresh.state_dict() == state
    rest = list(fresh) + list(fresh)
    assert len(rest) == len(rest_ref) == 8
    for (a,), (b,) in zip(rest, rest_ref):
        np.testing.assert_array_equal(a, b)
    # JAX's loader resumed from the same state gives the same stream
    jl = JD.DataLoader([x], batch_size=8, seed=3, world=1)
    jl.load_state_dict(state)
    for (a,), (b,) in zip(rest, list(jl) + list(jl)):
        np.testing.assert_array_equal(a, b)


def _write_idx(path, arr):
    arr = np.asarray(arr, np.uint8)
    header = struct.pack(">HBB", 0, 0x08, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(str(path), "wb") as fh:
        fh.write(header + arr.tobytes())


def test_load_mnist_and_cifar10_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    (tmp_path / "m" / "MNIST" / "raw").mkdir(parents=True)
    for root, ext in ((tmp_path / "m" / "MNIST" / "raw", ""),
                      (tmp_path / "g", ".gz")):
        root.mkdir(exist_ok=True)
        for prefix, n in (("train", 32), ("t10k", 8)):
            _write_idx(root / f"{prefix}-images-idx3-ubyte{ext}",
                       rng.randint(0, 256, (n, 28, 28)))
            _write_idx(root / f"{prefix}-labels-idx1-ubyte{ext}",
                       rng.randint(0, 10, (n,)))
    for root in (tmp_path / "m", tmp_path / "g"):
        for split in ("train", "test"):
            a = D.load_mnist(str(root), split=split)
            b = JD.load_mnist(str(root), split=split)
            for u, v in zip(a, b):
                assert u.dtype == v.dtype and u.tobytes() == v.tobytes()
    with pytest.raises(FileNotFoundError):
        D.load_mnist(str(tmp_path / "none"))
    with pytest.raises(ValueError):
        D.load_mnist(str(tmp_path / "m"), split="validation")
    croot = tmp_path / "c" / "cifar-10-batches-py"
    croot.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(croot / name, "wb") as fh:
            pickle.dump({b"data": rng.randint(0, 256, (6, 3072), np.uint8),
                         b"labels": rng.randint(0, 10, (6,)).tolist()}, fh)
    for split in ("train", "test"):
        a = D.load_cifar10(str(tmp_path / "c"), split=split)
        b = JD.load_cifar10(str(tmp_path / "c"), split=split)
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_device_prefetch_on_cpu():
    x, y = _dataset(40, (3,))
    loader = D.DataLoader((x, y), batch_size=8, world=4, rank_major=True,
                          seed=1)
    want = list(JD.DataLoader((x, y), batch_size=8, world=4,
                              rank_major=True, seed=1))
    got = list(D.device_prefetch(loader, device="cpu", depth=2))
    assert len(got) == len(want) == 5
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        assert gx.dtype == torch.uint8 and gy.dtype == torch.int32
        np.testing.assert_array_equal(gx.numpy(), wx)
        np.testing.assert_array_equal(gy.numpy(), wy)
    # dicts and non-array leaves pass through; a short stream ends cleanly
    out = list(D.device_prefetch(iter([{"a": np.ones(2), "n": 3}]),
                                 device="cpu", depth=4))
    assert out[0]["n"] == 3 and out[0]["a"].dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(D.device_prefetch(iter([(x,)])))


def test_use_native_true_raises_when_the_build_fails(tmp_path, monkeypatch):
    # the library as if g++ failed (tests/test_torch_native.py does the same)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "build")
    x = np.zeros((8, 2), np.float32)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        D.DataLoader((x,), batch_size=4, world=1, use_native=True)
    loader = D.DataLoader((x,), batch_size=4, world=1)
    assert not loader.native
    assert [b[0].shape for b in loader] == [(4, 2), (4, 2)]
