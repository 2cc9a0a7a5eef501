"""The port's native runtime (bluefog_tpu_torch/native/: the C++ sources
copied from the JAX package, built with g++ into build/torch_native/) and
its timeline writer on the CPU.

* The native writer's Chrome trace equals the Python writer's, and the JAX
  package's, event for event (timestamps aside).
* Under saturation both port writers drop and count: the trace file is a
  FIFO nobody reads until the burst is over, so the writer thread blocks
  and the ring (32768 events) or the queue overflows; every event
  recorded is either in the file or counted as dropped.
* The library's name is keyed by the sources and flags; a failed build
  is remembered, the timeline's default falls back to Python, and an
  explicit ``use_native=True`` raises (the loader's case is in
  ``tests/test_torch_data.py``).
"""

import json
import os
import threading

import pytest

from bluefog_tpu.timeline import Timeline as JTimeline

from bluefog_tpu_torch import native
from bluefog_tpu_torch.timeline import Timeline


def _spans(tl):
    tl.start_activity("tensor_a", "ENQUEUE")
    tl.start_activity("tensor_a", "COMMUNICATE")
    tl.end_activity("tensor_a")
    tl.end_activity("tensor_a")
    tl.instant("neighbor_allreduce")
    tl.start_activity("tensor \"b\"", "MIX\\ED")
    tl.end_activity("tensor \"b\"")
    tl.instant("resilience.rollback")
    tl.close()


def _events(path):
    events = json.loads(open(path).read())
    for e in events:
        assert isinstance(e.pop("ts"), (int, float))
    return events


def test_native_writer_events_equal_python_and_jax(tmp_path):
    assert native.available(), native.build_error()
    assert native.library_path().parent == native.build_dir()
    got = {}
    for backend, make in (("native", lambda p: Timeline(p, 3,
                                                        use_native=True)),
                          ("python", lambda p: Timeline(p, 3,
                                                        use_native=False)),
                          ("jax", lambda p: JTimeline(p, 3,
                                                      use_native=False))):
        tl = make(str(tmp_path / backend))
        if backend != "jax":
            assert tl.backend == backend
        _spans(tl)
        got[backend] = _events(tmp_path / f"{backend}3.json")
    assert got["native"] == got["python"] == got["jax"]
    assert [e["ph"] for e in got["native"]] == ["B", "B", "E", "E", "i",
                                               "B", "E", "i"]


@pytest.mark.parametrize("use_native", [True, False])
def test_saturated_writer_counts_drops(tmp_path, monkeypatch, use_native):
    monkeypatch.setenv("BLUEFOG_TIMELINE_QUEUE_CAPACITY", "1000")
    fifo = str(tmp_path / "sat0.json")
    os.mkfifo(fifo)
    gate = threading.Event()
    chunks = []

    def reader():
        fd = os.open(fifo, os.O_RDONLY)
        gate.wait()
        while True:
            b = os.read(fd, 1 << 16)
            if not b:
                break
            chunks.append(b)
        os.close(fd)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    tl = Timeline(str(tmp_path / "sat"), 0, use_native=use_native)
    total = 40000
    for i in range(total):
        tl.instant(f"ev{i}")
    gate.set()
    tl.close()
    th.join(timeout=30)
    events = json.loads(b"".join(chunks).decode())
    dropped = tl.dropped_events()
    assert dropped > 0
    assert len(events) + dropped == total
    assert events[0]["name"] == "ev0"
    names = [int(e["name"][2:]) for e in events]
    assert names == sorted(names)  # drops lose events, never reorder


def test_failed_build_falls_back_or_raises(tmp_path, monkeypatch):
    # the library as if g++ failed: the process state reset, the compiler
    # a path that does not exist, the build under tmp_path
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "build_dir", lambda: tmp_path / "build")
    assert not native.available()
    assert "no-such-compiler" in native.build_error()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        Timeline(str(tmp_path / "t"), 0, use_native=True)
    tl = Timeline(str(tmp_path / "t"), 0)
    assert tl.backend == "python"
    tl.close()
