"""The port's ``ibfrun`` (``python -m bluefog_tpu_torch.run.interactive_run``
and ``bluefog_tpu_torch.run.engines``): the counterparts of
tests/test_bfrun.py's three ``ibfrun`` tests.  Engines get the port's
``bfrun`` child environment and state round-trips through the profile's
file; the native engines, started and stopped by the command line, run a
2-process gloo job through ``Client`` whose ``neighbor_allreduce`` is
``StackedBackend(2)``'s bit for bit; a raising cell surfaces as
``EngineError`` with the engine's traceback and a wrong token is refused
before any cell runs."""

import os
import stat
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module (its tiny ops otherwise wait on
    torch's spinning thread pool whenever the host is shared)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_ibfrun_engine_wiring(tmp_path, monkeypatch):
    """ibfrun's engines receive the port's bfrun child contract (the
    wiring that makes ``bf.init()`` on an engine join the job), the
    whitelist passthrough only, and cluster state round-trips through
    an owner-only profile file."""
    from bluefog_tpu_torch.run import interactive_run as ir
    from bluefog_tpu_torch.run.run import _child_env

    monkeypatch.setenv("BLUEFOG_TPU_STATE_DIR", str(tmp_path))
    base = {"PATH": "/bin", "SECRET": "no", "TORCH_FOO": "yes",
            "JAX_FOO": "no"}
    env = ir.engine_env(2, 4, "127.0.0.1:7777", force_cpu_devices=3,
                        base_env=base)
    assert env["BLUEFOG_TPU_PROCESS_ID"] == "2"
    assert env["BLUEFOG_TPU_LOCAL_PROCESS_ID"] == "2"
    assert env["BLUEFOG_TPU_NUM_PROCESSES"] == "4"
    assert env["BLUEFOG_TPU_COORDINATOR"] == "127.0.0.1:7777"
    assert env["BLUEFOG_OPS_ON_CPU"] == "1"
    assert env["BLUEFOG_TPU_RANKS_PER_PROCESS"] == "3"
    assert "SECRET" not in env and "JAX_FOO" not in env
    assert env["TORCH_FOO"] == "yes" and env["PATH"] == "/bin"
    job = SimpleNamespace(num_proc=4, force_cpu_devices=3,
                          timeline_filename=None, extra_env=[])
    assert env == _child_env(job, 2, 0, "127.0.0.1:7777", local_id=2,
                             base_env=base)
    assert "BLUEFOG_OPS_ON_CPU" not in ir.engine_env(0, 1, "h:1",
                                                     base_env=base)

    path = ir.save_state("t", 111, [222, 333], "127.0.0.1:7777", 2)
    assert os.path.dirname(path) == str(tmp_path)
    assert ir.load_state("t") == {
        "controller_pid": 111, "engine_pids": [222, 333],
        "coordinator": "127.0.0.1:7777", "num_proc": 2}
    ir.save_state("t", 0, [1], "c", 1, engine_ports=[5], token="k")
    assert ir.load_state("t")["token"] == "k"
    assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
    ir.clear_state("t")
    assert ir.load_state("t") is None
    assert not os.path.exists(path)


def test_ibfrun_stop_without_cluster(monkeypatch, tmp_path):
    monkeypatch.setenv("BLUEFOG_TPU_STATE_DIR", str(tmp_path))
    from bluefog_tpu_torch.run import interactive_run as ir
    assert ir.stop_cluster("nope") == 1
    assert ir.main(["stop", "--profile", "nope"]) == 1


def _cli(env, log, *argv):
    """``python -m bluefog_tpu_torch.run.interactive_run ...``: its output
    goes to a file, as the engines it starts inherit it and outlive it."""
    with open(log, "a") as out:
        return subprocess.run(
            [sys.executable, "-m", "bluefog_tpu_torch.run.interactive_run",
             *argv], env=env, cwd=REPO, stdout=out,
            stderr=subprocess.STDOUT, timeout=120).returncode


def _stacked_reference(values, rounds):
    """``rounds`` neighbor_allreduce rounds of StackedBackend(2) over the
    eager API's default topology, from per-rank ``values``."""
    import bluefog_tpu_torch as bt

    bt.init(size=2, device="cpu")
    try:
        x = bt.from_rank_values(lambda r: values[r])
        for _ in range(rounds):
            x = bt.neighbor_allreduce(x)
        return np.stack([np.asarray(v) for v in bt.to_rank_values(x)])
    finally:
        bt.shutdown()


def test_native_interactive_cluster(tmp_path, monkeypatch):
    """ibfrun's dependency-free backend end to end, through the command
    line: start 2 native engines (one rank each on the CPU), drive a
    real 2-process gloo job through ``engines.Client`` (the %%px
    execution model), gather each rank's value, which equals
    StackedBackend(2)'s, and tear the cluster down."""
    from bluefog_tpu_torch.run import interactive_run as ir
    from bluefog_tpu_torch.run.engines import Client, EngineError

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BLUEFOG_", "XLA_", "JAX_"))}
    env.update(PYTHONPATH=REPO, BLUEFOG_TPU_STATE_DIR=str(tmp_path),
               BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT="60",
               OMP_NUM_THREADS="1")
    log = tmp_path / "ibfrun.log"
    store = f"file://{tmp_path / 'store'}"
    rc = _cli(env, log, "start", "-np", "2", "--profile", "testprof",
              "--coordinator", store, "--force-cpu-devices", "1")
    assert rc == 0, log.read_text()
    values = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    monkeypatch.setenv("BLUEFOG_TPU_STATE_DIR", str(tmp_path))
    state = {"engine_pids": []}
    try:
        state = ir.load_state("testprof")
        assert len(state["engine_ports"]) == 2 and state["token"]
        c = Client("testprof")
        assert len(c) == 2
        c.execute("import numpy as np\n"
                  "import torch.distributed as dist\n"
                  "import bluefog_tpu_torch as bf\n"
                  "bf.init()")
        assert c.eval("bf.size()") == [2, 2]
        assert c.eval("dist.get_rank()") == [0, 1]
        assert c.eval("bf.rank()") == [0, 1]
        # a collective across the engines (send-to-all, then gather)
        c.execute(f"values = np.array({values.tolist()!r}, np.float32)\n"
                  "x = bf.from_rank_values(lambda r: values[r])\n"
                  "for _ in range(3):\n"
                  "    x = bf.neighbor_allreduce(x)\n"
                  "mine = np.asarray(bf.to_rank_values(x)[bf.rank()])")
        got = np.stack(c.eval("mine"))
        np.testing.assert_array_equal(got, _stacked_reference(values, 3))
        # errors surface with the engine's traceback
        with pytest.raises(EngineError, match="ZeroDivisionError"):
            c.execute("1/0")
        # an engine serves one connection at a time: detach, a wrong
        # token is refused before any cell, and the engine survives both
        c.close()
        with pytest.raises(EngineError, match="rejected"):
            Client(ports=state["engine_ports"], token="wrong")
        c2 = Client("testprof")
        assert c2.eval("1 + 1") == [2, 2]
        c2.close()
    finally:
        assert _cli(env, log, "stop", "--profile", "testprof") == 0, \
            log.read_text()
    assert not (tmp_path / "ibfrun_testprof.json").exists()
    deadline = time.time() + 30
    for pid in state["engine_pids"]:
        while _alive(pid):
            assert time.time() < deadline, f"engine {pid} outlived stop"
            time.sleep(0.05)


def _alive(pid) -> bool:
    """Whether ``pid`` still runs (a zombie, reaped by nobody here since
    the command line that started it has exited, counts as gone)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False
