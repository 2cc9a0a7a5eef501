"""The port's ``bfrun`` (``python -m bluefog_tpu_torch.run``): the mirrors of
``tests/test_bfrun.py`` for a ``torch.distributed`` job.  Processes stack
ranks on the CPU (``--force-cpu-devices K``, gloo between processes) and
meet in a file store under ``tmp_path``; every spawn has its own timeout
and every group a 60 s one, so a mismatched exchange fails instead of
hanging the suite."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BLUEFOG_", "XLA_", "JAX_"))}
    env.update(PYTHONPATH=REPO, BLUEFOG_TPU_PROCESS_GROUP_TIMEOUT="60")
    return env


def _bfrun(*argv, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run", *argv],
        capture_output=True, text=True, timeout=timeout, env=_env(),
        cwd=REPO)


def _store(tmp_path):
    return f"file://{tmp_path / 'store'}"


def _job(tmp_path, name, body, *argv, timeout=120):
    script = tmp_path / f"{name}.py"
    script.write_text(textwrap.dedent(body))
    return _bfrun(*argv, "--coordinator", _store(tmp_path), sys.executable,
                  str(script), timeout=timeout)


def test_version():
    out = _bfrun("--version")
    assert out.returncode == 0
    assert "bfrun (bluefog_tpu_torch)" in out.stdout


def test_no_command_usage():
    out = _bfrun()
    assert out.returncode == 2


def test_failed_rank_terminates_job(tmp_path):
    """A crashing rank brings the whole launch down (its siblings would
    wait in rendezvous)."""
    out = _job(tmp_path, "crash", """
        import os, sys, time
        if os.environ['BLUEFOG_TPU_PROCESS_ID'] == '0':
            sys.exit(3)
        time.sleep(300)
    """, "-np", "2", timeout=60)
    assert out.returncode != 0
    assert "terminating the job" in out.stderr


TRAIN = """
    import json
    import numpy as np
    import torch
    import torch.distributed as dist

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.context import get_context
    from bluefog_tpu_torch.topology import one_peer_dynamic_schedule

    bf.init()
    n = bf.size()
    assert dist.get_world_size() == 2 and n == 8
    backend = get_context().backend
    rng = np.random.RandomState(0)
    x_true = rng.randn(4)
    As = np.stack([rng.randn(16, 4) for _ in range(n)]).astype(np.float32)
    bs = np.stack([A @ x_true for A in As]).astype(np.float32)

    def loss_fn(params, batch):
        A, b = batch
        return ((A @ params["x"] - b) ** 2).mean()

    params = bf.rank_major({"x": torch.zeros(4)}, backend)
    opt = torch.optim.SGD(params.values(), lr=0.05)
    step = bf.build_train_step(loss_fn, opt, backend, comm_mode="cta",
                               schedule=one_peer_dynamic_schedule(n))
    batch = (bf.rank_sharded(As), bf.rank_sharded(bs))
    losses = []
    for i in range(60):
        params, opt, loss = step(params, opt, batch, i)
        assert loss.shape == (4,)
        losses.append(backend.gather_ranks(loss).tolist())
    assert np.mean(losses[-1]) < np.mean(losses[0])
    if bf.rank() == 0:
        print("LOSSES " + json.dumps(losses))
    print(f"proc {dist.get_rank()} train OK")
"""


def _jax_losses():
    """JAX's build_train_step on the same data over an 8-device mesh."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from bluefog_tpu.optim import functional as F
    from bluefog_tpu.topology import one_peer_dynamic_schedule

    n = 8
    mesh = Mesh(np.array(jax.devices()[:n]), ("bf",))
    rng = np.random.RandomState(0)
    x_true = rng.randn(4)
    As = np.stack([rng.randn(16, 4) for _ in range(n)]).astype(np.float32)
    bs = np.stack([A @ x_true for A in As]).astype(np.float32)

    def loss_fn(params, batch):
        A, b = batch
        return jnp.mean((A @ params["x"] - b) ** 2)

    step = F.build_train_step(loss_fn, optax.sgd(0.05), mesh,
                              comm_mode="cta",
                              schedule=one_peer_dynamic_schedule(n))
    x0 = {"x": jnp.zeros(4, jnp.float32)}
    params = F.rank_major(x0, mesh)
    opt_state = F.rank_major(optax.sgd(0.05).init(x0), mesh)
    sh = NamedSharding(mesh, P("bf"))
    batch = (jax.device_put(jnp.asarray(As), sh),
             jax.device_put(jnp.asarray(bs), sh))
    losses = []
    for i in range(60):
        params, opt_state, loss = step(params, opt_state, batch,
                                       jnp.int32(i))
        losses.append(np.asarray(loss))
    return np.stack(losses)


def test_two_process_training(tmp_path):
    """build_train_step over a ProcessBackend across 2 processes x 4
    ranks: the loss curve of every rank is JAX's build_train_step on the
    same data (f32; 60 cta steps over the one-peer schedule)."""
    out = _job(tmp_path, "train", TRAIN, "-np", "2",
               "--force-cpu-devices", "4")
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("train OK") == 2, out.stdout
    line = next(ln for ln in out.stdout.splitlines() if "LOSSES " in ln)
    got = np.asarray(json.loads(line.split("LOSSES ", 1)[1]))
    want = _jax_losses()
    assert got.shape == want.shape == (60, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """2 processes x 4 ranks: consensus, then the hierarchical exchange
    with a machine per process."""
    tmp = tmp_path_factory.mktemp("world8")
    return _job(tmp, "job", """
        import numpy as np
        import torch.distributed as dist
        import bluefog_tpu_torch as bf
        from bluefog_tpu_torch.topology import RingGraph

        bf.init()
        me = dist.get_rank()
        assert dist.get_world_size() == 2, dist.get_world_size()
        n = bf.size()
        assert n == 8 and bf.rank() == 4 * me, (n, bf.rank())
        x = bf.from_rank_values(lambda r: np.full((4,), float(r)))
        assert tuple(x.shape) == (4, 4)
        for _ in range(30):
            x = bf.neighbor_allreduce(x)
        vals = bf.to_rank_values(x)
        err = max(abs(v - (n - 1) / 2).max() for v in vals)
        assert err < 1e-6, err
        print(f"proc {me} consensus OK")

        assert bf.machine_size() == 2, bf.machine_size()
        assert bf.local_size() == 4, bf.local_size()
        assert bf.machine_rank() == me
        bf.set_machine_topology(RingGraph(bf.machine_size()))
        x = bf.from_rank_values(lambda r: np.full((4,), float(r)))
        vals = np.stack(bf.to_rank_values(
            bf.hierarchical_neighbor_allreduce(x)))
        # machine means 1.5 and 5.5, ring(2) averaging -> 3.5 everywhere
        np.testing.assert_allclose(vals, 3.5, atol=1e-6)
        print(f"proc {me} hier OK")
    """, "-np", "2", "--force-cpu-devices", "4")


def test_two_process_job(world8):
    """World 8 = 2 processes x 4 ranks: cross-process consensus through
    the same public API."""
    assert world8.returncode == 0, world8.stdout + world8.stderr
    assert world8.stdout.count("consensus OK") == 2, world8.stdout


def test_two_process_hierarchical_machine_ops(world8):
    """2 machines of 4 ranks, a machine per process: the exact machine
    mean inside each process, the machine exchange across them, 3.5."""
    assert world8.returncode == 0, world8.stdout + world8.stderr
    assert world8.stdout.count("hier OK") == 2, world8.stdout


@pytest.fixture(scope="module")
def four_procs(tmp_path_factory):
    """4 processes x 2 ranks (world 8): window gossip and push-sum, then
    the ragged neighbor_allgather over a star."""
    tmp = tmp_path_factory.mktemp("four")
    return _job(tmp, "win", """
        import numpy as np
        import torch.distributed as dist
        import bluefog_tpu_torch as bf
        from bluefog_tpu_torch.topology import StarGraph

        bf.init()
        n = bf.size()
        me = dist.get_rank()
        assert dist.get_world_size() == 4 and n == 8

        x = bf.from_rank_values(lambda r: np.full((3,), float(r)))
        bf.win_create(x, "w4")
        for _ in range(30):
            bf.win_put(x, "w4")
            x = bf.win_update("w4")
        vals = np.stack(bf.to_rank_values(x))
        np.testing.assert_allclose(vals, (n - 1) / 2, atol=1e-3)
        bf.win_free("w4")

        bf.turn_on_win_ops_with_associated_p()
        try:
            y = bf.from_rank_values(lambda r: np.full((2,), float(2 * r)))
            bf.win_create(y, "ps4", zero_init=True)
            graph = bf.load_topology()
            out_n = {r: sorted(d for d in graph.successors(r) if d != r)
                     for r in range(n)}
            value = y
            for _ in range(40):
                a = {r: 1.0 / (len(out_n[r]) + 1) for r in range(n)}
                bf.win_accumulate(
                    value, "ps4",
                    self_weight=[a[r] for r in range(n)],
                    dst_weights=[{d: a[r] for d in out_n[r]}
                                 for r in range(n)])
                value = bf.win_update_then_collect("ps4")
            ps = np.array([bf.win_associated_p("ps4", rank=r)
                           for r in range(n)])
            np.testing.assert_allclose(ps.sum(), n, rtol=1e-6)
            debiased = np.stack(bf.to_rank_values(value)) / ps[:, None]
            np.testing.assert_allclose(debiased, n - 1, atol=1e-3)
            bf.win_free("ps4")
        finally:
            bf.turn_off_win_ops_with_associated_p()
        print(f"proc {me} windows OK")

        bf.set_topology(StarGraph(n))
        x = bf.from_rank_values(
            lambda r: np.full((2,), float(r), np.float64))
        out = bf.neighbor_allgather(x)
        # star: center 0 gathers every leaf (in-degree 7), leaves only the
        # center (in-degree 1): a ragged list of this process's 2 ranks
        assert isinstance(out, list) and len(out) == 2
        for i, r in enumerate(range(2 * me, 2 * me + 2)):
            if r == 0:
                want = np.stack([np.full((2,), float(s))
                                 for s in range(1, n)]).reshape(-1)
            else:
                want = np.zeros((2,))
            np.testing.assert_array_equal(out[i].numpy(), want)
        print(f"proc {me} ragged OK")
    """, "-np", "4", "--force-cpu-devices", "2")


def test_four_process_window_gossip(four_procs):
    """win_put/win_update consensus and associated-p push-sum with
    sum(p) == n across 4 processes (reference
    torch_win_ops_test.py:780-863)."""
    assert four_procs.returncode == 0, four_procs.stdout + four_procs.stderr
    assert four_procs.stdout.count("windows OK") == 4, four_procs.stdout


def test_four_process_ragged_neighbor_allgather(four_procs):
    assert four_procs.returncode == 0, four_procs.stdout + four_procs.stderr
    assert four_procs.stdout.count("ragged OK") == 4, four_procs.stdout


def test_four_process_stall_attribution_names_dead_rank(tmp_path):
    """SIGKILL one process mid-job: the survivors' next exchange fails
    (gloo sees the dead peer's socket close) and names the dead process
    from its stale heartbeat (reference operations.cc:388-433 prints the
    missing ranks).  Spawned directly, not through bfrun, so the
    launcher's fail-fast teardown does not reap the survivors first."""
    script = tmp_path / "stall.py"
    script.write_text(textwrap.dedent("""
        import os, signal, time
        import numpy as np
        import bluefog_tpu_torch as bf

        bf.init(device="cpu")
        x = bf.from_rank_values(lambda r: np.full((2,), float(r)))
        np.asarray(bf.to_rank_values(bf.allreduce(x))[0])
        time.sleep(2.0)  # a couple of heartbeats of history
        if bf.rank() == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        bf.allreduce(x, name="post_kill_allreduce")
    """))
    env = dict(_env(), BLUEFOG_TPU_COORDINATOR=_store(tmp_path),
               BLUEFOG_TPU_NUM_PROCESSES="4",
               BLUEFOG_STALL_WARNING_TIME="2")
    children, logs = [], []
    try:
        for pid in range(4):
            log = open(tmp_path / f"rank{pid}.err", "w+")
            logs.append(log)
            children.append(subprocess.Popen(
                [sys.executable, str(script)],
                env=dict(env, BLUEFOG_TPU_PROCESS_ID=str(pid)),
                stdout=subprocess.DEVNULL, stderr=log, cwd=REPO))
        deadline = time.time() + 90
        while time.time() < deadline and any(c.poll() is None
                                             for c in children):
            time.sleep(0.5)
        named = [pid for pid in (0, 1, 3) if "missing process(es) [2]"
                 in (tmp_path / f"rank{pid}.err").read_text()]
        assert named == [0, 1, 3], "\n".join(
            (tmp_path / f"rank{p}.err").read_text()[-800:]
            for p in (0, 1, 3))
        assert children[2].returncode == -signal.SIGKILL
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
            c.wait()
        for log in logs:
            log.close()


def test_restart_port_bind_race_not_charged(tmp_path):
    """A restart epoch that dies to the coordinator port race retries on
    the next candidate port without charging the --restarts budget."""
    import socket

    from bluefog_tpu_torch.run import run as bfrun

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    counter = tmp_path / "runs"
    child = textwrap.dedent(f"""
        import os, pathlib, sys
        p = pathlib.Path({str(counter)!r})
        n = int(p.read_text()) if p.exists() else 0
        p.write_text(str(n + 1))
        if n < 2:
            coord = os.environ["BLUEFOG_TPU_COORDINATOR"]
            print(f"RuntimeError: Failed to bind {{coord}}: "
                  "Address already in use")
            sys.exit(1)
        sys.exit(0)
    """)
    rc = bfrun.main(["-np", "1", "--restarts", "1",
                     "--coordinator", f"127.0.0.1:{port}",
                     sys.executable, "-c", child])
    assert rc == 0
    assert counter.read_text() == "3"


def test_parse_hosts():
    from bluefog_tpu_torch.run.run import parse_hosts

    assert parse_hosts("a:2,b:1") == [("a", 2), ("b", 1)]
    assert parse_hosts(" a:2 , b:3 ") == [("a", 2), ("b", 3)]
    with pytest.raises(ValueError, match="host:slots"):
        parse_hosts("a")
    with pytest.raises(ValueError, match="host:slots"):
        parse_hosts("a:0")
    with pytest.raises(ValueError, match="duplicate"):
        parse_hosts("a:1,a:2")


def test_multihost_np_mismatch_and_restarts_rejected():
    from bluefog_tpu_torch.run import run as bfrun

    assert bfrun.main(["-H", "a:1,b:1", "-np", "3", "--launch-transport",
                       "local", sys.executable, "-c", "pass"]) == 2
    assert bfrun.main(["-H", "a:1,b:1", "--restarts", "1",
                       "--launch-transport", "local",
                       sys.executable, "-c", "pass"]) == 2


def test_multihost_local_transport_job(tmp_path):
    """ONE command starts a 2-'host' (1+2 slot) job through the whole
    multi-host path (per-host launcher, rank offsets from the slot list,
    env/cwd on the launcher's command line) with the ssh hop swapped for
    a local shell; cross-'host' consensus proves the ranks form one
    torch.distributed job."""
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent("""
        import numpy as np
        import torch.distributed as dist
        import bluefog_tpu_torch as bf

        bf.init()
        assert dist.get_world_size() == 3, dist.get_world_size()
        n = bf.size()
        assert n == 3, n
        x = bf.from_rank_values(lambda r: np.full((2,), float(r)))
        for _ in range(40):
            x = bf.neighbor_allreduce(x)
        vals = bf.to_rank_values(x)
        err = max(abs(v - (n - 1) / 2).max() for v in vals)
        assert err < 1e-5, err
        print(f"rank {bf.rank()} of {n} consensus OK")
    """))
    out = _bfrun("-H", "alpha:1,beta:2", "--launch-transport", "local",
                 "--force-cpu-devices", "1",
                 "--coordinator", _store(tmp_path),
                 sys.executable, str(script))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("consensus OK") == 3, out.stdout
    assert "[alpha] [0]" in out.stdout, out.stdout
    assert "[beta] [1]" in out.stdout, out.stdout
    assert "[beta] [2]" in out.stdout, out.stdout


def test_multihost_failfast_teardown(tmp_path):
    """A rank dying on one 'host' takes down every other host's
    launcher."""
    script = tmp_path / "crash.py"
    script.write_text(
        "import os, sys, time\n"
        "if os.environ['BLUEFOG_TPU_PROCESS_ID'] == '2':\n"
        "    sys.exit(5)\n"
        "time.sleep(300)\n")
    out = _bfrun("-H", "alpha:2,beta:1", "--launch-transport", "local",
                 "--coordinator", _store(tmp_path),
                 sys.executable, str(script), timeout=90)
    assert out.returncode != 0
    assert "tearing down the remaining hosts" in out.stderr, out.stderr


def test_multihost_ssh_golden_argv(monkeypatch, tmp_path):
    """The exact ssh remote command line of a -H launch: non-interactive,
    a forced pty, one shell string that cds, sets the whitelisted env
    (TORCH_/NCCL_ pass, others do not) and runs the port's launcher over
    this host's rank window."""
    import shlex

    from bluefog_tpu_torch.run.run import (_host_launcher_argv, _ssh_argv,
                                           make_parser)

    monkeypatch.chdir(tmp_path)
    for k in list(os.environ):
        if k.startswith(("BLUEFOG_", "TORCH_", "NCCL_", "CUDA_", "GLOO_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("BLUEFOG_LOG_LEVEL", "debug")
    monkeypatch.setenv("NCCL_DEBUG", "INFO")
    monkeypatch.setenv("SECRET_TOKEN", "must-not-leak")
    args = make_parser().parse_args(
        ["-H", "user@worker1:2,worker2:2", "--coordinator",
         "worker1:43234", "--extra-env", "FOO=bar",
         "train.py", "--epochs", "3"])
    argv = _host_launcher_argv(
        args, host="worker2", host_rank=1, offset=2, slots=2, total=4,
        coordinator="worker1:43234", command=["train.py", "--epochs", "3"])
    assert argv[:7] == ["ssh", "-o", "BatchMode=yes", "-o",
                        "ConnectTimeout=10", "-tt", "worker2"]
    assert len(argv) == 8
    shell = argv[7]
    assert shell.startswith("cd " + shlex.quote(os.getcwd())
                            + " && exec env ")
    toks = shlex.split(shell.split(" && ", 1)[1])
    env_toks = toks[2:toks.index(sys.executable)]
    assert "BLUEFOG_LOG_LEVEL=debug" in env_toks
    assert "NCCL_DEBUG=INFO" in env_toks
    assert not any(t.startswith("SECRET_TOKEN") for t in env_toks)
    inner = toks[toks.index(sys.executable):]
    assert inner == [sys.executable, "-m", "bluefog_tpu_torch.run",
                     "-np", "4", "--coordinator", "worker1:43234",
                     "--host-rank", "1", "--procs-per-host", "2",
                     "--rank-offset", "2", "--extra-env", "FOO=bar",
                     "--", "train.py", "--epochs", "3"]
    assert _ssh_argv("user@worker1") + ["true"] == [
        "ssh", "-o", "BatchMode=yes", "-o", "ConnectTimeout=10",
        "user@worker1", "true"]


def test_child_env_names_the_job():
    """What a child receives: its identity, its index on the host, and
    under --force-cpu-devices the CPU and its ranks per process."""
    from bluefog_tpu_torch.run.run import _child_env, make_parser

    args = make_parser().parse_args(
        ["-np", "4", "--force-cpu-devices", "3", "--timeline-filename",
         "/tmp/tl", "x.py"])
    env = _child_env(args, 3, 1, "file:///tmp/s", local_id=1)
    assert (env["BLUEFOG_TPU_PROCESS_ID"], env["BLUEFOG_TPU_NUM_PROCESSES"],
            env["BLUEFOG_TPU_LOCAL_PROCESS_ID"],
            env["BLUEFOG_TPU_RESTART_ATTEMPT"]) == ("3", "4", "1", "1")
    assert env["BLUEFOG_OPS_ON_CPU"] == "1"
    assert env["BLUEFOG_TPU_RANKS_PER_PROCESS"] == "3"
    assert env["BLUEFOG_TIMELINE"] == "/tmp/tl"
    assert env["BLUEFOG_TPU_COORDINATOR"] == "file:///tmp/s"
