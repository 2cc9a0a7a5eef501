"""``ibfrun``: the interactive (Jupyter) cluster launcher of the port.

Port of ``bluefog_tpu/run/interactive_run.py`` (host code).  The
reference starts an ipyparallel controller plus engines launched under
mpirun, so every engine is an MPI rank with bluefog initialized; notebook
cells then drive the job with ``%%px``.  Here engines are spawned
directly, each with the environment the port's ``bfrun`` gives a child
(``BLUEFOG_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID,LOCAL_PROCESS_ID}``,
``run/run.py``), which ``bluefog_tpu_torch.init()`` turns into a
``torch.distributed`` job: executing ``import bluefog_tpu_torch as bf;
bf.init()`` on the engines forms the job a ``bfrun`` launch would (engine
``i`` takes card ``i``; with ``--force-cpu-devices K`` each stacks K
ranks on the CPU over gloo).

Two backends:

* ``--backend native`` (default, no dependencies): the engines of
  :mod:`bluefog_tpu_torch.run.engines`, persistent-namespace processes
  on localhost sockets, driven by ``engines.Client(profile)``
  (``client.execute(...)`` / ``client.eval(...)``: the ``%%px``
  execution model without the broker).
* ``--backend ipyparallel``: the reference-style ipcontroller +
  ipengines for notebooks that want real ``%%px`` (requires
  ipyparallel).

State (engine pids and ports, the coordinator address, the engines'
token) is kept in ``<state_dir>/ibfrun_<profile>.json``
(``BLUEFOG_TPU_STATE_DIR``, default ``~/.bluefog_tpu``; the reference
keeps engine pids in the ipython profile dir, interactive_run.py:170-195)
so ``stop`` can tear the cluster down even from a fresh shell.

    python -m bluefog_tpu_torch.run.interactive_run start -np 2
    python -m bluefog_tpu_torch.run.interactive_run stop

A single-process notebook needs none of this: one process stacks every
rank on its card; just ``import bluefog_tpu_torch`` and ``init()``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

from bluefog_tpu_torch import config as bfconfig
from bluefog_tpu_torch.run.run import _child_env

__all__ = ["engine_env", "save_state", "load_state", "clear_state",
           "start_native_cluster", "start_cluster", "stop_cluster", "main"]


def _state_path(profile: str) -> str:
    d = bfconfig.state_dir()
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"ibfrun_{profile}.json")


def engine_env(process_id: int, num_proc: int, coordinator: str,
               force_cpu_devices: Optional[int] = None,
               base_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Environment for engine ``process_id``: the wiring that makes an
    engine a member of the job (the reference gets it from mpirun's rank
    assignment; here the port's ``bfrun`` child environment,
    ``run/run.py`` ``_child_env``: the whitelisted variables of
    ``base_env`` (default this process's), the job's identity, and with
    ``force_cpu_devices`` K ranks stacked per engine on the CPU)."""
    job = SimpleNamespace(num_proc=num_proc,
                          force_cpu_devices=force_cpu_devices,
                          timeline_filename=None, extra_env=[])
    return _child_env(job, process_id, 0, coordinator,
                      local_id=process_id, base_env=base_env)


def _reap(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()


def save_state(profile: str, controller_pid: int, engine_pids: List[int],
               coordinator: str, num_proc: int,
               engine_ports: Optional[List[int]] = None,
               token: Optional[str] = None) -> str:
    path = _state_path(profile)
    state = {"controller_pid": controller_pid,
             "engine_pids": engine_pids,
             "coordinator": coordinator,
             "num_proc": num_proc}
    if engine_ports is not None:
        state["engine_ports"] = engine_ports
    if token is not None:
        state["token"] = token
    with open(path, "w") as f:
        json.dump(state, f)
    # the state file now carries the auth token — owner-only
    os.chmod(path, 0o600)
    return path


def load_state(profile: str) -> Optional[dict]:
    path = _state_path(profile)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def clear_state(profile: str) -> None:
    path = _state_path(profile)
    if os.path.exists(path):
        os.remove(path)


def _kill(pid: int, sig=signal.SIGINT) -> bool:
    try:
        os.kill(pid, sig)
        return True
    except (OSError, ProcessLookupError):
        return False


def start_native_cluster(num_proc: int, profile: str, coordinator: str,
                         force_cpu_devices: Optional[int] = None,
                         engine_ready_timeout: float = 60.0) -> int:
    """Start ``num_proc`` native engines
    (:mod:`bluefog_tpu_torch.run.engines`), dependency-free; drive them
    with ``engines.Client(profile)``.  Returns 0 once every engine has
    announced its port, 1 when one did not within
    ``engine_ready_timeout`` seconds (every engine started is reaped)."""
    import secrets
    import shutil
    import tempfile

    token = secrets.token_hex(16)
    port_dir = tempfile.mkdtemp(prefix="ibfrun_ports_")
    engines = []
    try:
        port_files = []
        for i in range(num_proc):
            env = engine_env(i, num_proc, coordinator, force_cpu_devices)
            env["BLUEFOG_TPU_ENGINE_TOKEN"] = token
            pf = os.path.join(port_dir, f"engine{i}.port")
            port_files.append(pf)
            engines.append(subprocess.Popen(
                [sys.executable, "-m", "bluefog_tpu_torch.run.engines", pf],
                env=env))
        deadline = time.time() + engine_ready_timeout
        ports = []
        for i, pf in enumerate(port_files):
            while not os.path.exists(pf):
                if time.time() > deadline:
                    sys.stderr.write(
                        f"ibfrun: engine {i} did not announce its port "
                        f"within {engine_ready_timeout}s\n")
                    raise TimeoutError
                if engines[i].poll() is not None:
                    sys.stderr.write(
                        f"ibfrun: engine {i} exited "
                        f"({engines[i].returncode}) during startup\n")
                    raise TimeoutError
                time.sleep(0.05)
            with open(pf) as f:
                ports.append(int(f.read().strip()))
    except TimeoutError:
        _reap(engines)
        return 1
    except BaseException:
        # ANY failed start (Popen OSError, Ctrl-C in the wait loop, ...)
        # must not orphan the engines that DID come up: they would
        # squat BLUEFOG_TPU_* rendezvous state with no cluster record
        # for 'stop' to find
        _reap(engines)
        raise
    finally:
        shutil.rmtree(port_dir, ignore_errors=True)
    path = save_state(profile, 0, [p.pid for p in engines], coordinator,
                      num_proc, engine_ports=ports, token=token)
    print(f"ibfrun: started {num_proc} native engines; state in {path}")
    print("Drive them with:\n"
          "  from bluefog_tpu_torch.run.engines import Client\n"
          f"  c = Client(profile={profile!r})\n"
          "  c.execute('import bluefog_tpu_torch as bf; bf.init()')\n"
          "  c.eval('bf.rank()')")
    return 0


def start_cluster(num_proc: int, profile: str, coordinator: str,
                  force_cpu_devices: Optional[int] = None,
                  engine_ready_timeout: float = 60.0) -> int:
    """Start ipcontroller + num_proc wired ipengines.  Returns 0 on
    success.  Requires ipyparallel."""
    controller = subprocess.Popen(
        [sys.executable, "-m", "ipyparallel.controller",
         f"--profile={profile}"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    # the controller writes its connection files asynchronously; engines
    # retry on their own, so a short grace period suffices
    time.sleep(2.0)
    engines = []
    for i in range(num_proc):
        env = engine_env(i, num_proc, coordinator, force_cpu_devices)
        engines.append(subprocess.Popen(
            [sys.executable, "-m", "ipyparallel.engine",
             f"--profile={profile}"],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    path = save_state(profile, controller.pid, [p.pid for p in engines],
                      coordinator, num_proc)
    print(f"ibfrun: started controller (pid {controller.pid}) + "
          f"{num_proc} engines; state in {path}")
    print("In the notebook:\n"
          "  import ipyparallel as ipp\n"
          f"  rc = ipp.Client(profile={profile!r})\n"
          "  %%px\n"
          "  import bluefog_tpu_torch as bf\n"
          "  bf.init()")
    return 0


def stop_cluster(profile: str) -> int:
    state = load_state(profile)
    if state is None:
        sys.stderr.write(f"ibfrun: no running cluster for profile "
                         f"'{profile}'\n")
        return 1
    sig = (signal.SIGTERM if state.get("engine_ports")  # native engines
           else signal.SIGINT)
    for pid in state["engine_pids"]:
        _kill(pid, sig)
    if state.get("controller_pid"):
        _kill(state["controller_pid"])
    clear_state(profile)
    print(f"ibfrun: stopped cluster '{profile}'")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.run.interactive_run",
        description="Interactive bluefog_tpu_torch cluster (reference "
        "interactive_run.py)")
    parser.add_argument("action", choices=["start", "stop"])
    parser.add_argument("-np", "--num-proc", type=int, default=1)
    parser.add_argument("--profile", default="bluefog")
    parser.add_argument("--backend", default="native",
                        choices=["native", "ipyparallel"],
                        help="native: dependency-free engines driven by "
                        "engines.Client; ipyparallel: reference-style "
                        "ipcontroller + %%px (requires ipyparallel)")
    parser.add_argument("--coordinator", default="127.0.0.1:7675",
                        help="where the engines' job meets: host:port (a "
                        "TCP store engine 0 serves) or file://path")
    parser.add_argument("--force-cpu-devices", type=int, default=None,
                        metavar="K",
                        help="stack K ranks per engine on the CPU (testing)")
    args = parser.parse_args(argv)

    if args.action == "stop":
        return stop_cluster(args.profile)
    if args.backend == "native":
        return start_native_cluster(args.num_proc, args.profile,
                                    args.coordinator,
                                    args.force_cpu_devices)
    try:
        import ipyparallel  # noqa: F401
    except ImportError:
        sys.stderr.write(
            "ibfrun --backend ipyparallel requires ipyparallel, which is "
            "not installed; the default --backend native has no "
            "dependencies.\nA single-process notebook needs no ibfrun: "
            "one process stacks every rank on its card; just `import "
            "bluefog_tpu_torch` and init().\n")
        return 1
    return start_cluster(args.num_proc, args.profile, args.coordinator,
                         args.force_cpu_devices)


if __name__ == "__main__":
    sys.exit(main())
