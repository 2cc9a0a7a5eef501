"""``bfrun`` of the port: the multi-process launcher of bluefog_tpu_torch.

Port of ``bluefog_tpu/run/run.py``.  The reference's ``bfrun`` wraps
``mpirun`` (reference bluefog/run/run.py:121-203); this one spawns the
processes of a ``torch.distributed`` job and hands each its identity:

* **Local multi-process** (default): spawn ``-np`` processes on this
  host.  With ``--force-cpu-devices K`` each process stacks K ranks on
  the CPU (gloo between processes), the single-host stand-in for a job
  of cards, used by the multi-process test suite.
* **Multi-host, by hand**: run the same ``bfrun`` command on every host
  with ``--host-rank R --coordinator HOST0:PORT``.
* **Multi-host, one command** (``-H host1:2,host2:2``): this ``bfrun``
  ssh-checks every host, then spawns one remote ``bfrun`` per host over
  ssh (cwd + whitelisted env propagated on the remote command line,
  rank offsets from the slot list, coordinator defaulting to the first
  host) and fail-fast tears the whole job down when any host's launcher
  exits nonzero.  ``--launch-transport local`` swaps ssh for a local
  shell (host names become labels), so the whole orchestration path
  runs without sshd.

Child processes receive ``BLUEFOG_TPU_{COORDINATOR,NUM_PROCESSES,
PROCESS_ID}`` and ``BLUEFOG_TPU_LOCAL_PROCESS_ID`` (the index on its
host, whose card ``cuda:<index>`` it takes); ``bluefog_tpu_torch.init()``
joins the job from them (``torch.distributed.init_process_group``: NCCL
for a card, gloo for the CPU).  ``--coordinator`` is ``host:port`` (a TCP
store that process 0 serves) or ``file://path`` (a file store every
process reaches).

Env passthrough mirrors the reference's whitelist behavior
(reference run.py:180-203): BLUEFOG_*, TORCH_*, NCCL_*, CUDA_*, GLOO_*
and the usual PATH/PYTHON* variables are forwarded.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time

from bluefog_tpu_torch import config as bfconfig

PASS_PREFIXES = ("BLUEFOG_", "TORCH_", "NCCL_", "CUDA_", "GLOO_", "PYTHON",
                 "PATH", "HOME", "LD_", "TMPDIR", "VIRTUAL_ENV")


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="bfrun",
        usage="bfrun [options] <command> [args...]",
        description="Launch a bluefog_tpu_torch job (reference bfrun, "
                    "run.py:58-118).")
    parser.add_argument("-v", "--version", action="store_true")
    parser.add_argument("-np", "--num-proc", type=int, default=1,
                        help="total number of processes")
    parser.add_argument("--coordinator", default="127.0.0.1:7675",
                        help="where the processes meet: host:port (a TCP "
                             "store process 0 serves) or file://path (a "
                             "file store)")
    parser.add_argument("--host-rank", type=int, default=0,
                        help="this host's index when launching multi-host "
                             "by hand (process ids are offset by "
                             "host_rank * procs_per_host)")
    parser.add_argument("--procs-per-host", type=int, default=None,
                        help="processes started on THIS host "
                             "(default: num-proc, i.e. single-host)")
    parser.add_argument("--force-cpu-devices", type=int, default=None,
                        metavar="K",
                        help="stack K ranks per process on the CPU "
                             "(testing; sets BLUEFOG_OPS_ON_CPU and "
                             "BLUEFOG_TPU_RANKS_PER_PROCESS)")
    parser.add_argument("--timeline-filename", default=None,
                        help="enable the timeline and write per-rank trace "
                             "files with this prefix (reference "
                             "run.py:106)")
    parser.add_argument("--restarts", type=int, default=0,
                        help="elastic recovery (single-host launches "
                        "only): if a rank dies, tear the job down and "
                        "relaunch it up to this many times (training "
                        "scripts resume from their checkpoint; children "
                        "see BLUEFOG_TPU_RESTART_ATTEMPT, and each "
                        "attempt gets the next bindable coordinator "
                        "port).  Multi-host restart needs a supervisor "
                        "that coordinates every host's epoch — rejected "
                        "here rather than half-working.  The reference "
                        "has no restart story — its watchdog only names "
                        "stalled ranks")
    parser.add_argument("--extra-env", action="append", default=[],
                        metavar="K=V", help="extra env for the children")
    parser.add_argument("-H", "--hosts", default=None,
                        metavar="host1:slots,host2:slots",
                        help="one-command multi-host launch: spawn one "
                             "remote bfrun per host over ssh with rank "
                             "offsets from the slot list (total "
                             "processes = sum of slots; -np may be "
                             "omitted).  The coordinator defaults to "
                             "the FIRST host")
    parser.add_argument("--launch-transport", choices=("ssh", "local"),
                        default="ssh",
                        help="how -H reaches each host: 'ssh' (default) "
                             "or 'local' (spawn every host's launcher "
                             "on this machine — tests/sshd-less setups)")
    parser.add_argument("--no-ssh-check", action="store_true",
                        help="skip the pre-launch ssh reachability check")
    parser.add_argument("--rank-offset", type=int, default=None,
                        help=argparse.SUPPRESS)  # set by the -H parent:
    # first global process id on this host (overrides host_rank *
    # procs_per_host, which assumes uniform slots)
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="the program to run")
    return parser


def parse_hosts(spec: str):
    """``host1:2,host2:2`` -> ``[("host1", 2), ("host2", 2)]`` (the
    reference's -H format, reference run_util.py hosts parsing)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        host, sep, slots = part.rpartition(":")
        if not host or not sep or not slots.isdigit() or int(slots) < 1:
            raise ValueError(
                f"bad -H entry {part!r}: expected host:slots with "
                "slots >= 1")
        out.append((host, int(slots)))
    if len({h for h, _ in out}) != len(out):
        raise ValueError(f"duplicate host in -H list: {spec!r}")
    return out


def _coordinator_for_attempt(coordinator: str, attempt: int) -> str:
    """A fresh meeting point per restart attempt: a file store gets a
    file of its own (the last epoch's may hold its keys).  Fresh port per
    restart attempt: the previous epoch's coordinator
    socket may linger in TIME_WAIT after a crash teardown.  Candidates
    are probed for bindability starting at base+attempt so a port owned
    by another process (e.g. a second job's live coordinator) is skipped
    instead of burning the restart budget.  Ports stay NEAR the base —
    an OS-assigned ephemeral port must not be used here, because between
    this probe and the child's bind it can be claimed as the SOURCE port
    of any outgoing connection on the host (observed: the restarted
    epoch's clients then hang in connect forever).  Single-host only
    (the parent picks the port and every child inherits it through the
    env), which is the scope --restarts is restricted to."""
    if attempt == 0:
        return coordinator
    if coordinator.startswith("file://"):
        return f"{coordinator}.{attempt}"
    import socket

    host, _, port = coordinator.rpartition(":")
    lo = min(int(port) + attempt, 65535)
    for candidate in range(lo, min(lo + 100, 65536)):
        try:
            with socket.socket() as s:
                s.bind((host or "127.0.0.1", candidate))
            return f"{host}:{candidate}"
        except OSError:
            continue
    raise RuntimeError(
        f"no bindable coordinator port within 100 of {port}")


def _child_env(args, process_id: int, attempt: int,
               coordinator: str, local_id: int = 0,
               base_env=None) -> dict:
    """A child's environment: the whitelisted part of this process's (or
    ``base_env``) and the job's identity (``ibfrun``'s engines get the
    same, ``interactive_run.engine_env``)."""
    env = {k: v for k, v in bfconfig.environ_passthrough(base_env).items()
           if k.startswith(PASS_PREFIXES)}
    # the caller resolves the coordinator ONCE per attempt (per-child
    # probing could hand ranks different addresses once rank 0's
    # service binds the first candidate)
    env["BLUEFOG_TPU_COORDINATOR"] = coordinator
    env["BLUEFOG_TPU_NUM_PROCESSES"] = str(args.num_proc)
    env["BLUEFOG_TPU_PROCESS_ID"] = str(process_id)
    env["BLUEFOG_TPU_LOCAL_PROCESS_ID"] = str(local_id)
    env["BLUEFOG_TPU_RESTART_ATTEMPT"] = str(attempt)
    if args.force_cpu_devices:
        env["BLUEFOG_OPS_ON_CPU"] = "1"
        env["BLUEFOG_TPU_RANKS_PER_PROCESS"] = str(args.force_cpu_devices)
    if args.timeline_filename:
        env["BLUEFOG_TIMELINE"] = args.timeline_filename
    for kv in args.extra_env:
        k, _, v = kv.partition("=")
        env[k] = v
    return env


# Child-output markers for the coordinator losing the bind race: the
# probed port can be claimed between the parent's probe and the child's
# bind (TOCTOU) — such an epoch is retried on the next candidate port
# without consuming the --restarts budget.  A marker line must also
# name the coordinator port, so a training script's OWN port collision
# (metrics server etc.) cannot masquerade as the coordinator race (c10d's
# TCP store writes "port: N").
_BIND_FAILURE_MARKERS = ("Address already in use", "EADDRINUSE",
                         "Failed to bind", "address already in use")


def _stream(proc: subprocess.Popen, rank: int, coordinator: str,
            bind_failed: threading.Event):
    port = coordinator.rpartition(":")[2]
    for line in proc.stdout:
        if any(m in line for m in _BIND_FAILURE_MARKERS) \
                and (coordinator in line or f":{port}" in line
                     or f"port: {port}" in line):
            bind_failed.set()
        sys.stdout.write(f"[{rank}]<stdout> {line}")
        sys.stdout.flush()


_TERMINATE_GRACE_S = 5.0


def _supervise(children, describe, terminate_all) -> int:
    """The shared fail-fast poll loop: wait for every child, and on the
    FIRST nonzero exit report it (``describe(index, code)``) and tear
    the rest down — the others may be blocked in collective rendezvous
    waiting for the dead one forever.  A child that ignores SIGTERM
    (e.g. an ssh client hung on a dead connection in the ``-H`` path)
    is SIGKILLed after a grace period so teardown cannot block
    indefinitely.  Returns the first nonzero exit code (or 0)."""
    rc = 0
    term_deadline = None
    alive = list(children)
    while alive:
        for proc in list(alive):
            code = proc.poll()
            if code is None:
                continue
            alive.remove(proc)
            if code != 0 and rc == 0:
                rc = code
                sys.stderr.write(describe(children.index(proc), code))
                terminate_all()
                term_deadline = time.monotonic() + _TERMINATE_GRACE_S
        if alive:
            if term_deadline is not None \
                    and time.monotonic() > term_deadline:
                terminate_all(signal.SIGKILL)
                term_deadline = float("inf")  # escalate once
            time.sleep(0.1)
    return rc


def _run_once(args, command, base_id: int, procs_per_host: int,
              attempt: int, port_bump: int = 0):
    """Returns ``(exit_code, bind_failed)``; exit_code is None for
    KeyboardInterrupt (a sentinel distinct from any child-reachable
    code — never restarted).  ``bind_failed`` reports whether any child
    hit a coordinator bind failure (the probe-to-bind TOCTOU race)."""
    children = []
    threads = []
    bind_failed = threading.Event()

    def _terminate_all(sig=signal.SIGTERM):
        for proc in children:
            if proc.poll() is None:
                try:
                    proc.send_signal(sig)
                except OSError:
                    pass

    coordinator = _coordinator_for_attempt(args.coordinator,
                                           attempt + port_bump)
    try:
        for i in range(procs_per_host):
            env = _child_env(args, base_id + i, attempt, coordinator, i)
            proc = subprocess.Popen(
                command, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            children.append(proc)
            t = threading.Thread(
                target=_stream,
                args=(proc, base_id + i, coordinator, bind_failed),
                daemon=True)
            t.start()
            threads.append(t)
        rc = _supervise(
            children,
            lambda i, code: (f"bfrun: rank {i + base_id} exited with "
                             f"{code}; terminating the job\n"),
            _terminate_all)
        for t in threads:
            t.join(timeout=5)
        return rc, bind_failed.is_set()
    except KeyboardInterrupt:
        _terminate_all(signal.SIGINT)
        for proc in children:
            proc.wait()
        # sentinel distinct from any child exit code (a child exiting
        # 130 must still be eligible for --restarts)
        return None, False
    except Exception:
        _terminate_all()
        raise


def _ssh_argv(host: str, tty: bool = False):
    # BatchMode: fail fast instead of prompting for a password inside a
    # launcher (the reference's ssh checks are likewise non-interactive).
    # tty (-tt): launches run on a forced pty so the REMOTE side is
    # SIGHUP'd when this client dies or is killed — without it, killing
    # the local ssh process orphans every remote rank (non-pty sessions
    # get no hangup; the remote bfrun's SIGHUP->teardown handler in
    # main() would never fire).
    argv = ["ssh", "-o", "BatchMode=yes", "-o", "ConnectTimeout=10"]
    if tty:
        argv.append("-tt")
    return argv + [host]


def check_ssh_reachability(hosts, timeout: float = 20.0):
    """Probe every host with a no-op ssh command IN PARALLEL and raise
    one error naming ALL unreachable hosts (reference run.py's
    _check_all_hosts_ssh_successful behavior: fail before launching
    anything anywhere)."""
    procs = {h: subprocess.Popen(
        _ssh_argv(h) + ["true"], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for h, _ in hosts}
    failed = []
    deadline = time.time() + timeout
    for host, proc in procs.items():
        try:
            rc = proc.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            proc.kill()
            failed.append(f"{host} (timeout)")
            continue
        if rc != 0:
            err = (proc.stderr.read() or "").strip().splitlines()
            failed.append(f"{host} ({err[-1] if err else f'rc {rc}'})")
    if failed:
        raise RuntimeError(
            "bfrun: ssh unreachable: " + "; ".join(failed)
            + ". Every host must accept passwordless ssh (BatchMode), "
            "or use --launch-transport local / --no-ssh-check.")


def _host_launcher_argv(args, host: str, host_rank: int, offset: int,
                        slots: int, total: int, coordinator: str,
                        command) -> list:
    """The per-host process: a remote (or local) bfrun covering this
    host's slot range.  cwd + the whitelisted env ride the command line
    (`cd ... && env K=V ... python -m bluefog_tpu_torch.run ...`), so
    the remote side needs nothing but the repo at the same path."""
    import shlex

    inner = [sys.executable, "-m", "bluefog_tpu_torch.run",
             "-np", str(total), "--coordinator", coordinator,
             "--host-rank", str(host_rank),
             "--procs-per-host", str(slots),
             "--rank-offset", str(offset)]
    if args.force_cpu_devices:
        inner += ["--force-cpu-devices", str(args.force_cpu_devices)]
    if args.timeline_filename:
        inner += ["--timeline-filename", args.timeline_filename]
    for kv in args.extra_env:
        inner += ["--extra-env", kv]
    inner += ["--"] + list(command)
    env_pairs = [f"{k}={v}"
                 for k, v in sorted(bfconfig.environ_passthrough().items())
                 if k.startswith(PASS_PREFIXES)]
    shell = ("cd " + shlex.quote(os.getcwd()) + " && exec env "
             + " ".join(shlex.quote(p) for p in env_pairs) + " "
             + " ".join(shlex.quote(t) for t in inner))
    if args.launch_transport == "local":
        return ["bash", "-c", shell]
    return _ssh_argv(host, tty=True) + [shell]


def _run_multihost(args, command) -> int:
    try:
        hosts = parse_hosts(args.hosts)
    except ValueError as e:
        sys.stderr.write(f"bfrun: {e}\n")
        return 2
    total = sum(s for _, s in hosts)
    if args.num_proc not in (1, total):
        sys.stderr.write(
            f"bfrun: -np {args.num_proc} does not match the -H slot "
            f"total {total} (omit -np with -H)\n")
        return 2
    if args.restarts:
        sys.stderr.write(
            "bfrun: --restarts only supports single-host launches "
            "(multi-host elastic restart needs a cross-host "
            "supervisor)\n")
        return 2
    coordinator = args.coordinator
    if args.launch_transport == "ssh" and \
            coordinator.startswith("127.0.0.1:"):
        # the default loopback coordinator is meaningless across hosts:
        # rendezvous on the first host — minus any ssh login name
        # (-H user@host:2 is the common mpirun-style spec, but
        # 'user@host' is not a resolvable rendezvous address)
        first = hosts[0][0].rpartition("@")[2]
        coordinator = first + ":" + coordinator.rpartition(":")[2]
    if args.launch_transport == "ssh" and not args.no_ssh_check:
        try:
            check_ssh_reachability(hosts)
        except RuntimeError as e:
            sys.stderr.write(str(e) + "\n")
            return 2

    children, threads = [], []

    def _terminate_all(sig=signal.SIGTERM):
        for proc in children:
            if proc.poll() is None:
                try:
                    proc.send_signal(sig)
                except OSError:
                    pass

    def _stream_host(proc, host):
        for line in proc.stdout:
            sys.stdout.write(f"[{host}] {line}")
            sys.stdout.flush()

    offset = 0
    try:
        for i, (host, slots) in enumerate(hosts):
            argv = _host_launcher_argv(args, host, i, offset, slots,
                                       total, coordinator, command)
            proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            children.append(proc)
            t = threading.Thread(target=_stream_host, args=(proc, host),
                                 daemon=True)
            t.start()
            threads.append(t)
            offset += slots
        # a host's launcher exiting nonzero already tore down its own
        # local ranks; take the other hosts with it
        rc = _supervise(
            children,
            lambda i, code: (f"bfrun: host {hosts[i][0]} exited with "
                             f"{code}; tearing down the remaining "
                             "hosts\n"),
            _terminate_all)
        for t in threads:
            t.join(timeout=5)
        return rc
    except KeyboardInterrupt:
        _terminate_all(signal.SIGINT)
        for proc in children:
            proc.wait()
        return 130
    except Exception:
        _terminate_all()
        raise


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    if args.version:
        from bluefog_tpu_torch.version import __version__
        print(f"bfrun (bluefog_tpu_torch) {__version__}")
        return 0
    if not args.command:
        make_parser().print_usage()
        return 2

    command = args.command
    if command and command[0] == "--":
        command = command[1:]

    # a dropped controlling connection (ssh teardown from a multi-host
    # parent) or a TERM must take the local ranks down with us, exactly
    # like Ctrl-C
    def _teardown_signal(signum, frame):
        raise KeyboardInterrupt

    for _sig in (signal.SIGTERM, signal.SIGHUP):
        try:
            signal.signal(_sig, _teardown_signal)
        except (ValueError, OSError):  # non-main thread / platform quirk
            pass

    if args.hosts:
        return _run_multihost(args, command)

    procs_per_host = args.procs_per_host or args.num_proc
    base_id = args.rank_offset if args.rank_offset is not None \
        else args.host_rank * procs_per_host
    if base_id + procs_per_host > args.num_proc:
        sys.stderr.write("bfrun: host-rank/procs-per-host exceed -np\n")
        return 2
    if args.restarts and procs_per_host != args.num_proc:
        # A remote rank's death is invisible to this host's monitor (its
        # local children just block in rendezvous), and a restarted host
        # would rendezvous on a port the surviving hosts never learn —
        # refuse rather than hang half a pod.
        sys.stderr.write(
            "bfrun: --restarts only supports single-host launches "
            "(multi-host elastic restart needs a cross-host supervisor)\n")
        return 2

    attempt = 0
    port_bump = 0
    while True:
        rc, bind_failed = _run_once(args, command, base_id,
                                    procs_per_host, attempt, port_bump)
        if rc is None:  # KeyboardInterrupt: never restart
            return 130
        if rc != 0 and bind_failed and args.restarts and port_bump < 5:
            # probe-to-bind TOCTOU: another process claimed the probed
            # coordinator port first.  The epoch never really started —
            # move to the next candidate port without charging the
            # elastic-restart budget.
            port_bump += 1
            sys.stderr.write(
                "bfrun: coordinator lost the port bind race; retrying "
                f"on the next candidate (+{port_bump})\n")
            time.sleep(0.5)
            continue
        if rc == 0 or attempt >= args.restarts:
            return rc
        attempt += 1
        sys.stderr.write(
            f"bfrun: job failed (rc {rc}); elastic restart "
            f"{attempt}/{args.restarts} — children resume from their "
            "checkpoints\n")
        time.sleep(1.0)


if __name__ == "__main__":
    sys.exit(main())
