"""Native interactive engines: ``ibfrun``'s self-contained backend.

Port of ``bluefog_tpu/run/engines.py`` (host code, copied).  The
reference's ``ibfrun`` drives notebook workflows through ipyparallel
(reference bluefog/run/interactive_run.py: ipcontroller + mpirun'd
ipengines + ``%%px``).  ipyparallel is an optional external dependency;
this module is the dependency-free equivalent: each engine is a plain
process holding a persistent namespace and listening on a localhost
socket; the :class:`Client` broadcasts code to every engine and gathers
results: the ``%%px`` execution model without the broker.

Engines receive the same ``BLUEFOG_TPU_*`` wiring as the port's
``bfrun`` children (see ``interactive_run.engine_env``), so ``import
bluefog_tpu_torch as bf; bf.init()`` executed through the client forms
a real multi-process ``torch.distributed`` job (a card per engine, or
gloo on the CPU).  Because the client SENDS to every engine before
READING any reply, collective operations work: all engines enter the
collective concurrently.

Transport is length-prefixed pickle over 127.0.0.1 sockets.  Every
connection must authenticate with the cluster's random token (generated
at ``ibfrun start``, stored in the profile state file and handed to the
engines through their environment) before any exec/eval is accepted:
without it, any local user could connect to the port and run code as
the engine owner.  The handshake is a fixed-length RAW-BYTES HMAC
challenge/response (engine sends a random nonce, client returns
``HMAC-SHA256(token, nonce)``, compared with ``hmac.compare_digest``):
no pickle is deserialized until after auth succeeds, so an unauthorized
peer can never reach ``pickle.loads`` with attacker bytes, and the
token itself never crosses the socket.  Do not expose the ports beyond
localhost.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import pickle
import socket
import struct
import sys
import traceback
from typing import Any, List, Optional

from bluefog_tpu_torch import config as bfconfig

__all__ = ["Client", "EngineError", "engine_main"]

_LEN = struct.Struct(">Q")


def _send(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise EOFError("engine connection closed")
        buf += chunk
    return bytes(buf)


def _recv(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _LEN.size)
    n = _LEN.unpack(header)[0]
    return pickle.loads(_recv_exact(sock, n))


_NONCE_LEN = 32
_MAC_LEN = hashlib.sha256().digest_size


def _auth_mac(token: str, nonce: bytes) -> bytes:
    return hmac.new(token.encode(), nonce, hashlib.sha256).digest()


def engine_main(port_file: str) -> None:
    """Engine process entry: listen on an ephemeral localhost port
    (announced atomically through ``port_file``), then serve exec/eval
    requests against one persistent namespace until shutdown.  Every
    connection must authenticate first (``BLUEFOG_TPU_ENGINE_TOKEN``)."""
    token = bfconfig.engine_token()
    ns: dict = {"__name__": "__bluefog_engine__"}
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    with open(port_file + ".tmp", "w") as f:
        f.write(str(port))
    os.replace(port_file + ".tmp", port_file)
    while True:
        conn, _ = srv.accept()
        try:
            # Fixed-length raw-bytes challenge/response BEFORE any
            # pickle touches the wire: an unauthenticated peer must
            # never reach pickle.loads (arbitrary-code gadget).
            nonce = os.urandom(_NONCE_LEN)
            conn.sendall(nonce)
            mac = _recv_exact(conn, _MAC_LEN)
            if not hmac.compare_digest(mac, _auth_mac(token, nonce)):
                conn.sendall(b"\x00")
                conn.close()
                continue
            conn.sendall(b"\x01")
            while True:
                msg = _recv(conn)
                op = msg.get("op")
                if op == "shutdown":
                    _send(conn, {"ok": True})
                    conn.close()
                    os._exit(0)
                try:
                    if op == "exec":
                        exec(msg["code"], ns)
                        _send(conn, {"ok": True})
                    elif op == "eval":
                        _send(conn, {"ok": True,
                                     "value": eval(msg["expr"], ns)})
                    else:
                        _send(conn, {"ok": False,
                                     "error": f"unknown op {op!r}"})
                except Exception:
                    _send(conn, {"ok": False,
                                 "error": traceback.format_exc()})
        except (EOFError, OSError):
            # client went away (clean close OR reset/broken pipe with
            # data in flight — e.g. a killed notebook kernel); await a
            # new connection rather than dying with the job state
            try:
                conn.close()
            except OSError:
                pass


class EngineError(RuntimeError):
    """A cell failed on one or more engines (their tracebacks in the
    message), or an engine refused the client's token."""


class Client:
    """Drive a running native-engine cluster (``ibfrun start``).

    ``Client(profile).execute("import bluefog_tpu_torch as bf; bf.init()")``
    runs on every engine concurrently; :meth:`eval` gathers per-engine
    values (which must be picklable: fetch numpy or host tensors).
    """

    def __init__(self, profile: str = "bluefog",
                 ports: Optional[List[int]] = None,
                 token: Optional[str] = None):
        if ports is None or token is None:
            from bluefog_tpu_torch.run.interactive_run import load_state

            state = load_state(profile)
            if state is None or "engine_ports" not in state:
                raise FileNotFoundError(
                    f"no native engine cluster for profile '{profile}' — "
                    "start one with: ibfrun start -np N")
            ports = ports if ports is not None else state["engine_ports"]
            token = token if token is not None else state.get("token", "")
        self._socks = []
        try:
            for port in ports:
                s = socket.create_connection(("127.0.0.1", port),
                                             timeout=60)
                # the connect timeout must not persist per-operation: a
                # cell running longer than it would raise mid-protocol
                # and desynchronize the request/reply stream
                s.settimeout(None)
                self._socks.append(s)
                nonce = _recv_exact(s, _NONCE_LEN)
                s.sendall(_auth_mac(token, nonce))
                status = _recv_exact(s, 1)
                if status != b"\x01":
                    raise EngineError(
                        f"engine on port {port} rejected the client: "
                        "bad auth token")
        except BaseException:
            self.close()
            raise

    def __len__(self):
        return len(self._socks)

    def _broadcast(self, msg: dict) -> List[dict]:
        # send-to-all BEFORE read-any: engines may be entering a
        # collective that only completes once every engine runs it
        for s in self._socks:
            _send(s, msg)
        return [_recv(s) for s in self._socks]

    def _raise_on_error(self, replies: List[dict], what: str):
        errors = [(i, r["error"]) for i, r in enumerate(replies)
                  if not r.get("ok")]
        if errors:
            detail = "\n".join(f"--- engine {i} ---\n{e}"
                               for i, e in errors)
            raise EngineError(f"{what} failed on "
                              f"{len(errors)}/{len(replies)} engines:\n"
                              f"{detail}")

    def execute(self, code: str) -> None:
        """Run ``code`` on every engine (persistent namespace)."""
        self._raise_on_error(self._broadcast({"op": "exec", "code": code}),
                             f"execute({code!r})")

    def eval(self, expr: str) -> List[Any]:
        """Evaluate ``expr`` on every engine; returns per-engine values."""
        replies = self._broadcast({"op": "eval", "expr": expr})
        self._raise_on_error(replies, f"eval({expr!r})")
        return [r["value"] for r in replies]

    def shutdown(self) -> None:
        """Terminate every engine process (best-effort per engine: one
        dead engine must not keep the others running)."""
        for s in self._socks:
            try:
                _send(s, {"op": "shutdown"})
            except OSError:
                pass
        for s in self._socks:
            try:
                _recv(s)
            except (OSError, EOFError):
                pass
        self.close()

    def close(self) -> None:
        for s in self._socks:
            try:
                s.close()
            except OSError:
                pass
        self._socks = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


if __name__ == "__main__":
    engine_main(sys.argv[1])
