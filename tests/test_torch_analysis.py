"""The port's analyzer lint (``bluefog_tpu_torch.analysis``) against the
JAX package's (``bluefog_tpu.analysis``).

* **Rules copied as they are** -- each fixture, positive and negative,
  gives the same (rule, line, symbol) findings from JAX's ``lint_file``
  and the port's.
* **Rules re-scoped to torch** -- ``host-sync-in-step`` and
  ``python-if-on-tensor`` (JAX's ``host-sync-in-jit`` and
  ``python-if-on-traced``) on their own fixtures: an
  ``autograd.Function.backward`` with ``.item()``, a checkpointed body
  with ``if t.any():``, a config ``if causal:`` left alone.
* **The real tree** is clean modulo the port's baseline, with no stale
  entry; the CLI's exit codes and the baseline round-trip; the weight
  authority modules are marked; the decision-plane registry is live.
"""

import os
import textwrap

import pytest
import torch

from bluefog_tpu.analysis import lint as JL
from bluefog_tpu_torch.analysis import (Finding, load_baseline,
                                        split_suppressed)
from bluefog_tpu_torch.analysis import lint as L

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PKG = dict(in_package=True, in_benchmarks=False, in_tests=False)
_BM = dict(in_package=False, in_benchmarks=True, in_tests=False)
_TST = dict(in_package=False, in_benchmarks=False, in_tests=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(tmp_path, src, *, markers=frozenset(), **flags):
    """(port findings, JAX findings) of one fixture, as (rule, line,
    symbol) triples."""
    p = tmp_path / "fixture.py"
    p.write_text(textwrap.dedent(src))
    out = []
    for lint in (L, JL):
        fs = lint.lint_file(str(p), "fixture.py", markers=set(markers),
                            **flags)
        out.append([(f.rule, f.line, f.symbol) for f in fs])
    return out


def _same(tmp_path, src, **kw):
    port, jax = _both(tmp_path, src, **kw)
    assert port == jax
    return port


# ------------------------------------------------------------------ #
# rules copied as they are: the same findings as JAX's lint
# ------------------------------------------------------------------ #

def test_rule_env_read(tmp_path):
    fs = _same(tmp_path, """
        import os
        A = os.environ.get('X')
        def f():
            return os.getenv('Y')
        """, **_PKG)
    assert [f[0] for f in fs] == ["env-read-outside-config"] * 2
    assert fs[1][2] == "f"
    assert _same(tmp_path, """
        from bluefog_tpu_torch import config as bfconfig
        A = bfconfig.coordinator()
        """, **_PKG) == []


def test_rule_weight_bypass(tmp_path):
    fs = _same(tmp_path, """
        import numpy as np
        comm_weights = np.ones((4, 4)) / 4
        route_table = np.zeros((8, 4))
        capacity_mask = np.ones((8,))
        """, **_PKG)
    assert [f[0] for f in fs] == ["weight-matrix-bypass"] * 3
    for ok in ("""
        from bluefog_tpu_torch.optim import functional as F
        comm_weights = F.comm_weight_inputs(specs)
        route_table = heal_route_table(default_route_table(8, 4), d, 4)
        capacity_mask = capacity_mask_of(dead)
        """, """
        _WEIGHT_AUTHORITY = True
        import numpy as np
        comm_weights = np.ones((4, 4)) / 4
        """, """
        import numpy as np
        biases = np.ones((4,))
        """):
        assert _same(tmp_path, ok, **_PKG) == []


def test_rule_weight_swap_boundary(tmp_path):
    fs = _same(tmp_path, """
        def hotfix(comm_weights, delta):
            comm_weights[0] = delta
            obj.class_weights[1, :] = 0.0
            self_weights += delta
        """, **_PKG)
    assert [f[0] for f in fs] == ["weight-swap-outside-boundary"] * 3
    for ok in ("""
        def swap_comm_weights(plane, dead_mask):
            comm_weights[0] = plane.next_round()
            return comm_weights
        """, """
        _WEIGHT_AUTHORITY = True
        def build(comm_weights):
            comm_weights[0] = 1.0
        """, """
        def deliver(specs, dead):
            comm_weights = healed_comm_weights(specs, dead)
            return comm_weights
        """, """
        def f(table):
            table[0] = 1.0
            table += 2.0
        """):
        assert _same(tmp_path, ok, **_PKG) == []


def test_rule_unseeded_randomness(tmp_path):
    fs = _same(tmp_path, """
        import numpy as np
        x = np.random.randn(4)
        rng = np.random.default_rng(0)
        y = rng.normal(size=3)
        z = np.random.RandomState(7).rand(2)
        """, **_BM)
    assert [f[0] for f in fs] == ["unseeded-randomness"]


def test_rule_unregistered_marker(tmp_path):
    fs = _same(tmp_path, """
        import pytest
        @pytest.mark.slow
        @pytest.mark.parametrize("x", [1])
        @pytest.mark.gpu_only
        def test_a(x):
            pass
        """, markers={"slow"}, **_TST)
    assert [f[0] for f in fs] == ["unregistered-pytest-marker"]


def test_rule_sleep_without_backoff(tmp_path):
    fs = _same(tmp_path, """
        import time
        def retry_submit(engine, req):
            for attempt in range(3):
                time.sleep(0.1 * attempt)
        def poll(engine):
            while not engine.idle():
                time.sleep(0.05)
        """, in_serving=True, **_PKG)
    assert sorted(f[2] for f in fs) == ["poll", "retry_submit"]
    assert {f[0] for f in fs} == {"sleep-without-backoff"}
    assert _same(tmp_path, """
        import time
        def retry_submit(self, req):
            for attempt in range(3):
                backoff_sleep(attempt, base=0.05, seed=0, salt=req.rid)
        def stall(self, seconds):
            while self.waiting():
                self._sleep(seconds)
        def settle():
            time.sleep(0.2)
        """, in_serving=True, **_PKG) == []
    assert _same(tmp_path, """
        import time
        def spin():
            while True:
                time.sleep(1.0)
        """, in_serving=False, **_PKG) == []


def test_rule_wallclock_in_sim(tmp_path):
    fs = _same(tmp_path, """
        import time
        from time import perf_counter as pc
        def stamp(log):
            log.record(time.time(), 'tick')
        def measure():
            t0 = pc()
            return time.monotonic_ns() - t0
        """, in_sim=True, **_PKG)
    assert sorted(f[2] for f in fs) == ["measure", "measure", "stamp"]
    assert _same(tmp_path, """
        import time
        def calibrate(engine, timer):
            t0 = timer()
            engine.step()
            return timer() - t0
        def nap():
            time.sleep(0.1)
        """, in_sim=True, **_PKG) == []


def test_rule_decision_outside_recorder(tmp_path):
    fs = _same(tmp_path, """
        class Plane:
            def on_step(self, step):
                self.state = 'SWAPPED'
                return step
            def admit(self, rank):
                self.members.add(rank)
        """, plane_methods={"on_step", "admit"}, **_PKG)
    assert sorted(f[2] for f in fs) == ["admit", "on_step"]
    assert {f[0] for f in fs} == {"decision-outside-recorder"}
    assert _same(tmp_path, """
        class Plane:
            def on_step(self, step):
                record_decision('topology', 'swap', step=step)
            def admit(self, rank):
                self._decide('membership', 'admit', rank)
            def kick(self, rank):
                def _emit():
                    return self._decide('membership', 'kick', rank)
                return _emit()
        """, plane_methods={"on_step", "admit", "kick"}, **_PKG) == []


def test_package_defaults_are_rekeyed(tmp_path):
    """The serving/sim rules and the registry default from the port's
    paths, as JAX's do from its own."""
    src = tmp_path / "x.py"
    src.write_text("import time\ndef f():\n    while True:\n"
                   "        time.sleep(1)\n    return time.time()\n")
    rules = {rel: {f.rule for f in L.lint_file(str(src), rel,
                                               markers=set(), **_PKG)}
             for rel in ("bluefog_tpu_torch/serving/x.py",
                         "bluefog_tpu_torch/sim/x.py",
                         "bluefog_tpu/serving/x.py")}
    assert rules == {"bluefog_tpu_torch/serving/x.py":
                     {"sleep-without-backoff"},
                     "bluefog_tpu_torch/sim/x.py": {"wallclock-in-sim"},
                     "bluefog_tpu/serving/x.py": set()}
    assert set(L._DECISION_PLANE_METHODS) == {
        k.replace("bluefog_tpu/", "bluefog_tpu_torch/", 1)
        for k in JL._DECISION_PLANE_METHODS}


# ------------------------------------------------------------------ #
# the re-scoped rules: host-sync-in-step, python-if-on-tensor
# ------------------------------------------------------------------ #

def _port(tmp_path, src):
    p = tmp_path / "fixture.py"
    p.write_text(textwrap.dedent(src))
    return [(f.rule, f.symbol) for f in L.lint_file(
        str(p), "fixture.py", markers=set(), **_PKG)]


def test_rule_host_sync_in_step(tmp_path):
    fs = _port(tmp_path, """
        import numpy as np
        import torch
        from torch.utils.checkpoint import checkpoint

        class _Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * 2
            @staticmethod
            def backward(ctx, g):
                scale = g.abs().max().item()
                return g * scale

        def body(x, n):
            def inner(y):
                return np.asarray(y)
            torch.cuda.synchronize()
            return inner(x) + float(n)

        def run(x):
            return checkpoint(body, x, 3, use_reentrant=False)

        @torch.compile
        def fused(x):
            return x.cpu()

        def graphed(g, x):
            with torch.cuda.graph(g):
                y = x.tolist()
            return y
        """)
    assert fs == [("host-sync-in-step", "_Op.backward"),
                  ("host-sync-in-step", "body.inner"),
                  ("host-sync-in-step", "body"),
                  ("host-sync-in-step", "body"),
                  ("host-sync-in-step", "fused"),
                  ("host-sync-in-step", "graphed")]
    # host code, literals, torch.autograd.grad (not a transform) and
    # re.compile are left alone
    assert _port(tmp_path, """
        import re
        import torch
        PAT = 'x'
        def host(x):
            return float(x), x.item()
        def step(loss, params):
            return torch.autograd.grad(loss, params)
        def fwd(x):
            return x + float(1e-6)
        r = re.compile(PAT)
        out = torch.utils.checkpoint.checkpoint(fwd, 1)
        """) == []


def test_rule_python_if_on_tensor(tmp_path):
    fs = _port(tmp_path, """
        import torch
        from torch.utils.checkpoint import checkpoint

        def body(t: torch.Tensor, causal: bool):
            if t.any():
                t = t + 1
            if causal:
                t = t * 2
            return t

        class _Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x: torch.Tensor, scale):
                if x.sum().item() > 0:
                    x = x * scale
                if scale:
                    x = x + 1
                return x

        def run(x):
            return checkpoint(body, x, True, use_reentrant=False)
        """)
    assert ("python-if-on-tensor", "body") in fs
    assert ("python-if-on-tensor", "_Op.forward") in fs
    assert sorted(fs) == sorted([("python-if-on-tensor", "body"),
                                 ("python-if-on-tensor", "_Op.forward"),
                                 ("host-sync-in-step", "_Op.forward")])
    # an annotated tensor parameter read by an `if`: flagged; a config
    # `if causal:` in the same body is not
    fs = _port(tmp_path, """
        import torch
        @torch.compile
        def f(x: torch.Tensor, causal):
            if causal:
                return x
            if x:
                return -x
            return x
        """)
    assert fs == [("python-if-on-tensor", "f")]


# ------------------------------------------------------------------ #
# the real tree, the baseline, the CLI
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def repo_cli():
    """``main(["--no-step"])`` from the repo's root, run once: its exit
    code, and the root its lint pass scanned with every finding that pass
    gave (the one scan of the real tree these tests make)."""
    from bluefog_tpu_torch.analysis.__main__ import main

    real = L.run_lint
    scans = []

    def recording(root):
        found = real(root)
        scans.append((root, found))
        return found

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "run_lint", recording)
        mp.chdir(_REPO)
        rc = main(["--no-step"])
    assert len(scans) == 1
    return rc, scans[0][0], scans[0][1]


def test_lint_repo_clean_modulo_baseline(repo_cli, tmp_path):
    _, root, findings = repo_cli
    assert os.path.samefile(root, _REPO)
    active, suppressed = split_suppressed(findings, load_baseline())
    assert active == [], "\n".join(f.render() for f in active)
    # every baseline key still matches a real finding (none stale)
    live = {f.key() for f in suppressed}
    for key in load_baseline():
        assert key in live, f"stale baseline entry: {key}"
    # the scan covers the package, the tests and the measuring script:
    # one rogue line in each of a temporary root's three is reported
    (tmp_path / "bluefog_tpu_torch").mkdir()
    (tmp_path / "bluefog_tpu_torch" / "rogue.py").write_text(
        "import os\nX = os.getenv('A')\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_rogue.py").write_text(
        "import pytest\n\n\n@pytest.mark.rogue\ndef test_a():\n"
        "    pass\n")
    (tmp_path / "chip_smoke.py").write_text(
        "import numpy as np\nX = np.random.randn(3)\n")
    got = {(f.rule, f.path) for f in L.run_lint(str(tmp_path))}
    assert got == {
        ("env-read-outside-config", "bluefog_tpu_torch/rogue.py"),
        ("unregistered-pytest-marker", "tests/test_rogue.py"),
        ("unseeded-randomness", "chip_smoke.py")}, got


def test_baseline_entries_carry_a_reason():
    path = os.path.join(_REPO, "bluefog_tpu_torch", "analysis",
                        "baseline.txt")
    lines = open(path).read().splitlines()
    for i, raw in enumerate(lines):
        key = raw.split("#", 1)[0].strip()
        if key:
            above = lines[i - 1].strip() if i else ""
            assert "#" in raw or above.startswith("#"), raw


def test_cli_exits_zero_on_clean_repo(repo_cli):
    assert repo_cli[0] == 0


def test_cli_exit_nonzero_on_finding(tmp_path, monkeypatch):
    from bluefog_tpu_torch.analysis.__main__ import main

    bad = tmp_path / "bluefog_tpu_torch"
    bad.mkdir()
    (bad / "rogue.py").write_text("import os\nX = os.getenv('A')\n")
    (tmp_path / "pyproject.toml").write_text("[project]\n")
    monkeypatch.chdir(tmp_path)
    assert main(["--no-step"]) == 1
    base = tmp_path / "baseline.txt"
    base.write_text("env-read-outside-config bluefog_tpu_torch/rogue.py"
                    "::<module>  # vetted\n")
    assert main(["--no-step", "--baseline", str(base)]) == 0
    # --root names the tree wherever the CLI runs from
    monkeypatch.chdir(_REPO)
    assert main(["--no-step", "--root", str(tmp_path)]) == 1
    assert main(["--no-step", "--root", str(tmp_path), "--baseline",
                 str(base)]) == 0


def test_cli_step_sweep_needs_the_card_or_device_cpu(monkeypatch):
    from bluefog_tpu_torch.analysis.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    monkeypatch.chdir(_REPO)
    assert main(["--no-lint"]) == 2


def test_baseline_round_trip(tmp_path):
    f1 = Finding("env-read-outside-config", "bluefog_tpu_torch/a.py", 12,
                 "f", "msg")
    f2 = Finding("host-sync-in-step", "bluefog_tpu_torch/b.py", 3, "g",
                 "msg")
    base = tmp_path / "baseline.txt"
    base.write_text(f"# comment line\n{f1.key()}  # vetted because X\n")
    keys = load_baseline(str(base))
    assert keys == [f1.key()]
    active, suppressed = split_suppressed([f1, f2], keys)
    assert suppressed == [f1] and active == [f2]
    f1_moved = Finding(f1.rule, f1.path, 99, f1.symbol, f1.message)
    active, suppressed = split_suppressed([f1_moved], keys)
    assert suppressed == [f1_moved] and active == []


def test_weight_authority_modules_are_marked():
    import bluefog_tpu_torch.elastic.membership as m1
    import bluefog_tpu_torch.moe.dispatch as m2
    import bluefog_tpu_torch.moe.layer as m3
    import bluefog_tpu_torch.optim.functional as m4
    import bluefog_tpu_torch.parallel.collectives as m5
    import bluefog_tpu_torch.resilience.healing as m6
    import bluefog_tpu_torch.topology.spec as m7

    for mod in (m1, m2, m3, m4, m5, m6, m7):
        assert getattr(mod, "_WEIGHT_AUTHORITY", False) is True, mod


def test_decision_plane_registry_live_on_real_tree():
    for rel, methods in sorted(L._DECISION_PLANE_METHODS.items()):
        path = os.path.join(_REPO, rel)
        assert os.path.exists(path), rel
        src = open(path).read()
        for name in sorted(methods):
            assert f"def {name}(" in src, f"{rel}: {name} missing"
        fs = L.lint_file(path, rel, markers=set(), **_PKG)
        bad = [f for f in fs if f.rule == "decision-outside-recorder"]
        assert bad == [], "\n".join(f.render() for f in bad)


def test_sim_package_has_no_wallclock_reads():
    base = os.path.join(_REPO, "bluefog_tpu_torch", "sim")
    for fn in sorted(os.listdir(base)):
        if fn.endswith(".py"):
            rel = f"bluefog_tpu_torch/sim/{fn}"
            fs = L.lint_file(os.path.join(base, fn), rel, markers=set(),
                             **_PKG)
            assert [f for f in fs if f.rule == "wallclock-in-sim"] == [], rel


def test_registered_markers_include_cuda_and_analysis():
    marks = L.registered_markers(_REPO)
    assert {"cuda", "analysis", "perf"} <= marks
