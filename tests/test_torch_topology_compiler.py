"""The port's torus schedules and topology compiler
(bluefog_tpu_torch/topology/{torus,compiler}.py) against the JAX
package's: pure numpy on both sides, so every output is held byte for
byte (the search's wall seconds aside): ``torus_one_peer_schedule`` and
``score_schedule`` at (4, 2) and (4, 4), ``default_pod_schedule``,
``compile_all_to_all`` (its schedule pairs, score and the two baseline
costs), ``compile_topology`` at a small pod, and the CLI's JSON."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bluefog_tpu.topology import compiler as jc
from bluefog_tpu.topology import torus as jt
from bluefog_tpu_torch.topology import compiler as tc
from bluefog_tpu_torch.topology import torus as tt

ROOT = Path(__file__).resolve().parents[1]


def _rounds(schedule):
    return [(r.size, r.edges, r.edge_weight_values, r.self_weight_values)
            for r in schedule]


def _no_seconds(d):
    return {k: v for k, v in d.items() if k != "seconds"}


@pytest.mark.parametrize("axes", [(4, 2), (4, 4)])
@pytest.mark.parametrize("mode", ["exp2", "single_hop"])
def test_torus_schedule_and_score_equal_jax(axes, mode):
    got = tt.torus_one_peer_schedule(axes, mode)
    want = jt.torus_one_peer_schedule(axes, mode)
    assert _rounds(got) == _rounds(want)
    assert tt.score_schedule(got, tt.TorusSpec(axes)) == \
        jt.score_schedule(want, jt.TorusSpec(axes))


def test_default_pod_schedule_equals_jax():
    got, got_report = tt.default_pod_schedule((4, 4))
    want, want_report = jt.default_pod_schedule((4, 4))
    assert _rounds(got) == _rounds(want) and got_report == want_report


def test_compile_all_to_all_equals_jax():
    got = tc.compile_all_to_all(tc.PodSpec(4, 2, dcn_cost=4.0))
    want = jc.compile_all_to_all(jc.PodSpec(4, 2, dcn_cost=4.0))
    assert _rounds(got.schedule) == _rounds(want.schedule)
    assert [[c.perm for c in r.shift_classes] for r in got.schedule] == \
        [[c.perm for c in r.shift_classes] for r in want.schedule]
    assert got.score == want.score and got.name == want.name
    assert got.shifts_per_round == want.shifts_per_round
    assert got.report == want.report
    assert _no_seconds(got.search) == _no_seconds(want.search)
    assert got.predicted_collectives(64.0) == \
        want.predicted_collectives(64.0)
    for fn in ("naive_all_to_all_cost", "one_shot_all_to_all_cost"):
        assert getattr(tc, fn)(tc.PodSpec(4, 2, dcn_cost=4.0)) == \
            getattr(jc, fn)(jc.PodSpec(4, 2, dcn_cost=4.0))


@pytest.mark.parametrize("hierarchical", [False, True])
def test_compile_topology_equals_jax(hierarchical):
    sketch = dict(max_period=6, max_degree=2)
    got = tc.compile_topology(tc.PodSpec(2, 4), tc.Sketch(**sketch),
                              hierarchical=hierarchical)
    want = jc.compile_topology(jc.PodSpec(2, 4), jc.Sketch(**sketch),
                               hierarchical=hierarchical)
    g, w = got.as_json(), want.as_json()
    g["search"], w["search"] = _no_seconds(g["search"]), \
        _no_seconds(w["search"])
    assert g == w


def _cli(module):
    out = subprocess.run(
        [sys.executable, "-m", module, "--machines", "2", "--chips", "4",
         "--max-period", "6", "--emit", "json"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    got["search"] = _no_seconds(got["search"])
    return got


def test_cli_json_equals_jax():
    assert _cli("bluefog_tpu_torch.topology.compiler") == \
        _cli("bluefog_tpu.topology.compiler")
