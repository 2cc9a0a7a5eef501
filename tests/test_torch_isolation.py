"""The port stands alone: no module of bluefog_tpu_torch/ (its launchers
``bluefog_tpu_torch.run`` and ``ibfrun`` and its analyzer included), and
not chip_smoke.py, imports jax,
flax, optax, networkx, triton or the JAX package, and only the TF adapter
imports tensorflow; the package imports and the launcher runs with those
blocked; ``import bluefog_tpu_torch``, ``bluefog_tpu_torch.interop`` and
``bluefog_tpu_torch.analysis`` load none of jax, tensorflow or triton;
and its entry points
run on the card unless the caller asks for the CPU (without CUDA, a call
that does not pass device="cpu" raises)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "networkx",
             "bluefog_tpu", "triton", "transformers"}


def _port_files():
    files = sorted((ROOT / "bluefog_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None))
                in ("import_module", "__import__") and node.args
                and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15 and (ROOT / "chip_smoke.py").exists()
    names = {p.relative_to(ROOT).as_posix() for p in files}
    assert {f"bluefog_tpu_torch/{m}.py" for m in (
        "api", "context", "windows", "utility", "logging_util",
        "optim/wrappers", "topology/infer", "run/__init__", "run/__main__",
        "run/run", "interop/hf_llama", "models/quant",
        "serving/prefix_cache", "serving/resilience", "resilience/faults",
        "sim/engine", "observe/blackbox", "observe/fleet", "observe/export",
        "observe/stepprof", "serving/fleet", "parallel/ulysses", "data",
        "checkpoint", "_tree", "native/__init__", "resilience/detector",
        "resilience/healing", "resilience/runner", "elastic/__init__",
        "elastic/bootstrap", "elastic/membership", "moe/__init__",
        "moe/dispatch", "moe/layer", "topology/torus",
        "topology/compiler", "topology/control", "sim/clock", "sim/cost",
        "sim/traces", "sim/wire", "sim/training", "sim/serving",
        "benchutil", "run/engines", "run/interactive_run",
        "interop/tf_adapter", "analysis/__init__", "analysis/__main__",
        "analysis/lint", "analysis/step_check")} <= names
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p))
                                            & FORBIDDEN)
           for p in files}
    assert not {k: v for k, v in bad.items() if v}
    tf_users = sorted(str(p.relative_to(ROOT)) for p in files
                      if "tensorflow" in set(_imported_roots(p)))
    assert tf_users == ["bluefog_tpu_torch/interop/tf_adapter.py"]


def test_package_interop_and_analysis_load_no_jax_tf_or_triton():
    """Nothing is blocked here: the imports themselves must not pull
    jax, tensorflow or triton in (the interop package reaches its TF
    adapter lazily)."""
    code = (
        "import sys\n"
        "import bluefog_tpu_torch, bluefog_tpu_torch.interop\n"
        "import bluefog_tpu_torch.analysis\n"
        "import bluefog_tpu_torch.analysis.lint\n"
        "import bluefog_tpu_torch.analysis.step_check\n"
        "import bluefog_tpu_torch.analysis.__main__\n"
        "loaded = sorted({m.split('.')[0] for m in sys.modules}\n"
        "                & {'jax', 'tensorflow', 'triton', 'bluefog_tpu'})\n"
        "assert not loaded, loaded\n"
        "assert 'bluefog_tpu_torch.interop.tf_adapter' not in sys.modules\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith("ok")


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .replace(".__init__", "")
        for p in (ROOT / "bluefog_tpu_torch").rglob("*.py"))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'networkx',\n"
        "             'bluefog_tpu', 'triton', 'transformers',\n"
        "             'tensorflow'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_bfrun_runs_with_jax_and_triton_blocked():
    """The port's launcher (``python -m bluefog_tpu_torch.run``) runs
    with jax and triton unimportable, and imports neither."""
    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'networkx',\n"
        "             'bluefog_tpu', 'triton'):\n"
        "    sys.modules[name] = None\n"
        "sys.argv = ['bfrun', '--version']\n"
        "try:\n"
        "    runpy.run_module('bluefog_tpu_torch.run', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'triton', 'bluefog_tpu')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert "bfrun (bluefog_tpu_torch)" in proc.stdout
    assert proc.stdout.rstrip().endswith("ok")


def test_ibfrun_runs_with_jax_blocked_and_stays_out_of_the_package(
        tmp_path):
    """``import bluefog_tpu_torch`` loads neither ``run.engines`` nor
    ``run.interactive_run``; with jax and the JAX package unimportable
    both import, load neither, and ``python -m
    bluefog_tpu_torch.run.interactive_run stop`` runs (no cluster: 1)."""
    code = (
        "import runpy, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'networkx',\n"
        "             'bluefog_tpu', 'triton'):\n"
        "    sys.modules[name] = None\n"
        "import bluefog_tpu_torch\n"
        "ibf = ('bluefog_tpu_torch.run.engines',\n"
        "       'bluefog_tpu_torch.run.interactive_run')\n"
        "assert not [m for m in ibf if m in sys.modules]\n"
        "import bluefog_tpu_torch.run.engines\n"
        "sys.argv = ['ibfrun', 'stop', '--profile', 'none']\n"
        "try:\n"
        "    runpy.run_module('bluefog_tpu_torch.run.interactive_run',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 1, e.code\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'triton', 'bluefog_tpu')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               BLUEFOG_TPU_STATE_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith("ok")


def _entry_points():
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.interop import (llama_params_from_flax,
                                           llama_params_from_hf,
                                           mlp_params_from_flax,
                                           resnet_params_from_flax,
                                           vit_params_from_flax)
    from bluefog_tpu_torch.analysis import step_check
    from bluefog_tpu_torch.context import BluefogContext
    from bluefog_tpu_torch.serving import SlotPool

    cfg = bt.LlamaConfig.tiny(dtype=torch.float32)
    model = bt.Llama(cfg, device="cpu")
    prompt = np.zeros((1, 3), np.int32)
    tree = {"params": {}}
    return {
        "Llama": lambda: bt.Llama(cfg),
        "init_cache": lambda: bt.init_cache(cfg, 1, 8),
        "llama_generate": lambda: bt.llama_generate(model, cfg, prompt, 2),
        "ServingEngine": lambda: bt.ServingEngine(
            model, cfg, capacity=1, max_len=8, prefill_chunk=4),
        "SlotPool": lambda: SlotPool(cfg, 1, 8),
        "llama_params_from_flax": lambda: llama_params_from_flax(tree, cfg),
        "llama_params_from_hf": lambda: llama_params_from_hf({}, cfg),
        "ResNet": lambda: bt.ResNet50(),
        "StackedBackend": lambda: bt.StackedBackend(4),
        "build_train_step": lambda: bt.build_train_step(
            lambda p, b: p["w"].sum(), torch.optim.SGD([torch.zeros(1)]),
            bt.StackedBackend(4), comm_mode="none"),
        "resnet_params_from_flax": lambda: resnet_params_from_flax(
            {"params": {}, "batch_stats": {}}, bt.ResNet(
                (1,), bt.models.BottleneckBlock, num_filters=4,
                device="cpu")),
        "ViT": lambda: bt.ViT(bt.ViTConfig.tiny()),
        "ViT_B16": lambda: bt.ViT_B16(),
        "MLP": lambda: bt.MLP(784),
        "MnistNet": lambda: bt.MnistNet(),
        "vit_params_from_flax": lambda: vit_params_from_flax(
            tree, bt.ViT(bt.ViTConfig.tiny(), device="cpu")),
        "mlp_params_from_flax": lambda: mlp_params_from_flax(
            tree, bt.MnistNet(device="cpu")),
        "init": lambda: bt.init(size=4),
        "BluefogContext": lambda: BluefogContext(4),
        "init_moe_params": lambda: bt.moe.init_moe_params(
            torch.Generator(), 8, 16, 4),
        "run_sweep": lambda: step_check.run_sweep(cases=[]),
        "check_collective_contracts":
            lambda: step_check.check_collective_contracts(),
        "check_serving_residents":
            lambda: step_check.check_serving_residents(),
    }


@pytest.mark.parametrize("name", ["Llama", "init_cache", "llama_generate",
                                  "ServingEngine", "SlotPool",
                                  "llama_params_from_flax",
                                  "llama_params_from_hf", "ResNet",
                                  "StackedBackend", "build_train_step",
                                  "resnet_params_from_flax", "ViT",
                                  "ViT_B16", "MLP", "MnistNet",
                                  "vit_params_from_flax",
                                  "mlp_params_from_flax", "init",
                                  "BluefogContext", "init_moe_params",
                                  "run_sweep", "check_collective_contracts",
                                  "check_serving_residents"])
def test_entry_point_without_device_raises_on_a_host_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
