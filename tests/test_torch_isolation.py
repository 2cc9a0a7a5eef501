"""The port stands alone: no module of bluefog_tpu_torch/, and not
chip_smoke.py, imports jax, flax, optax, networkx, triton or the JAX
package; the package imports with those blocked; and its entry points
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
             "bluefog_tpu", "triton"}


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
        "optim/wrappers", "topology/infer")} <= names
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p))
                                            & FORBIDDEN)
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_package_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .replace(".__init__", "")
        for p in (ROOT / "bluefog_tpu_torch").rglob("*.py"))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'networkx',\n"
        "             'bluefog_tpu', 'triton'):\n"
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


def _entry_points():
    import bluefog_tpu_torch as bt
    from bluefog_tpu_torch.interop import (llama_params_from_flax,
                                           mlp_params_from_flax,
                                           resnet_params_from_flax,
                                           vit_params_from_flax)
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
    }


@pytest.mark.parametrize("name", ["Llama", "init_cache", "llama_generate",
                                  "ServingEngine", "SlotPool",
                                  "llama_params_from_flax", "ResNet",
                                  "StackedBackend", "build_train_step",
                                  "resnet_params_from_flax", "ViT",
                                  "ViT_B16", "MLP", "MnistNet",
                                  "vit_params_from_flax",
                                  "mlp_params_from_flax", "init",
                                  "BluefogContext"])
def test_entry_point_without_device_raises_on_a_host_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()
