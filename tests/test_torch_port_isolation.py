"""The port stands alone: no module of sodt_tpu_torch imports JAX, the JAX
package, cv2 or PIL (the card's machine has neither), and its entry points
refuse to fall back to the CPU quietly."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

import sodt_tpu_torch
from torch_port_common import NARROW_CFG

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(sodt_tpu_torch.__path__,
                                                  "sodt_tpu_torch.")]
    assert "sodt_tpu_torch.kernels.window_attention" in mods
    for new in ("kernels.layernorm", "train.loss", "train.optim",
                "train.state", "train.trainer", "train.cli", "train.__main__",
                "data.png", "data.resize", "data.vedai", "data.prepare",
                "data.native_loader", "ops.letterbox", "detect",
                "models.infer", "train.tta", "utils.xlsx", "train.evolve",
                "train.sam", "utils.loggers", "utils.wandb_utils",
                "utils.plots", "utils.profiler", "utils.downloads",
                "utils.general", "parallel.mesh", "data.streams",
                "data.tools", "utils.torch_import", "ops.wbf",
                "tools.import_torch", "tools.export_torch",
                "tools.parity_check", "tools.profile_eval"):
        assert f"sodt_tpu_torch.{new}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'sodt_tpu', 'cv2',"
            " 'PIL'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from sodt_tpu_torch import detect, resolve_device, val
    from sodt_tpu_torch.train.evaluate import evaluate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate(torch.nn.Module(), [], nc=8, img_size=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        val.main(["--synthetic"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detect.main(["--source", str(tmp_path)])
    assert resolve_device("cpu").type == "cpu"


def test_tools_raise_without_cuda(monkeypatch, tmp_path):
    """The tools run on the card unless given --device cpu: without a card
    each raises before it reads or writes anything."""
    from sodt_tpu_torch.tools import (export_torch, import_torch,
                                      parity_check, profile_eval)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt, out = str(tmp_path / "absent.pt"), str(tmp_path / "out")
    for main, argv in (
            (import_torch.main, [pt, "--out", out]),
            (export_torch.main, ["--weights", pt, "--out", out]),
            (parity_check.main, ["--pt", pt, "--save-dir", out]),
            (profile_eval.main, ["--batch", "1", "--out", out])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert not any(tmp_path.iterdir())


def test_val_cli_runs_on_cpu_when_asked(tmp_path, capsys):
    from sodt_tpu_torch import val
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    m = val.main(["--cfg", str(cfg), "--synthetic", "--synthetic-n", "3",
                  "--img-size", "128", "--batch-size", "2", "--device", "cpu",
                  "--no-bf16", "--save-dir", str(tmp_path)])
    assert m["seen"] == 3 and m["device"] == "cpu"
    assert '"map50"' in capsys.readouterr().out
    s = val.main(["--cfg", str(cfg), "--task", "speed", "--img-size", "64",
                  "--batch-size", "1", "--device", "cpu", "--no-bf16",
                  "--save-dir", str(tmp_path)])
    assert s["ms_per_image"] > 0


def test_multi_process_train_raises_without_cuda(monkeypatch, tmp_path):
    """Under torchrun's variables, with no card and no --device cpu, the
    trainer raises before it starts a process group: no gloo fallback."""
    import torch.distributed as dist
    from sodt_tpu_torch.train import cli
    for k, v in {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--synthetic", "--save-dir", str(tmp_path)])
    assert not dist.is_initialized()


def test_port_loads_nothing_from_the_root_native_dir():
    """The tile loader is the port's own (`csrc/tile_loader.cpp`): no module
    of the port, and not chip_smoke.py, names JAX's OpenCV library or the
    root `native/` directory."""
    pat = re.compile(r"libsodt_loader|(?<![\w/])native/|/\s*[\"']native[\"']")
    files = [ROOT / "chip_smoke.py", *sorted(
        p for p in (ROOT / "sodt_tpu_torch").rglob("*")
        if p.suffix in (".py", ".cpp", ".cu", ".cuh", ".yaml"))]
    assert len(files) > 50
    hits = [f"{p.relative_to(ROOT)}:{i + 1}" for p in files
            for i, line in enumerate(p.read_text().splitlines())
            if pat.search(line)]
    assert not hits, hits
    assert pat.search('ROOT / "native" / "libsodt_loader.so"')
    assert pat.search("make -C native/")
