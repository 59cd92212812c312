"""The slice as a whole on a VEDAI folder, against the JAX package on the
CPU: the folder (`torch_port_common.write_vedai_folder`: 1024 px PNG pairs
in the real layout, one of them 1024 x 768) evaluated by JAX's
VedaiDataset + make_eval_batches + evaluate and by the port's `val` CLI,
square and --rect, with the in-repo checkpoint converted by
`from_jax_variables`; and the port's trainer on the folder (narrow
config): streaming equal to the device bank, then --rect.

The eval runs at 256 px: at 128 px the 512-px-trained checkpoint finds no
object in either package (mAP 0 = 0, as test_torch_port_eval.py notes),
at 256 px it scores mAP@0.5 0.86-0.89 on this folder. Bounds: uint8 batches
bit-equal, mAP@0.5 and mAP within 5e-3 (test_torch_port_eval.py's)."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

pytest.importorskip("cv2")
import jax

from sodt_tpu.data.loader import make_eval_batches as jbatches
from sodt_tpu.data.vedai import VedaiDataset as JDS
from sodt_tpu.models import build_model as jbuild
from sodt_tpu.train.checkpoint import eval_variables, load_checkpoint
from sodt_tpu.train.evaluate import evaluate as jevaluate
from sodt_tpu_torch import val
from sodt_tpu_torch.data import VedaiDataset as TDS, loader, make_eval_batches
from sodt_tpu_torch.train import cli, trainer
from sodt_tpu_torch.weights import from_jax_variables, save_npz
from torch_port_common import NARROW_CFG, write_vedai_folder

ROOT = Path(__file__).resolve().parent.parent
IMG = 256
MAP_TOL = 5e-3


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_vedai_folder(tmp_path_factory.mktemp("folder"))


@pytest.fixture
def one_thread():
    """torch on one thread: a narrow training step and the eval's NMS loop
    are hundreds of small ops, each a barrier of every intra-op thread,
    which stall when the test run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_folder_eval_matches_jax(folder, tmp_path, rect, one_thread):
    """Square: the first two pairs, one batch; rect: those and the 1024 x
    768 pair, which sorts last and batches alone at 288 x 224 (pad 0.5;
    the square pairs at 288)."""
    lst = folder["eval_list"] if rect else folder["val_list"]
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"val": str(lst), "nc": 8}))
    v = jax.tree.map(np.asarray, eval_variables(
        load_checkpoint(ROOT / "runs/flagship_r5_150ep/best_stripped")))
    npz = tmp_path / "flagship.npz"
    save_npz(from_jax_variables(v), npz)
    jds = JDS(str(lst), img_size=IMG)
    tds = TDS(str(lst), img_size=IMG)
    shapes = set()
    for a, b in zip(jbatches(jds, 2, IMG, rect=rect),
                    make_eval_batches(tds, 2, IMG, rect=rect)):
        for k in ("img", "ir", "targets", "tmask"):
            np.testing.assert_array_equal(b[k], np.asarray(a[k]))
        for k in ("indices", "valid", "shapes", "stems"):
            assert b[k] == a[k], k
        assert b.get("net_shape") == a.get("net_shape")
        shapes.add(b["img"].shape[1:3])
    assert shapes == ({(288, 288), (288, 224)} if rect else {(IMG, IMG)})
    jm = jbuild(str(ROOT / "sodt_tpu/configs/model.yaml"), ch_in=4,
                input_mode="RGB+IR")
    mj = jevaluate(jm, v, jbatches(jds, 2, IMG, rect=rect), nc=8,
                   img_size=IMG)
    mt = val.main(["--data", str(data), "--weights", str(npz),
                   "--img-size", str(IMG), "--batch-size", "2", "--device",
                   "cpu", "--no-bf16"] + (["--rect"] if rect else []))
    assert mt["seen"] == mj["seen"] == len(jds)
    assert mt["nt"] == mj["nt"]
    for k in ("map50", "map"):
        assert abs(mt[k] - mj[k]) <= MAP_TOL, (k, mt[k], mj[k])
    assert mj["map50"] > 0.5


def _train(folder, tmp_path, tag, extra, steps):
    """The port's trainer on the folder (narrow config, 128 px, batch 2,
    f32 on the CPU; the final eval a stand-in, as the folder's eval is held
    above): the run's metrics, the losses of each step and the image sizes
    the training forwards saw."""
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump(
        {"train": str(folder["list"]), "val": str(folder["val_list"]),
         "nc": 8, "names": [f"c{i}" for i in range(8)]}))
    hyp = yaml.safe_load(open(ROOT / "sodt_tpu_torch/configs/hyp.scratch.yaml"))
    (tmp_path / "hyp.yaml").write_text(yaml.safe_dump(dict(hyp,
                                                           warmup_iters=2)))
    losses, shapes = [], []
    seen = lambda state, m: losses.append({k: float(v) for k, v in m.items()})

    def start(state):
        state.model.register_forward_pre_hook(
            lambda mod, args: shapes.append(tuple(args[0].shape[1:3]))
            if mod.training else None)
    m = cli.main(["--cfg", str(cfg), "--data", str(data), "--hyp",
                  str(tmp_path / "hyp.yaml"), "--img-size", "128",
                  "--batch-size", "2", "--nbs", "2", "--epochs", "1",
                  "--device", "cpu", "--no-bf16", "--nosave", "--save-dir",
                  str(tmp_path / tag)] + extra, on_step=seen, on_start=start)
    assert m["steps"] == steps == len(losses)
    return m, losses, shapes


def test_trainer_on_folder_streaming_equals_bank_then_rect(
        folder, tmp_path, monkeypatch, capsys, one_thread):
    """Four steps from the bank and from the streaming feed give the same
    losses; one --rect epoch (ceil(9 / 2) = 5 groups, the 1024 x 768
    image's tail group at 128 x 96) gives finite losses. Each run prints
    its feed and tile source."""
    monkeypatch.setattr(trainer, "evaluate", lambda *a, nc, **k: {
        "map50": 0.0, "map": 0.0, "per_class": {}})
    _, bank, _ = _train(folder, tmp_path, "bank", [], 4)
    assert "feed: device bank (9 tiles" in capsys.readouterr().out
    monkeypatch.setattr(loader, "DEVICE_BANK_MAX_GB", 0.0)
    _, stream, _ = _train(folder, tmp_path, "stream", [], 4)
    out = capsys.readouterr().out
    assert "feed: streaming (9 tiles" in out and "tile source:" in out
    for a, b in zip(bank, stream):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(a[k])), (k, a, b)
    m, rect, shapes = _train(folder, tmp_path, "rect", ["--rect"], 5)
    assert "feed: rect (5 groups" in capsys.readouterr().out
    assert all(np.isfinite(v) for l in rect for v in l.values())
    assert sorted(set(shapes)) == [(128, 96), (128, 128)]
    with pytest.raises(ValueError, match="--rect is incompatible"):
        _train(folder, tmp_path, "bad", ["--rect", "--multi-scale"], 0)


def test_val_takes_the_yaml_list_of_its_task(folder, monkeypatch):
    """--task test reads the yaml's `test` list (two images here); the
    mAP protocol is a stand-in that reads the batches (held above)."""
    got = {}
    real = val.VedaiDataset

    def spy(path, img_size):
        got["path"] = path
        return real(path, img_size=img_size)
    monkeypatch.setattr(val, "VedaiDataset", spy)
    monkeypatch.setattr(val, "evaluate", lambda model, batches, **k: {
        "seen": sum(b["valid"] for b in batches), "per_class": {}})
    cfg = folder["root"] / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    m = val.main(["--cfg", str(cfg), "--data", str(folder["data"]), "--task",
                  "test", "--img-size", "64", "--batch-size", "2",
                  "--device", "cpu", "--no-bf16"])
    assert got["path"] == str(folder["val_list"]) and m["seen"] == 2
