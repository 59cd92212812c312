"""The slice on a JPEG folder, against the JAX package on the CPU: the VEDAI
folder of `torch_port_common.write_vedai_folder` written again as JPEG
pairs by cv2 (`_co.jpg` colour 4:2:0, `_ir.jpg` gray, progressive for half
of them), as a camera's or a public set's files come:

  * JAX's VedaiDataset + make_eval_batches and the port's give bit-equal
    uint8 batches, square and --rect (sizes from the JPEG headers), and the
    port's `val --data` reads JAX's mAP within test_torch_port_folders.py's
    bound (5e-3) at 256 px with the in-repo checkpoint;
  * the port's trainer runs `--data` on it (narrow config, 128 px): the
    streaming feed gives the losses of the device bank, both reading their
    tiles through the host library's tile loader (its JPEG decoder).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

cv2 = pytest.importorskip("cv2")
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
    """The PNG folder's pairs as JPEG files, its labels and fold lists."""
    src = write_vedai_folder(tmp_path_factory.mktemp("png"), n=4)
    root = tmp_path_factory.mktemp("jpeg")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    for i, stem in enumerate(src["stems"]):
        co = cv2.imread(str(src["root"] / "images" / f"{stem}_co.png"))
        ir = cv2.imread(str(src["root"] / "images" / f"{stem}_ir.png"),
                        cv2.IMREAD_UNCHANGED)
        cv2.imwrite(str(root / "images" / f"{stem}_co.jpg"), co,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        cv2.imwrite(str(root / "images" / f"{stem}_ir.jpg"),
                    ir if ir.ndim == 2 else ir[..., 0],
                    [cv2.IMWRITE_JPEG_PROGRESSIVE, i % 2])
        lab = src["root"] / "labels" / f"{stem}.txt"
        (root / "labels" / f"{stem}.txt").write_bytes(lab.read_bytes())
    lst = lambda name, stems: (root / name).write_text("".join(
        f"{root / 'images' / s}_co.jpg\n" for s in stems))
    stems = src["stems"]
    lst("fold.txt", stems)
    lst("fold_val.txt", stems[:2])
    lst("fold_eval.txt", stems[:2] + stems[-1:])
    return {"root": root, "list": root / "fold.txt",
            "val_list": root / "fold_val.txt",
            "eval_list": root / "fold_eval.txt", "n": len(stems)}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_jpeg_folder_batches_equal_jax(folder, rect):
    lst = folder["eval_list"] if rect else folder["val_list"]
    jds = JDS(str(lst), img_size=IMG)
    tds = TDS(str(lst), img_size=IMG)
    assert tds.img_files == jds.img_files and len(tds) == (3 if rect else 2)
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


def test_jpeg_folder_val_matches_jax(folder, tmp_path, one_thread):
    """`val --data --rect` on the JPEG folder against JAX's evaluate of
    the same files (the 1024 x 768 pair batches alone)."""
    lst = folder["eval_list"]
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"val": str(lst), "nc": 8}))
    v = jax.tree.map(np.asarray, eval_variables(
        load_checkpoint(ROOT / "runs/flagship_r5_150ep/best_stripped")))
    npz = tmp_path / "flagship.npz"
    save_npz(from_jax_variables(v), npz)
    jds = JDS(str(lst), img_size=IMG)
    jm = jbuild(str(ROOT / "sodt_tpu/configs/model.yaml"), ch_in=4,
                input_mode="RGB+IR")
    mj = jevaluate(jm, v, jbatches(jds, 2, IMG, rect=True), nc=8,
                   img_size=IMG)
    mt = val.main(["--data", str(data), "--weights", str(npz),
                   "--img-size", str(IMG), "--batch-size", "2", "--device",
                   "cpu", "--no-bf16", "--rect"])
    assert mt["seen"] == mj["seen"] == 3 and mt["nt"] == mj["nt"]
    for k in ("map50", "map"):
        assert abs(mt[k] - mj[k]) <= MAP_TOL, (k, mt[k], mj[k])
    assert mj["map50"] > 0.5


def _train(folder, tmp_path, tag, steps):
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump(
        {"train": str(folder["list"]), "val": str(folder["val_list"]),
         "nc": 8, "names": [f"c{i}" for i in range(8)]}))
    hyp = yaml.safe_load(open(ROOT / "sodt_tpu_torch/configs/hyp.scratch.yaml"))
    (tmp_path / "hyp.yaml").write_text(yaml.safe_dump(dict(hyp,
                                                           warmup_iters=2)))
    losses = []
    m = cli.main(["--cfg", str(cfg), "--data", str(data), "--hyp",
                  str(tmp_path / "hyp.yaml"), "--img-size", "128",
                  "--batch-size", "2", "--nbs", "2", "--epochs", "1",
                  "--device", "cpu", "--no-bf16", "--nosave", "--save-dir",
                  str(tmp_path / tag)],
                 on_step=lambda state, m: losses.append(
                     {k: float(x) for k, x in m.items()}))
    assert m["steps"] == steps == len(losses)
    return losses


def test_trainer_on_jpeg_folder_streaming_equals_bank(
        folder, tmp_path, monkeypatch, capsys, one_thread):
    monkeypatch.setattr(trainer, "evaluate", lambda *a, nc, **k: {
        "map50": 0.0, "map": 0.0, "per_class": {}})
    steps = folder["n"] // 2               # the last partial batch dropped
    bank = _train(folder, tmp_path, "bank", steps)
    assert f"feed: device bank ({folder['n']} tiles" in \
        capsys.readouterr().out
    monkeypatch.setattr(loader, "DEVICE_BANK_MAX_GB", 0.0)
    stream = _train(folder, tmp_path, "stream", steps)
    out = capsys.readouterr().out
    assert f"feed: streaming ({folder['n']} tiles" in out
    assert "tile source: native" in out
    for a, b in zip(bank, stream):
        assert all(np.isfinite(x) for x in a.values())
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(a[k])), (k, a, b)
