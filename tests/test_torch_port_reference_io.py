"""The port's reference-checkpoint tools (`sodt_tpu_torch/tools/`)
against the JAX system's (`tools/*.py`, loaded as modules), on the CPU:

  * `export_torch.export_flagship_state_dict` of the port's weights of
    runs/flagship_r5_150ep/best_stripped equals JAX's of the same
    checkpoint, key for key and bit for bit; `main --no-module` writes it
    after its round trip, and the whole-module form without a reference
    tree raises naming --no-module;
  * `import_torch` writes a .npz equal to `weights.from_jax_variables` of
    what JAX's `convert` would save (its orbax writer replaced by a
    recorder) for each form of checkpoint: a plain state_dict, a training
    dict with `ema` None or set, the DDP prefix, half precision, a
    checkpoint that `weights_only` refuses (JAX's warning, word for
    word), and a yolo5m state_dict (the CNN importer);
  * `parity_check.run` on a .pt holds JAX's `run` on the same file (the
    flagship in f32 at 256 px on two synthetic images: at 128 px the
    trained checkpoint finds nothing in either package): mAP within 5e-3,
    `pass` and `delta_pts` by the same rule; `main` exits 1 where `pass`
    is false.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sodt_tpu_torch.tools import export_torch, import_torch, parity_check
from sodt_tpu_torch.weights import from_jax_variables, load_npz
from torch_port_common import drawn_variables
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
JAX_CFG = str(ROOT / "sodt_tpu/configs/model.yaml")
JAX_DATA = str(ROOT / "sodt_tpu/configs/data_vedai.yaml")
MAP_TOL = 5e-3      # eval mAP against JAX's, as tests/test_torch_port_eval.py


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def flagship():
    """JAX's EMA variables of the trained flagship (numpy), JAX's model,
    the port's model, and JAX's export of the variables."""
    import jax
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.train.checkpoint import eval_variables, load_checkpoint
    from sodt_tpu_torch.models import build_model as tbuild
    v = jax.tree.map(np.asarray, eval_variables(
        load_checkpoint(ROOT / "runs/flagship_r5_150ep/best_stripped")))
    jm = jbuild(JAX_CFG, ch_in=4)
    tm = tbuild("configs/model.yaml", ch_in=4)
    jexport = _module("jax_export_torch", ROOT / "tools/export_torch.py")
    return v, jm, tm, jexport.export_flagship_state_dict(v, jm.spec)


def test_export_equals_jax(flagship):
    v, _, tm, want = flagship
    got = export_torch.export_flagship_state_dict(from_jax_variables(v),
                                                  tm.spec)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def test_export_cli_round_trip_and_module_form(flagship, tmp_path, capsys):
    _, _, _, want = flagship
    npz = ROOT / "checkpoints/flagship_r5_150ep_ema.npz"
    out = tmp_path / "ours.pt"
    r = export_torch.main(["--weights", str(npz), "--out", str(out),
                           "--no-module", "--device", "cpu"])
    assert "round-trip exact over 244 arrays" in capsys.readouterr().out
    assert r["arrays"] == 244 and r["reference_keys"] == len(want)
    sd = torch.load(out, weights_only=True)
    assert sorted(sd) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(sd[k].numpy(), w), k
    mod = tmp_path / "module.pt"
    with pytest.raises(FileNotFoundError, match="--no-module"):
        export_torch.main(["--weights", str(npz), "--out", str(mod),
                           "--ref-path", str(tmp_path), "--device", "cpu"])
    assert not mod.exists()


def _jax_convert(monkeypatch, src: Path, cfg: str, input_mode: str) -> dict:
    """What JAX's tools/import_torch.py `convert` would save for `src`, as
    the port's state_dict."""
    import orbax.checkpoint as ocp
    saved = []

    class Recorder:
        def save(self, path, tree, force=False):
            saved.append(tree)
    monkeypatch.setattr(ocp, "PyTreeCheckpointer", Recorder)
    jtool = _module("jax_import_torch", ROOT / "tools/import_torch.py")
    jtool.convert(str(src), cfg, "unused", input_mode=input_mode, nc=8)
    tree = saved[0]
    return from_jax_variables({"params": tree["params"],
                               "batch_stats": tree["batch_stats"]})


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], w), k


def _form(sd: dict, form: str):
    if form == "plain":
        return sd
    if form == "model_ema_none":
        return {"model": sd, "ema": None, "epoch": 5}
    if form == "ema":
        return {"epoch": 5, "ema": sd, "model": {}}
    if form == "module_prefix":
        return {f"module.{k}": v for k, v in sd.items()}
    if form == "fp16":
        return {k: v.half() if v.is_floating_point() else v
                for k, v in sd.items()}
    if form == "refused":     # an object weights_only refuses
        return {"model": sd, "opt": argparse.Namespace(lr=0.01)}
    raise ValueError(form)


@pytest.mark.parametrize("form", ["plain", "model_ema_none", "ema",
                                  "module_prefix", "fp16", "refused"])
def test_import_tool_equals_jax(form, flagship, tmp_path, monkeypatch,
                                capsys):
    _, _, _, ref = flagship
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref.items()}
    src = tmp_path / "ref.pt"
    torch.save(_form(sd, form), src)
    want = _jax_convert(monkeypatch, src, JAX_CFG, "RGB+IR")
    jerr = capsys.readouterr().err
    out = tmp_path / "imported.npz"
    r = import_torch.main([str(src), "--out", str(out), "--device", "cpu"])
    perr = capsys.readouterr().err
    assert r["arrays"] == 244
    _same(load_npz(out), want)
    warning = (f"WARNING: {src} is not a plain-tensor checkpoint; falling "
               "back to full unpickling, which executes code from the .pt "
               "file.")
    assert (warning in perr) == (form == "refused")
    assert (warning in jerr) == (form == "refused")


def test_import_tool_cnn_route_equals_jax(tmp_path, monkeypatch):
    """yolo5m (Focus, Conv, C3, SPP, three Detect levels) from the inverse
    map of tests/test_torch_port_item11.py, through `model.` names."""
    from sodt_tpu.models import build_model as jbuild
    from test_torch_port_item11 import _unified_reference
    cfg = str(ROOT / "sodt_tpu/configs/yolo5m.yaml")
    jm = jbuild(cfg, ch_in=3, input_mode="RGB")
    x = np.zeros((1, 64, 64, 3), np.float32)
    sd = _unified_reference(drawn_variables(jm, x, x, seed=4, train=True),
                            jm.spec)
    src = tmp_path / "yolo5m.pt"
    torch.save({"model": sd}, src)
    want = _jax_convert(monkeypatch, src, cfg, "RGB")
    out = tmp_path / "yolo5m.npz"
    import_torch.main([str(src), "--out", str(out), "--cfg", "yolo5m.yaml",
                       "--input_mode", "RGB", "--device", "cpu"])
    _same(load_npz(out), want)


def test_parity_check_matches_jax(flagship, tmp_path, capsys):
    _, _, _, ref = flagship
    pt = tmp_path / "ref.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in ref.items()}, pt)
    kw = dict(img_size=256, batch_size=2, synthetic=True, synthetic_n=2,
              bf16=False, ref_map50=89.0)
    jtool = _module("jax_parity_check", ROOT / "tools/parity_check.py")
    want = jtool.run(str(pt), JAX_CFG, JAX_DATA,
                     save_dir=str(tmp_path / "jax"), **kw)
    argv = ["--pt", str(pt), "--img-size", "256", "--batch-size", "2",
            "--synthetic", "--synthetic-n", "2", "--no-bf16", "--device",
            "cpu", "--save-dir", str(tmp_path / "port")]
    assert parity_check.main(argv + ["--ref-map50", "89.0"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for r in (got, want):
        assert r["ref_map50"] == 0.89
        assert abs(r["delta_pts"] - 100 * (r["map50"] - 0.89)) <= 0.011
        assert r["pass"] == (abs(r["delta_pts"]) <= 0.3)
    assert got["map50"] > 0.5                   # the weights find objects
    assert abs(got["map50"] - want["map50"]) <= MAP_TOL
    assert abs(got["map"] - want["map"]) <= MAP_TOL
    assert got["pass"] == want["pass"]
    assert got["weights"].endswith("imported.npz")
    # a reference far away: pass is false and the exit status is 1
    assert parity_check.main(argv + ["--ref-map50", "0.5"]) == 1
    failed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert failed["pass"] is False and failed["map50"] == got["map50"]
