"""The port's public names and the wiring of its tools, against the JAX
package on the CPU:

  * `ops.single_image_nms` equals JAX's on seeded predictions (as
    `test_batched_nms_equal` holds `batched_nms`); `wh_iou` and `xyn2xy`
    equal JAX's;
  * every name that JAX's `ops`, `models` and `data` packages import in
    their `__init__` imports from the port's, and `__version__` is JAX's;
  * the trace breakdown (`utils.profiler`, shared by
    `tools/profile_eval.py` and chip_smoke's profile phases) gives the
    categories and shares expected of a small Chrome trace;
  * the JAX system's `tools/wall_report.py` reads a port training run's
    events.jsonl and reports every `wall/*` key JAX's trainer logs.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from torch_port_common import NARROW_CFG, j, t
from torch_port_common import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent


def _preds(seed, n=400, nc=3, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(20, 200, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    obj = rng.uniform(0, 1, (n, 1))
    cls = rng.uniform(0, 1, (n, nc))
    if ties:
        obj, cls = np.round(obj * 4) / 4, np.round(cls * 4) / 4
        xy = np.round(xy / 20) * 20
    return np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(conf_thres=0.001, iou_thres=0.6, multi_label=True, merge=True,
         top_k=512, max_det=100),
    dict(conf_thres=0.25, iou_thres=0.45, multi_label=False, merge=False,
         top_k=512, max_det=50, approx_topk=True),
    dict(conf_thres=0.1, iou_thres=0.5, multi_label=True, merge=False,
         agnostic=True, top_k=4096, max_det=300),
    dict(conf_thres=0.1, iou_thres=0.5, multi_label=False, merge=True,
         agnostic=True, top_k=256, max_det=60),
])
@pytest.mark.parametrize("ties", [False, True])
def test_single_image_nms_equal(kw, ties):
    from sodt_tpu.ops import single_image_nms as jnms
    from sodt_tpu_torch.ops import single_image_nms as tnms
    p = _preds(11, ties=ties)
    jd, jv = jnms(j(p), **kw)
    td, tv = tnms(t(p), **kw)
    assert td.shape == (kw["max_det"], 6) and tv.shape == (kw["max_det"],)
    assert tv.any()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy()[:, 4:], np.asarray(jd)[:, 4:])
    if kw["merge"]:
        # merged boxes: a (max_det, K) @ (K, 4) product whose f32 summation
        # order differs between the two CPU backends, a few ulps
        np.testing.assert_allclose(td.numpy()[:, :4], np.asarray(jd)[:, :4],
                                   rtol=1e-6, atol=1e-4)
    else:
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_wh_iou_and_xyn2xy_equal():
    from sodt_tpu.ops import boxes as jb
    from sodt_tpu_torch.ops import wh_iou, xyn2xy
    rng = np.random.default_rng(3)
    wh1 = rng.uniform(1, 80, (9, 2)).astype(np.float32)
    wh2 = rng.uniform(1, 80, (13, 2)).astype(np.float32)
    np.testing.assert_array_equal(wh_iou(t(wh1), t(wh2)).numpy(),
                                  np.asarray(jb.wh_iou(j(wh1), j(wh2))))
    pts = rng.uniform(0, 1, (4, 7, 2)).astype(np.float32)
    for kw in ({}, dict(w=512, h=384, padw=3.5, padh=-2.0)):
        np.testing.assert_array_equal(xyn2xy(t(pts), **kw).numpy(),
                                      np.asarray(jb.xyn2xy(j(pts), **kw)))


def _init_names(pkg: str) -> list[str]:
    """The names that `sodt_tpu/<pkg>/__init__.py` imports."""
    tree = ast.parse((ROOT / "sodt_tpu" / pkg / "__init__.py").read_text())
    return [a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for a in node.names]


@pytest.mark.parametrize("pkg", ["ops", "models", "data"])
def test_jax_init_names_import_from_the_port(pkg):
    names = _init_names(pkg)
    assert len(names) >= 3
    port = importlib.import_module(f"sodt_tpu_torch.{pkg}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    assert set(names) <= set(port.__all__)


def test_version_is_jax():
    import sodt_tpu
    import sodt_tpu_torch
    assert sodt_tpu_torch.__version__ == sodt_tpu.__version__


def test_breakdown_of_a_chrome_trace():
    from sodt_tpu_torch.utils.profiler import (breakdown, format_breakdown,
                                               kernel_category,
                                               trace_kernels)
    gemm = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_2"
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "args": {}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 1000.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "dur": 700.0},
          {"ph": "X", "cat": "kernel", "dur": 300.0, "name":
           "void sodt::layernorm_kernel<0, 3, 8>(sodt::LnParams)"},
          {"ph": "X", "cat": "kernel", "dur": 100.0, "name":
           "void sodt::layernorm_kernel<1, 4, 8>(sodt::LnParams)"},
          {"ph": "X", "cat": "kernel", "dur": 250.0, "name": gemm},
          {"ph": "X", "cat": "kernel", "dur": 250.0, "name": gemm},
          {"ph": "X", "cat": "kernel", "dur": 100.0, "name":
           "void (anonymous namespace)::elementwise_kernel_with_index<int, "
           "at::native::arange_cuda_out(at::Tensor&)::{lambda}>(int, X)"}]
    rows = trace_kernels({"traceEvents": ev})
    assert [r["count"] for r in rows] == [2, 1, 1, 1]
    b = breakdown(rows, iters=2, top_categories=25, top_kernels=2)
    assert b["device_ms_per_iter"] == pytest.approx(0.5)
    want = {"sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64":
            (0.25, 0.5, 2),
            "sodt::layernorm_kernel": (0.2, 0.4, 2),
            "anon::elementwise_kernel_with_index": (0.05, 0.1, 1)}
    assert [c["name"] for c in b["categories"]] == list(want)
    for c in b["categories"]:
        ms, share, n = want[c["name"]]
        assert c["ms"] == pytest.approx(ms) and c["count"] == n
        assert c["share"] == pytest.approx(share)
    assert [k["name"] for k in b["kernels"]] == [gemm, ev[3]["name"]]
    assert b["kernels"][1]["share"] == pytest.approx(0.3)
    text = format_breakdown(b)
    assert "0.50 ms/iter" in text and " 40.0%" in text
    assert kernel_category("cutlass::Kernel2<cutlass_80_tensorop>(P)") == \
        "cutlass::Kernel"


def test_wall_report_reads_a_port_run(tmp_path, monkeypatch, capsys):
    """One epoch of the narrow flagship on the CPU (the epoch path, an eval
    stand-in, the asynchronous save): `load` finds the wall records and
    `main` prints a row for every wall/* key of JAX's trainer."""
    from sodt_tpu_torch.train import cli, trainer as ttrainer
    src = (ROOT / "sodt_tpu/train/trainer.py").read_text()
    keys = (set(re.findall(r'wall\["(\w+)"\]', src))
            | set(re.findall(r'"wall/(\w+)"', src)))
    assert keys == {"sched", "dispatch", "fetch", "chunk", "eval", "ckpt",
                    "epoch", "ckpt_fetch", "ckpt_write"}
    monkeypatch.setattr(ttrainer, "evaluate", lambda *a, **k: {
        "mp": 0.5, "mr": 0.25, "map50": 0.125, "map": 0.0625,
        "per_class": {}})
    cfg = tmp_path / "narrow.yaml"
    cfg.write_text(yaml.safe_dump(NARROW_CFG))
    run = tmp_path / "run"
    cli.main(["--cfg", str(cfg), "--synthetic", "--synthetic-n", "4",
              "--img-size", "64", "--batch-size", "2", "--nbs", "2",
              "--epochs", "1", "--no-bf16", "--device", "cpu",
              "--noautoanchor", "--scan-epoch", "on", "--save-dir",
              str(run)])
    report = importlib.util.spec_from_file_location(
        "wall_report", ROOT / "tools/wall_report.py")
    mod = importlib.util.module_from_spec(report)
    report.loader.exec_module(mod)
    recs = mod.load(run)
    seen = {k[len("wall/"):] for r in recs for k in r if k.startswith("wall/")}
    assert seen == keys
    capsys.readouterr()
    mod.main([str(run), "--skip", "0"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{len(recs)} epochs after skipping 0")
    rows = {line.split()[0] for line in out[2:]}
    assert rows == keys
    assert all(json.loads(line) for line in open(run / "events.jsonl"))
