"""Shared helpers of the tests/test_torch_port_*.py files: inputs made with
numpy from a seed go through the JAX package (the oracle, on the CPU) and
through its counterpart in sodt_tpu_torch."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the test, restored after. The Tier-1 run
    puts six workers on 8 cores; these small-op tests run no faster alone
    with 8 threads than with one, and under that load 8 threads a worker
    spin at every parallel region's barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def j(x):
    import jax.numpy as jnp     # the tests on the card import no JAX
    return jnp.asarray(np.asarray(x, dtype=np.float32))


def close(a, b, tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@contextlib.contextmanager
def interpret_mode():
    """Run Pallas kernels through the interpreter on the CPU, as
    tests/test_pallas.py does."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    try:
        pl.pallas_call = lambda *a, **kw: orig(*a, interpret=True, **kw)
        yield
    finally:
        pl.pallas_call = orig


NARROW_CFG = {
    # model.yaml's head, with a narrow encoder (embed 48 divides by nh 12)
    "nc": 8, "depth_multiple": 0.33, "width_multiple": 0.50,
    "anchors": [[10, 13, 16, 30, 33, 23]],
    "backbone": [[-1, 1, "ImageEncoderViT", [128, 6, 48, 4, 64, 4]]],
    "head": [[2, 1, "Conv", [512, 1, 1]],
             [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 1], 1, "Concat", [1]],
             [-1, 3, "C3", [512, False]],
             [-1, 1, "Conv", [256, 1, 1]],
             [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
             [[-1, 0], 1, "Concat", [1]],
             [-1, 3, "C3", [256, False]],
             [[10], 1, "Detect", ["nc", "anchors"]]],
}


SWINV2_CFG = "sodt_tpu/configs/model_swinv2.yaml"
PORT_SWINV2_CFG = "sodt_tpu_torch/configs/model_swinv2.yaml"


def with_depths(spec, depths):
    """A parsed SwinV2 model (either package's ModelSpec) with the encoder's
    stage depths cut to `depths`: both packages pass the backbone entry's
    args to the encoder's constructor."""
    import dataclasses
    enc = spec.backbone[0]
    args = tuple(sorted(dict(enc.args, depths=tuple(depths)).items()))
    return dataclasses.replace(
        spec, backbone=(dataclasses.replace(enc, args=args),))


def randomize_variables(v, seed: int):
    """Perturb a flax init so BN stats, LN affine, biases and pos_embed
    are not their trivial init values (the comparison then covers them).
    A norm scale that starts at ZERO (the post-norms of the SwinV2 blocks,
    which make a fresh block the identity) is drawn of order 1, and the
    SwinV2 attention's logit_scale, q_bias and v_bias are perturbed."""
    rng = np.random.default_rng(seed)

    def walk(d):
        out = {}
        for k, x in d.items():
            if isinstance(x, dict):
                out[k] = walk(x)
                continue
            x = np.asarray(x, np.float32)
            if k in ("mean", "bias", "pos_embed", "q_bias", "v_bias",
                     "logit_scale"):
                x = x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
            elif k == "scale" and not x.any():
                x = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
            elif k in ("var", "scale"):
                x = x * (1.0 + 0.1 * rng.uniform(-1, 1, x.shape)).astype(np.float32)
            out[k] = x
        return out

    return walk(v)


def drawn_variables(jmodel, *inputs, seed: int = 0, **kw):
    """Variables for the JAX module `jmodel`, drawn with numpy from `seed`
    on the tree that `jmodel.init(key, *inputs, **kw)` builds (traced by
    jax.eval_shape, never compiled: a jitted init of a deep CNN compiles
    for ~15 s on the CPU). Kernels normal with variance 1 / fan_in, norm
    scales and BN variances uniform in [0.5, 1.5], rel-pos tables normal
    (0.02), every other leaf (biases, BN means, pos_embed) normal (0.05):
    nothing is left at a trivial init value. Only "params" and
    "batch_stats" are returned."""
    import jax
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda *a: jmodel.init(*a, **kw),
                            jax.random.PRNGKey(0), *inputs)

    def draw(path, s):
        name = getattr(path[-1], "key", str(path[-1]))
        if name == "kernel":
            x = rng.standard_normal(s.shape) / np.sqrt(
                np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, s.shape)
        elif name == "relative_position_bias_table":
            x = 0.02 * rng.standard_normal(s.shape)
        else:
            x = 0.05 * rng.standard_normal(s.shape)
        return x.astype(np.float32)

    # the init's "bias_cache" collection (the materialized rel-pos bias)
    # would be read in place of the drawn table: it is left out
    return jax.tree_util.tree_map_with_path(
        draw, {k: shapes[k] for k in ("params", "batch_stats")
               if k in shapes})


@torch.no_grad()
def seed_postnorms(model, seed: int = 0):
    """Draw the post-norm scales of every SwinV2 block of the port's
    `model` from `seed`, uniform in [0.5, 1.5] (what `randomize_variables`
    does to a flax tree). At their zero initialization every V2 block is
    the identity: its attention, its MLP and their gradients contribute
    exactly nothing, and any comparison passes."""
    from sodt_tpu_torch.models.swinv2 import SwinBlockV2
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, SwinBlockV2):
            for norm in (mod.norm1, mod.norm2):
                norm.weight.copy_(0.5 + torch.rand(norm.weight.shape,
                                                   generator=g))
    return model


def write_vedai_folder(root, n: int = 8, portrait: bool = True) -> dict:
    """A VEDAI folder in the real on-disk layout under `root`:
    `tests/test_e2e_fixture.py`'s `_write_fixture` (n 1024 px `_co` / `_ir`
    pairs written by cv2, raw 14-column annotations) prepared by the JAX
    package's `prepare` into `labels/` and the fold list `fold01_write.txt`;
    with `portrait`, one more pair 1024 high and 768 wide (its label file
    written directly, normalized by its own sides: `prepare` normalizes
    both axes by one size). Shorter lists: `fold_val.txt` (the first two
    pairs) and `fold_eval.txt` (those and the last). Returns the paths."""
    import cv2
    import yaml
    from pathlib import Path
    from test_e2e_fixture import _write_fixture
    from sodt_tpu.data.prepare import changepath, makelabels
    from sodt_tpu.data.synthetic import SyntheticVedai as JSynth

    root = Path(root)
    stems = _write_fixture(root, n=n, raw_size=1024, nc=3)
    makelabels(str(root / "Annotations1024"), str(root / "labels"),
               img_size=1024.0)
    if portrait:
        rgb, ir, lab = JSynth(n=1, img_size=1024, nc=3, seed=12)[0]
        stem = f"{n + 1:08d}"
        cv2.imwrite(str(root / "images" / f"{stem}_co.png"),
                    rgb[:, :768, ::-1])
        cv2.imwrite(str(root / "images" / f"{stem}_ir.png"), ir[:, :768, 0])
        inside = lab[(lab[:, 1] + lab[:, 3] / 2) * 1024 < 768]
        rows = [f"{int(c)} {cx * 1024 / 768:.6f} {cy:.6f} "
                f"{w * 1024 / 768:.6f} {h:.6f}" for c, cx, cy, w, h in inside]
        (root / "labels" / f"{stem}.txt").write_text("\n".join(rows) + "\n")
        stems.append(stem)
        with open(root / "fold01.txt", "a") as f:
            f.write(stem + "\n")
    changepath(str(root / "fold01.txt"), str(root / "fold01_write.txt"),
               str(root / "images"), suffix="_co.png")
    lst = lambda name, picked: (root / name).write_text(
        "".join(f"{root / 'images' / s}_co.png\n" for s in picked))
    lst("fold_val.txt", stems[:2])
    lst("fold_eval.txt", stems[:2] + stems[-1:])
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump(
        {"train": str(root / "fold01_write.txt"),
         "val": str(root / "fold01_write.txt"),
         "test": str(root / "fold_val.txt"), "nc": 8,
         "names": [f"c{i}" for i in range(8)]}))
    return {"root": root, "stems": stems, "list": root / "fold01_write.txt",
            "val_list": root / "fold_val.txt",
            "eval_list": root / "fold_eval.txt", "data": data}


def trained_pair():
    """The trained flagship (runs/flagship_r5_150ep/best_stripped, its EMA
    weights) in both packages, f32 on the CPU: (JAX model, its variables as
    numpy, the port's model in eval mode with the same weights)."""
    import jax
    from pathlib import Path
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.train.checkpoint import eval_variables, load_checkpoint
    from sodt_tpu_torch.models import build_model as tbuild
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    from sodt_tpu_torch.weights import from_jax_variables
    root = Path(__file__).resolve().parent.parent
    v = jax.tree.map(np.asarray, eval_variables(
        load_checkpoint(root / "runs/flagship_r5_150ep/best_stripped")))
    jm = jbuild(str(root / "sodt_tpu/configs/model.yaml"), ch_in=4,
                input_mode="RGB+IR")
    tm = tbuild(str(root / "sodt_tpu_torch/configs/model.yaml"), ch_in=4)
    tm.load_state_dict(from_jax_variables(v))
    return jm, v, cache_rel_bias(tm.eval())


def same_dets(td, tv, jd, jv, tol):
    """The port's NMS output (torch) against JAX's: the same survivors,
    at least one, and their boxes, scores and classes within `tol`."""
    jd, jv = np.asarray(jd), np.asarray(jv)
    tv = tv.numpy()
    assert (tv == jv).all(), (tv.sum(1), jv.sum(1))
    assert tv.any()
    close(td.numpy()[tv], jd[jv], tol)


TINY_CFG = "tests/tiny.yaml"   # tests/test_aux.py's all-CNN detector


def tiny_pair(seed: int, img: int = 64, detect_bias: float = 0.0):
    """tests/tiny.yaml (RGB, three classes, one Detect level at stride 4)
    in both packages, weights drawn with numpy from `seed`; with
    `detect_bias` the Detect objectness bias raised by it and the class
    biases by a third of it. (JAX model, variables as numpy, the port's
    model in eval mode.)"""
    from pathlib import Path
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu_torch.models import build_model as tbuild
    from sodt_tpu_torch.weights import from_jax_variables
    cfg = str(Path(__file__).resolve().parent.parent / TINY_CFG)
    jm = jbuild(cfg, ch_in=3, input_mode="RGB")
    x0 = j(np.zeros((1, img, img, 3), np.float32))
    v = drawn_variables(jm, x0, x0, seed=seed, train=False)
    if detect_bias:
        bias = np.array(v["params"]["detect"]["m0"]["bias"])
        no = 5 + 3
        bias[4::no] += detect_bias
        for c in range(5, no):
            bias[c::no] += detect_bias / 3
        v["params"]["detect"]["m0"]["bias"] = bias
    tm = tbuild(cfg, ch_in=3, input_mode="RGB").eval()
    tm.load_state_dict(from_jax_variables(v))
    return jm, v, tm


def narrow_pair(seed: int, img: int = 64):
    """The narrow flagship (`NARROW_CFG`, RGB+IR) in both packages from a
    JAX init drawn with `seed` and perturbed by `randomize_variables`:
    (JAX model, variables as numpy, the port's model in eval mode)."""
    import jax
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu_torch.models import build_model as tbuild
    from sodt_tpu_torch.train.evaluate import cache_rel_bias
    from sodt_tpu_torch.weights import from_jax_variables
    jm = jbuild(NARROW_CFG, ch_in=4, input_mode="RGB+IR")
    x0 = j(np.zeros((1, img, img, 3), np.float32))
    # jitted: flax's eager init of the Swin encoder takes ~30 s on the CPU
    init = jax.jit(lambda k, x: jm.init(k, x, x, train=False))
    v = randomize_variables(
        jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), x0)), seed)
    tm = tbuild(NARROW_CFG, ch_in=4).eval()
    tm.load_state_dict(from_jax_variables(v))
    return jm, v, cache_rel_bias(tm)


def jax_read_image(path, cv2_branch: bool) -> np.ndarray:
    """The JAX package's `_read_image` of a file, through cv2 or, as on a
    machine without cv2, through PIL."""
    from sodt_tpu.data import vedai as jv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jv, "_HAS_CV2", cv2_branch)
        return jv._read_image(str(path))


def pil_scan(path):
    """JAX's integrity scan of one file: None where it marks the file
    corrupt, else PIL's (width, height)."""
    from PIL import Image
    try:
        with Image.open(path) as im:
            im.verify()
            w, h = im.size
            assert w > 9 and h > 9
            return w, h
    except Exception:
        return None


# name -> (codec, kind, layout, damage): a TIFF of 37 x 29 px whose middle
# strip (8 rows) or tile (16 x 16) is cut short (its byte count halved) or
# garbled (four bytes at a third of its data inverted). LZW is cv2's writer
# (with predictor 2), the others the port's `write_tiff`.
DAMAGED_STRIPS = {
    "lzw_rgb8_one_strip_cut": ("lzw", "rgb8", "one_strip", "cut"),
    "lzw_rgb8_strips_garbled": ("lzw", "rgb8", "strips", "garble"),
    "lzw_gray8_strips_cut": ("lzw", "gray8", "strips", "cut"),
    "packbits_rgb8_strips_cut": ("packbits", "rgb8", "strips", "cut"),
    "packbits_gray8_one_strip_cut": ("packbits", "gray8", "one_strip", "cut"),
    "packbits_palette8_strips_cut": ("packbits", "palette8", "strips", "cut"),
    "packbits_bit1_one_strip_cut": ("packbits", "bit1", "one_strip", "cut"),
    "deflate_rgb8_pred2_tiles_cut": ("deflate", "rgb8", "tiles", "cut"),
    "deflate_gray8_strips_garbled": ("deflate", "gray8", "strips", "garble"),
    "deflate_palette8_tiles_cut": ("deflate", "palette8", "tiles", "cut"),
    "deflate_gray16_strips_cut": ("deflate", "gray16", "strips", "cut"),
}


def bmp_tiff_script():
    """`tests/torch_port_bmp_tiff/make_fixtures.py` as a module: its BMP
    and TIFF writers, which write any kind byte by byte."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "make_fixtures",
        Path(__file__).resolve().parent / "torch_port_bmp_tiff"
        / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def damaged_tiff(tmp_path, name: str):
    """The file DAMAGED_STRIPS names, written under tmp_path."""
    import struct
    from sodt_tpu_torch.data import tiff
    codec, kind, layout, damage = DAMAGED_STRIPS[name]
    rng = np.random.default_rng(len(name))
    y, x = np.mgrid[:37, :29]
    img = np.clip(128 + 90 * np.sin(x[..., None] / 5.0 + np.arange(3))
                  * np.cos(y[..., None] / 7.0)
                  + rng.normal(0, 18, (37, 29, 3)), 1, 255).astype(np.uint8)
    path = tmp_path / f"{name}.tif"
    strips = None if layout == "one_strip" else 8
    if codec == "lzw":
        import cv2
        params = [cv2.IMWRITE_TIFF_COMPRESSION,
                  cv2.IMWRITE_TIFF_COMPRESSION_LZW]
        if strips:
            params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, strips]
        arr = img[..., ::-1] if kind == "rgb8" else img[..., 0]
        assert cv2.imwrite(str(path), arr, params)
    else:
        kw = dict(compression=codec, predictor=2 if "pred2" in name else 1)
        kw.update(tile=(16, 16)) if layout == "tiles" else kw.update(
            rows_per_strip=strips)
        arr = {"rgb8": img, "gray8": img[..., 0],
               "palette8": img[..., 0], "bit1": img[..., 0] > 128,
               "gray16": img[..., 0].astype(np.uint16) * 257}[kind]
        if kind == "palette8":
            kw.update(photometric=3, colormap=rng.integers(
                0, 65536, (256, 3)))
        if kind == "bit1":
            arr = arr.astype(np.uint8)
            kw.update(bits=1)
        bmp_tiff_script().write_tiff(path, arr, **kw)
    data = bytearray(path.read_bytes())
    t = tiff._info(bytes(data), str(path))
    k = len(t.offsets) // 2
    off, cnt = t.offsets[k], t.counts[k]
    if damage == "garble":
        for i in range(off + cnt // 3, off + cnt // 3 + 4):
            data[i] ^= 0xFF
    else:                               # the count's place in the IFD
        pos = struct.unpack_from("<I", data, 4)[0]
        for e in range(pos + 2, pos + 2 + 12 * data[pos], 12):
            tag, typ, n = struct.unpack_from("<HHI", data, e)
            if tag in (279, 325):
                size = 2 if typ == 3 else 4
                at = e + 8 if n * size <= 4 else struct.unpack_from(
                    "<I", data, e + 8)[0]
                struct.pack_into("<H" if size == 2 else "<I", data,
                                 at + k * size, cnt // 2)
    path.write_bytes(bytes(data))
    return path


def folder_as(tmp_path_factory, ext: str, write) -> dict:
    """`write_vedai_folder`'s pairs (n=4) written again by `write(path,
    pixels)` as `<stem>_co.<ext>` (RGB) and `<stem>_ir.<ext>` (gray (H, W)),
    with the labels and the fold lists of that folder."""
    import cv2
    src = write_vedai_folder(tmp_path_factory.mktemp("png"), n=4)
    root = tmp_path_factory.mktemp(ext)
    (root / "images").mkdir()
    (root / "labels").mkdir()
    for stem in src["stems"]:
        co = cv2.imread(str(src["root"] / "images" / f"{stem}_co.png"))
        ir = cv2.imread(str(src["root"] / "images" / f"{stem}_ir.png"),
                        cv2.IMREAD_UNCHANGED)
        write(root / "images" / f"{stem}_co.{ext}", co[..., ::-1].copy())
        write(root / "images" / f"{stem}_ir.{ext}",
              ir if ir.ndim == 2 else ir[..., 0].copy())
        lab = src["root"] / "labels" / f"{stem}.txt"
        (root / "labels" / f"{stem}.txt").write_bytes(lab.read_bytes())
    lst = lambda name, stems: (root / name).write_text("".join(
        f"{root / 'images' / s}_co.{ext}\n" for s in stems))
    stems = src["stems"]
    lst("fold.txt", stems)
    lst("fold_val.txt", stems[:2])
    lst("fold_eval.txt", stems[:2] + stems[-1:])
    return {"root": root, "list": root / "fold.txt", "png": src,
            "val_list": root / "fold_val.txt",
            "eval_list": root / "fold_eval.txt", "n": len(stems)}


def batches_equal_jax(folder: dict, rect: bool, img: int = 256) -> None:
    """JAX's VedaiDataset + make_eval_batches and the port's give bit-equal
    batches on the folder, square or --rect (sizes from the headers)."""
    from sodt_tpu.data.loader import make_eval_batches as jbatches
    from sodt_tpu.data.vedai import VedaiDataset as JDS
    from sodt_tpu_torch.data import VedaiDataset as TDS, make_eval_batches
    lst = folder["eval_list"] if rect else folder["val_list"]
    jds = JDS(str(lst), img_size=img)
    tds = TDS(str(lst), img_size=img)
    assert tds.img_files == jds.img_files and len(tds) == (3 if rect else 2)
    shapes = set()
    for a, b in zip(jbatches(jds, 2, img, rect=rect),
                    make_eval_batches(tds, 2, img, rect=rect)):
        for k in ("img", "ir", "targets", "tmask"):
            np.testing.assert_array_equal(b[k], np.asarray(a[k]))
        for k in ("indices", "valid", "shapes", "stems"):
            assert b[k] == a[k], k
        assert b.get("net_shape") == a.get("net_shape")
        shapes.add(b["img"].shape[1:3])
    assert shapes == ({(288, 288), (288, 224)} if rect else {(img, img)})


def val_equals_jax(folder: dict, tmp_path, img: int = 256,
                   tol: float = 5e-3) -> dict:
    """`val --data --rect` of the port on the folder's eval list against
    JAX's evaluate of the same files with the in-repo checkpoint, within
    test_torch_port_folders.py's bound; returns the port's metrics."""
    from pathlib import Path
    import jax
    import yaml
    from sodt_tpu.data.loader import make_eval_batches as jbatches
    from sodt_tpu.data.vedai import VedaiDataset as JDS
    from sodt_tpu.models import build_model as jbuild
    from sodt_tpu.train.checkpoint import eval_variables, load_checkpoint
    from sodt_tpu.train.evaluate import evaluate as jevaluate
    from sodt_tpu_torch import val
    from sodt_tpu_torch.weights import from_jax_variables, save_npz
    root = Path(__file__).resolve().parent.parent
    lst = folder["eval_list"]
    data = tmp_path / "data.yaml"
    data.write_text(yaml.safe_dump({"val": str(lst), "nc": 8}))
    v = jax.tree.map(np.asarray, eval_variables(
        load_checkpoint(root / "runs/flagship_r5_150ep/best_stripped")))
    npz = tmp_path / "flagship.npz"
    save_npz(from_jax_variables(v), npz)
    jm = jbuild(str(root / "sodt_tpu/configs/model.yaml"), ch_in=4,
                input_mode="RGB+IR")
    mj = jevaluate(jm, v, jbatches(JDS(str(lst), img_size=img), 2, img,
                                   rect=True), nc=8, img_size=img)
    mt = val.main(["--data", str(data), "--weights", str(npz),
                   "--img-size", str(img), "--batch-size", "2", "--device",
                   "cpu", "--no-bf16", "--rect"])
    assert mt["seen"] == mj["seen"] == 3 and mt["nt"] == mj["nt"]
    for k in ("map50", "map"):
        assert abs(mt[k] - mj[k]) <= tol, (k, mt[k], mj[k])
    assert mj["map50"] > 0.5
    return mt


class _BitWriter:
    """LSB-first bits, as a VP8L stream packs them."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, bits: int):
        self.acc |= (value & ((1 << bits) - 1)) << self.n
        self.n += bits
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def put_bytes(self, values: np.ndarray):
        """Each uint8 of `values` as 8 bits, in order (numpy, not a loop)."""
        a = np.asarray(values, np.uint8).reshape(-1).astype(np.uint16)
        if not a.size:
            return
        k = self.n
        if k == 0:
            self.out += a.astype(np.uint8).tobytes()
            return
        out = (a << k) & 0xFF
        out[0] |= self.acc
        out[1:] |= a[:-1] >> (8 - k)
        self.out += out.astype(np.uint8).tobytes()
        self.acc = int(a[-1] >> (8 - k))

    def bytes(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def _vp8l_code8(bw: _BitWriter, use_length: bool):
    """A prefix code giving each of the first 256 symbols 8 bits: a normal
    code whose code-length code has one symbol (8), so that each length
    reads no bits; with `use_length`, the alphabet (green's 280) is cut
    to 256 lengths."""
    bw.put(0, 1)                       # not a simple code
    bw.put(12 - 4, 4)                  # 12 code-length code lengths
    for i in range(12):                # the order's 12th symbol is 8
        bw.put(1 if i == 11 else 0, 3)
    bw.put(int(use_length), 1)
    if use_length:
        bw.put(3, 3)                   # 8 bits of max_symbol
        bw.put(256 - 2, 8)


def _vp8l_single(bw: _BitWriter, symbol: int):
    """A simple prefix code of one 8-bit symbol (it reads no bits)."""
    bw.put(1, 1)
    bw.put(0, 1)
    bw.put(1, 1)
    bw.put(symbol, 8)


def vp8l_stream(argb: np.ndarray, header: bool = True,
                alpha_used: bool = True) -> bytes:
    """A minimal VP8L bitstream of an (h, w, 4) A R G B uint8 image: the
    5-byte header (left out for an ALPH chunk's stream), no transform, no
    colour cache, one prefix-code group of fixed 8-bit codes for green,
    red, blue (and alpha unless all 255), literal pixels only."""
    h, w, _ = argb.shape
    bw = _BitWriter()
    if header:
        bw.put(0x2F, 8)
        bw.put(w - 1, 14)
        bw.put(h - 1, 14)
        bw.put(int(alpha_used), 1)
        bw.put(0, 3)
    bw.put(0, 1)                       # no transform
    bw.put(0, 1)                       # no colour cache
    bw.put(0, 1)                       # no meta prefix codes
    opaque = bool((argb[..., 0] == 255).all())
    _vp8l_code8(bw, use_length=True)   # green
    _vp8l_code8(bw, use_length=False)  # red
    _vp8l_code8(bw, use_length=False)  # blue
    if opaque:
        _vp8l_single(bw, 255)
    else:
        _vp8l_code8(bw, use_length=False)
    bw.put(1, 1)                       # distance: one 1-bit symbol, 0
    bw.put(0, 1)
    bw.put(0, 1)
    bw.put(0, 1)
    # each symbol's 8-bit code is the symbol, read from its top bit: the
    # stream carries its bits reversed
    rev = np.array([int(f"{s:08b}"[::-1], 2) for s in range(256)], np.uint8)
    order = [2, 1, 3] if opaque else [2, 1, 3, 0]       # G R B (A)
    bw.put_bytes(rev[argb.reshape(-1, 4)[:, order]])
    return bw.bytes()


def riff(chunks: list) -> bytes:
    """A WebP file of (fourcc, payload) chunks, each padded to even."""
    body = b"".join(k + len(p).to_bytes(4, "little") + p + b"\0" * (len(p) & 1)
                    for k, p in chunks)
    return b"RIFF" + (4 + len(body)).to_bytes(4, "little") + b"WEBP" + body


def write_webp_lossless(path, rgb: np.ndarray) -> None:
    """An (h, w, 3) RGB or (h, w) gray image as a lossless WebP file of
    `vp8l_stream` (what the port's tests use where cv2 is absent)."""
    rgb = np.asarray(rgb, np.uint8)
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, -1)
    argb = np.concatenate([np.full(rgb.shape[:2] + (1,), 255, np.uint8),
                           rgb], -1)
    from pathlib import Path
    Path(path).write_bytes(riff([(b"VP8L", vp8l_stream(argb,
                                                        alpha_used=False))]))
