"""AVIF through the port's reader (``core/imread.py`` -> ``core/avif.py``, the
AV1 stream in ``ops/native/av1.cpp``) against live ``cv2.imread`` and
``cv2.imdecode`` (the JAX package's readers; cv2 5.0 with libavif 1.4.2
over libaom 3.14.1) in both read modes: every pixel equal where cv2
decodes, ``FileNotFoundError`` exactly where cv2 returns None.

- the committed fixtures of ``tests/data/avif/make_fixtures.py`` (cv2's
  quality and speed sweeps, gray, BGRA, odd sides, screen content; PIL's
  4:4:4, 4:0:0, 4:2:2, limited range, tiles and libaom tool options; intra
  block copy in 4:2:0, 4:4:4, 4:2:2 and 4:0:0; ``nclx`` edits; files cv2
  refuses; the avif480 and avif_pil480 COCO scenes) against the decodes
  stored beside them and live cv2, and the decoder's path counters summed
  over them (each intra block copy and 4:2:2 path reached);
- every cut of five small files, seeded byte flips of six;
- the forms the port does not decode (ROADMAP A10 part 3, step 6b: 10 and
  12 bits, film grain, a colour matrix libavif converts in floating point)
  raise ``UnsupportedImage`` where cv2 decodes;
- the tables of ``ops/native/av1_tables.h`` against cv2's libaom
  (``extract_tables.py --check``), the inverse transforms against
  libaom's own C functions (``transforms_check.py``), and a process that
  reads AVIF maps no codec library;
- the two COCO trees of AVIF scenes (cv2's and PIL's files) converted by
  both packages' ``transfer_coco`` (file for file equal), read by both
  datasets (every field equal), and two port train steps on each.
"""
import glob
import importlib.util
import io
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.data import converters as jconv
from instancesegmentation_tpu.data.dataset import InstanceCommonDataset as JaxDataset
from instancesegmentation_tpu_torch.core.avif import decode_avif
from instancesegmentation_tpu_torch.core.imread import imdecode, imread
from instancesegmentation_tpu_torch.core.png import UnsupportedImage
from instancesegmentation_tpu_torch.data import converters as tconv
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.data.pipeline import draw_augment, host_batch
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.ops.native.av1 import COUNTERS, last_counters
from instancesegmentation_tpu_torch.train.config import TrainConfig
from instancesegmentation_tpu_torch.train.state import TrainState
from instancesegmentation_tpu_torch.train.steps import augment_config, make_train_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "avif")
_spec = importlib.util.spec_from_file_location("avif_fixtures",
                                               os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)
#: what an unported form's message names
STEP = "A10 part 3, step 6b"


def _cv2(read):
    img = read()
    return None if img is None else img[..., ::-1] if img.ndim == 3 else img


def _port(read):
    try:
        return read()
    except FileNotFoundError:
        return None


def _same(got, want) -> bool:
    if got is None or want is None:
        return got is None and want is None
    return got.shape == want.shape and np.array_equal(got, want)


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name + ".avif"), "rb") as f:
        return f.read()


# -- the committed fixtures -------------------------------------------------------

FIXTURE_NAMES = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(FIXTURES,
                                                                               "*.avif")))


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixtures_equal_cv2_and_the_port(name):
    path = os.path.join(FIXTURES, name + ".avif")
    stored = np.load(path[:-5] + ".npz")
    data = _fixture(name)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        for decode, cv_read, port_read in (
                (False, lambda: cv2.imread(path, flag), lambda: imread(path, mode)),
                (True, lambda: cv2.imdecode(np.frombuffer(data, np.uint8), flag),
                 lambda: imdecode(data, mode))):
            assert mf.matches(stored, mode, decode, _cv2(cv_read)), ("stored vs cv2", mode, decode)
            assert mf.matches(stored, mode, decode, _port(port_read)), ("port", mode, decode)


def _av1c(data: bytes, item: int = 0) -> bytes:
    """The four bytes of the ``item``-th ``av1C`` property."""
    i = -1
    for _ in range(item + 1):
        i = data.index(b"av1C", i + 1)
    return data[i + 4:i + 8]


def test_fixture_set_is_complete():
    """At least 200 fixtures, among the ones that decode cv2's default file,
    loop restoration (speeds 0-4), lossless (quality 100), 4:0:0, BGRA with
    its alpha item, several tiles in 4:4:4, screen content (palettes), intra
    block copy and 4:2:2, and both COCO trees' scenes; the set stays under
    2 MB."""
    names = set(FIXTURE_NAMES)
    assert len(names) >= 200
    for t in mf.TIMED:
        assert t[:-5] in names
    for prefix in mf.TREES.values():
        assert {f"{prefix}{i:02d}" for i in range(mf.COCO_SCENES)} <= names
    assert set(mf.small_forms()) <= names
    assert len([n for n in names if n.startswith("ibc_")]) >= 15
    assert len([n for n in names if n.startswith("yuv422_")]) >= 15
    must = {"cv2_480x640": "default", "cv2_s02": "restoration", "cv2_q100": "lossless",
            "cv2_gray_q075": "4:0:0", "cv2_bgra_q090": "alpha", "pil444_tiles_480x640": "tiles",
            "cv2_screen_s2_0": "palette", "pil480_00": "intra block copy",
            "pil422_480x640": "4:2:2"}
    for name in must:
        stored = np.load(os.path.join(FIXTURES, name + ".npz"))
        assert "color_sha256" in stored, name  # cv2 decodes it, and so must the port
    assert _av1c(_fixture("cv2_gray_q075"))[2] & 0x10  # monochrome
    assert _fixture("cv2_bgra_q090").count(b"auxC") == 1 and b"auxl" in _fixture("cv2_bgra_q090")
    assert _av1c(_fixture("pil444_tiles_480x640"))[2] & 0x0C == 0  # 4:4:4
    assert _av1c(_fixture("pil422_480x640"))[2] & 0x0C == 0x08  # 4:2:2
    size = sum(os.path.getsize(p) for p in glob.glob(os.path.join(FIXTURES, "*")))
    assert size < 2_000_000, size


# -- damaged files -----------------------------------------------------------------

CUT = ("cv2_17x23", "cv2_gray_q030", "cv2_bgra_q050", "ibc_444_small", "yuv422_37x53")


@pytest.mark.parametrize("name", CUT)
def test_every_cut_matches_cv2(name):
    data = _fixture(name)
    assert len(data) <= 2048
    for n in range(1, len(data)):
        cut = data[:n]
        buf = np.frombuffer(cut, np.uint8)
        for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
            assert _same(_port(lambda: imdecode(cut, mode)), _cv2(lambda: cv2.imdecode(buf, flag))), \
                (n, mode)


@pytest.mark.parametrize("name", CUT + ("cv2_q050",))
def test_corrupt_bytes_match_cv2(name):
    """Seeded flips of one or three bytes past the ``ftyp`` box, in both
    modes.  Where cv2 decodes a flip whose ``ispe`` no longer gives the
    frame's sides (libavif then scales the frame: ROADMAP A10 part 3, step
    6b), the port raises ``UnsupportedImage`` naming it."""
    data = _fixture(name)
    rng = np.random.default_rng(sum(name.encode()))
    unported = 0
    for k in range(80):
        b = bytearray(data)
        for _ in range(1 if k < 60 else 3):
            b[int(rng.integers(32, len(b)))] ^= int(rng.integers(1, 256))
        b = bytes(b)
        buf = np.frombuffer(b, np.uint8)
        for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
            want = _cv2(lambda: cv2.imdecode(buf, flag))
            try:
                got = _port(lambda: imdecode(b, mode))
            except UnsupportedImage as e:
                assert STEP in str(e) and "scaled to its ispe" in str(e) and want is not None
                unported += 1
                continue
            assert _same(got, want), (k, mode)
    assert unported <= 4, unported


# -- the forms of step 6b --------------------------------------------------------------


def _pil(img: np.ndarray, **kwargs) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="AVIF", **kwargs)
    return buf.getvalue()


def _unported_forms() -> dict:
    img16 = mf.picture(24, 32, 3, noise=4).astype(np.uint16) * 257
    out = {}
    for depth in (10, 12):
        ok, buf = cv2.imencode(".avif", img16, [cv2.IMWRITE_AVIF_DEPTH, depth])
        out[f"bits_{depth}"] = (buf.tobytes(), f"bit depth {depth}")
    out["matrix_smpte240"] = (mf.nclx(mf.cv2_avif(mf.picture(16, 24, 5)), 7, True),
                              "matrix coefficients 7")
    # libaom's test grain table: the frame decodes, its grain is left out
    out["film_grain"] = (_pil(mf.picture(24, 32, 6, noise=8), quality=60,
                              advanced={"film-grain-test": "1"}), "film grain")
    return out


@pytest.mark.parametrize("form", sorted(_unported_forms()))
def test_unported_forms_raise(form):
    data, what = _unported_forms()[form]
    buf = np.frombuffer(data, np.uint8)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
        assert cv2.imdecode(buf, flag) is not None
        with pytest.raises(UnsupportedImage, match=STEP) as info:
            imdecode(data, mode)
        assert what in str(info.value)


def test_fixtures_reach_every_decoder_path():
    """The decoder's path counters (``av1_test_counters``), summed over the
    fixtures' colour decodes, show intra block copy in 4:4:4, 4:2:0, 4:2:2
    and 4:0:0, chroma predicted at half pixels in 4:2:0 and 4:2:2, a
    displacement vector referred to a neighbour's and to the default one,
    transform trees split to depths 1 and 2, each inter transform set, and
    4:2:2 chroma filtered by CDEF along a remapped direction and by loop
    restoration; the intra-block-copy and 4:2:2 fixtures each reach their
    path."""
    total = dict.fromkeys(COUNTERS, 0)
    for name in FIXTURE_NAMES:
        if name.startswith("refused_"):
            continue
        decode_avif(_fixture(name))
        got = last_counters()
        for k, v in got.items():
            total[k] += v
        if name.startswith("ibc_"):
            assert sum(got[k] for k in COUNTERS[:4]) > 0, name
        if name.startswith("yuv422_"):
            assert got["blocks_422"] > 0, name
    missing = [k for k, v in total.items() if not v]
    assert not missing, (missing, total)


# -- the tables and the library ---------------------------------------------------------


def test_tables_equal_libaoms():
    """``av1_tables.h`` is what ``extract_tables.py`` reads out of cv2's
    libaom 3.14.1 (where that binary is present)."""
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    if not glob.glob(os.path.join(libs, "libaom-*.so.3.14.1")):
        pytest.skip("no libaom 3.14.1 beside cv2 here")
    out = subprocess.run([sys.executable, os.path.join(FIXTURES, "extract_tables.py"), "--check"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_inverse_transforms_equal_libaoms():
    """The port's 1-D and 2-D inverse transforms, every size and type AV1
    codes, equal libaom's own C functions on seeded coefficients
    (``transforms_check.py``, in a process of its own: it calls into cv2's
    libaom where that binary is present)."""
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    if not glob.glob(os.path.join(libs, "libaom-*.so.3.14.1")):
        pytest.skip("no libaom 3.14.1 beside cv2 here")
    out = subprocess.run([sys.executable, os.path.join(FIXTURES, "transforms_check.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr


def test_reading_avif_loads_no_codec_library():
    """A process that decodes AVIF through the port maps no libaom, libavif,
    dav1d or libyuv (nor cv2 or PIL): the decoder is the port's own C++
    (``build/native/libav1_<hash>.so``, built from ``ops/native/av1.cpp``),
    whose sources include no codec header."""
    native = os.path.join(ROOT, "instancesegmentation_tpu_torch", "ops", "native")
    for src in ("av1.cpp", "av1_tables.h"):
        with open(os.path.join(native, src)) as f:
            includes = [line for line in f.read().splitlines() if line.startswith("#include")]
        assert not [i for i in includes if any(k in i for k in ("aom", "avif", "dav1d", "yuv"))]
    code = (
        "import sys\n"
        "from instancesegmentation_tpu_torch.core.imread import imread\n"
        f"img = imread({os.path.join(FIXTURES, 'cv2_bgra_q090.avif')!r})\n"
        f"img = imread({os.path.join(FIXTURES, 'pil_444_q60.avif')!r})\n"
        "import os, re\n"
        "files = {l.split()[-1] for l in open('/proc/self/maps') if '/' in l}\n"
        "names = {os.path.basename(f) for f in files}\n"
        "assert not [n for n in names if re.match(r'lib(aom|avif|dav1d|yuv)', n)]\n"
        "assert [f for f in files if re.search(r'build/native/libav1_[0-9a-f]+\\.so$', f)]\n"
        "assert 'cv2' not in sys.modules and 'PIL' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_decode_avif_modes():
    """``decode_avif`` straight (RGB, and cv2's gray of it) equals cv2 on a
    BGRA file, and refuses a mode it does not know through ``imdecode``."""
    data = _fixture("cv2_bgra_q050")
    buf = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(decode_avif(data), cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1])
    np.testing.assert_array_equal(decode_avif(data, "gray"),
                                  cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))
    with pytest.raises(ValueError, match="read mode"):
        imdecode(data, "bgr")


# -- a COCO tree of AVIF images ---------------------------------------------------


def _avif_coco_tree(root: str, ids: list, prefix: str = "coco_") -> tuple[str, str]:
    """The committed 480 x 640 AVIF scenes ``ids`` (fixtures ``prefix`` +
    number) as a COCO tree under ``.jpg`` names (polygon people from
    ``coco_scenes.json``, 17 visible keypoints each)."""
    with open(os.path.join(FIXTURES, "coco_scenes.json")) as f:
        scenes = json.load(f)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, annotations = [], []
    for n, i in enumerate(ids):
        name = f"{n:012d}.jpg"
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(_fixture(f"{prefix}{i:02d}"))
        images.append({"id": n, "file_name": name, "height": scenes["height"],
                       "width": scenes["width"]})
        for j, (cx, cy, ax, ay) in enumerate(scenes["people"][i]):
            ang = 2 * np.pi * np.arange(24) / 24
            ring = np.stack([cx + ax * np.cos(ang), cy + ay * np.sin(ang)], 1).round(2)
            kang = 2 * np.pi * np.arange(17) / 17
            keypoints = np.stack([cx + 0.6 * ax * np.cos(kang), cy + 0.6 * ay * np.sin(kang),
                                  np.full(17, 2)], 1).astype(int)
            annotations.append({"id": 2 * n + j, "image_id": n, "category_id": 1,
                                "segmentation": [ring.ravel().tolist()],
                                "bbox": [round(cx - ax, 2), round(cy - ay, 2), round(2 * ax, 2),
                                         round(2 * ay, 2)],
                                "keypoints": keypoints.ravel().tolist()})
    ann = os.path.join(root, "instances.json")
    with open(ann, "w") as f:
        json.dump({"categories": [{"id": 1, "name": "person"}], "images": images,
                   "annotations": annotations}, f)
    return img_dir, ann


def _tree_files(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.relpath(os.path.join(d, name), root)] = f.read()
    return out


def test_avif_coco_tree_converts_and_trains_as_jax(tmp_path):
    """Each tree, one scene of each of its forms (avif480: cv2's default,
    speed 2, gray, PIL 4:4:4 in two tiles, BGRA; avif_pil480: PIL's default,
    4:2:2, PIL's default, 4:4:4 in two tiles with intra block copy): both
    packages' ``transfer_coco`` write the same tree, file for file (the
    AVIF images copied as they were), both datasets give the same samples,
    and two port train steps on the first four give finite losses."""
    for tree in sorted(mf.TREES):
        _check_tree(tmp_path / tree, tree)


def _check_tree(tmp_path, tree: str) -> None:
    prefix = mf.TREES[tree]
    ids = list(range(len(mf.COCO_FORMS if tree == "avif480" else mf.PIL_FORMS)))
    img_dir, ann = _avif_coco_tree(str(tmp_path / "src"), ids, prefix)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tconv.transfer_coco(img_dir, ann, port_dir, progress=False) == len(ids)
    assert jconv.transfer_coco(img_dir, ann, jax_dir, progress=False) == len(ids)
    got, want = _tree_files(port_dir), _tree_files(jax_dir)
    assert sorted(got) == sorted(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    for n, i in enumerate(ids):
        assert got[os.path.join("image", f"{n:012d}.jpg")] == _fixture(f"{prefix}{i:02d}")
    port, ref = InstanceCommonDataset(port_dir, canvas=320), JaxDataset(jax_dir, canvas=320)
    assert len(port) == len(ref) == 2 * len(ids)
    for k in range(len(port)):
        a, b = port.fetch(k), ref.fetch(k)
        for field in ("image", "mask", "image_hw", "obj_box", "mask_box", "keypoints"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                          err_msg=f"sample {k} {field}")
    cfg = TrainConfig(train_dataset_dir=port_dir, val_dataset_dir=port_dir,
                      checkpoint_dir=str(tmp_path / "ckpt"), out_dir=str(tmp_path / "runs"),
                      canvas=320, out_size=64, in_channels=20, bfloat16=False, batch_size=4,
                      learning_rate=3e-3, save_iou_gate=0.0, log_images=False)
    batch = host_batch([port.fetch(k) for k in range(4)])
    model = Segment(20)
    init_weights_(model, torch.Generator().manual_seed(0))
    state = TrainState.create(model, cfg.learning_rate)
    train_step = make_train_step(cfg)
    draws = draw_augment(4, augment_config(cfg, True))
    losses = []
    for _ in range(2):
        state, metrics = train_step(state, batch, draws)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all(), losses
