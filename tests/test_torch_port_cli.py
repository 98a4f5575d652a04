"""The port's inference command against the JAX package's (CPU): the three
modes on the committed demo checkpoint (flax variables of ``Segment(20)``)
write the same file layout, and the masks the port writes are ≥ 99.9 % equal
to JAX's, also from JPEG images; dataset mode writes each mask in the format
of its record's extension as ``cv2.imwrite`` does (ROADMAP C12); the
extension filter, the once-refused flags ``--int8`` and ``--fused-stem``,
and the refusal of BMP files."""
import functools
import json
import os
import struct

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.data.synthetic import make_synthetic_dataset as jax_make
from instancesegmentation_tpu.infer.cli import main as jax_main
from instancesegmentation_tpu.models.segment import Segment as JaxSegment
from instancesegmentation_tpu_torch.core.keys import key_combine
from instancesegmentation_tpu_torch.core.imread import imread
from instancesegmentation_tpu_torch.core.imwrite import imencode, imwrite
from instancesegmentation_tpu_torch.core.png import (
    UnsupportedImage,
    encode_png,
    read_png,
    write_png,
)
from instancesegmentation_tpu_torch.core.records import common_ann_loader
from instancesegmentation_tpu_torch.data.dataset import InstanceCommonDataset
from instancesegmentation_tpu_torch.infer.cli import list_images, main

torch.set_num_threads(1)
SIZE = 64
DEMO = os.path.join(os.path.dirname(__file__), "..", "examples", "synthetic_demo.ckpt")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_cli")
    jax_make(str(root), num_images=3, objects_per_image=1, seed=5)
    return str(root)


@pytest.fixture(scope="module", autouse=True)
def jax_init_once():
    """The JAX command initialises a Segment (a ~10 s CPU compile per call)
    and then loads the checkpoint over it: each configuration's initial
    variables are computed once, from the command's own key, and handed to
    its later calls."""
    init, cache = JaxSegment.init, {}

    def cached(self, rng, *args, **kw):
        key = (self.in_channels, self.dtype, tuple(a.shape for a in args), tuple(kw.items()))
        if key not in cache:
            with jax.ensure_compile_time_eval():
                cache[key] = jax.jit(functools.partial(init, self, **kw))(
                    jax.random.PRNGKey(0), *[jnp.zeros(a.shape, a.dtype) for a in args])
        return cache[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxSegment, "init", cached)
        yield


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_masks(port_dir, jax_dir):
    """Same files; each port mask (read by the port's codec) ≥ 99.9 % equal
    to JAX's (read by cv2); returns the file list."""
    files = _files(port_dir)
    assert files and files == _files(jax_dir)
    for f in files:
        got = read_png(os.path.join(port_dir, f), "gray")
        want = cv2.imread(os.path.join(jax_dir, f), cv2.IMREAD_GRAYSCALE)
        assert got.shape == want.shape and set(np.unique(got)) <= {0, 255}
        assert (got == want).mean() >= 0.999, f
    return files


def test_whole_image_mode_and_continue_test(synth, tmp_path, capsys):
    argv = ["-i", os.path.join(synth, "image"), "--size", str(SIZE), "--batch", "4",
            "--float32", "--in-channels", "20", "--checkpoint", DEMO]
    assert main(["-o", str(tmp_path / "port")] + argv, device="cpu") == 0
    assert jax_main(["-o", str(tmp_path / "jax")] + argv) == 0
    files = _same_masks(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(files) == 3
    # --continue-test skips existing outputs: a removed one is written again
    os.remove(tmp_path / "port" / files[0])
    capsys.readouterr()
    assert main(["-o", str(tmp_path / "port"), "--continue-test"] + argv, device="cpu") == 0
    assert "wrote 1 masks" in capsys.readouterr().out
    assert _files(str(tmp_path / "port")) == files


def test_dataset_mode_mirrors_common_layout(synth, tmp_path):
    """``--dataset-mode`` on the 20-channel demo checkpoint at batch 2 (the
    tail batch's repeat dropped): one mask per eligible instance at its
    ``instance_mask/<image>/<i>.png`` path and the image's resolution."""
    argv = ["-i", synth, "--dataset-mode", "--size", str(SIZE), "--batch", "2",
            "--float32", "--checkpoint", DEMO]
    assert main(["-o", str(tmp_path / "port")] + argv, device="cpu") == 0
    assert jax_main(["-o", str(tmp_path / "jax")] + argv) == 0
    files = _same_masks(str(tmp_path / "port"), str(tmp_path / "jax"))
    ds = InstanceCommonDataset(synth)
    k = key_combine("instance_mask", "mask_path")
    assert len(ds) == 3 and files == sorted(rec[k] for rec in ds.records)
    for f in files:
        assert f.startswith("instance_mask" + os.sep)
        assert read_png(os.path.join(tmp_path, "port", f), "gray").shape == (240, 320)


C12_EXTS = (".png", ".bmp", ".jpg", ".tif", ".pgm", ".ppm")


def test_dataset_mode_writes_each_mask_in_its_records_format(tmp_path):
    """C12: a common-format tree whose six instance-mask paths end in
    ``.png``, ``.bmp``, ``.jpg``, ``.tif``, ``.pgm`` and ``.ppm`` (the input
    masks keep their PNG bytes: both readers go by content).  Both packages'
    ``--dataset-mode`` on the same float32 weights write the same set of
    files: none for ``.ppm`` (cv2 refuses a gray mask there, and the run goes
    on); the same bytes wherever the masks read back are equal, and the masks
    read back ≥ 99.9 % equal; a ``.png`` mask has the bytes of
    ``encode_png``, as before the repair."""
    data = tmp_path / "data"
    jax_make(str(data), num_images=6, objects_per_image=1, seed=7)
    k_obj, k_mask = key_combine("object", "sub_list"), key_combine("instance_mask", "mask_path")
    records = sorted(os.listdir(data / "data"))
    assert len(records) == len(C12_EXTS)
    for name, ext in zip(records, C12_EXTS):
        path = data / "data" / name
        rec = json.loads(path.read_text())
        for obj in rec[k_obj]:
            old = obj[k_mask]
            obj[k_mask] = os.path.splitext(old)[0] + ext
            os.rename(data / old, data / obj[k_mask])
        path.write_text(json.dumps(rec))
    argv = ["-i", str(data), "--dataset-mode", "--size", str(SIZE), "--batch", "2",
            "--float32", "--checkpoint", DEMO]
    assert main(["-o", str(tmp_path / "port")] + argv, device="cpu") == 0
    assert jax_main(["-o", str(tmp_path / "jax")] + argv) == 0
    files = _files(str(tmp_path / "port"))
    assert files == _files(str(tmp_path / "jax"))
    assert sorted(os.path.splitext(f)[1] for f in files) == sorted(set(C12_EXTS) - {".ppm"})
    same_bytes = 0
    for f in files:
        port_bytes = (tmp_path / "port" / f).read_bytes()
        jax_bytes = (tmp_path / "jax" / f).read_bytes()
        got = imread(str(tmp_path / "port" / f), "gray")
        want = cv2.imread(str(tmp_path / "jax" / f), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "port" / f),
                                                      cv2.IMREAD_GRAYSCALE))
        assert got.shape == want.shape and (got == want).mean() >= 0.999, f
        if np.array_equal(got, want):
            assert port_bytes == jax_bytes, f
            same_bytes += 1
        if f.endswith(".png"):
            assert port_bytes == encode_png(got)
    assert same_bytes >= len(files) - 1


def test_dataset_mode_writes_webp_masks(tmp_path):
    """ROADMAP C9 on ``infer``'s path: a tree whose instance-mask paths end
    in ``.webp`` (one record's in ``.WEBP``).  Both packages'
    ``--dataset-mode`` write a lossless WebP for every mask; the port's file
    holds ``imencode(".webp")``'s bytes of its mask, which cv2 and the
    port's reader decode to that mask, and the masks agree with the JAX
    run's as C12's do (at least 99.9 % of the pixels, float32 weights)."""
    data = tmp_path / "data"
    jax_make(str(data), num_images=3, objects_per_image=1, seed=11)
    k_obj, k_mask = key_combine("object", "sub_list"), key_combine("instance_mask", "mask_path")
    for k, name in enumerate(sorted(os.listdir(data / "data"))):
        path = data / "data" / name
        rec = json.loads(path.read_text())
        for obj in rec[k_obj]:
            old = obj[k_mask]
            obj[k_mask] = os.path.splitext(old)[0] + (".WEBP" if k == 2 else ".webp")
            os.rename(data / old, data / obj[k_mask])
        path.write_text(json.dumps(rec))
    argv = ["-i", str(data), "--dataset-mode", "--size", str(SIZE), "--batch", "2",
            "--float32", "--checkpoint", DEMO]
    assert main(["-o", str(tmp_path / "port")] + argv, device="cpu") == 0
    assert jax_main(["-o", str(tmp_path / "jax")] + argv) == 0
    files = _files(str(tmp_path / "port"))
    assert files == _files(str(tmp_path / "jax")) and len(files) == 3
    assert sorted(os.path.splitext(f)[1] for f in files) == [".WEBP", ".webp", ".webp"]
    for f in files:
        port_bytes = (tmp_path / "port" / f).read_bytes()
        jax_bytes = (tmp_path / "jax" / f).read_bytes()
        assert port_bytes[8:16] == jax_bytes[8:16] == b"WEBPVP8L", f
        got = imread(str(tmp_path / "port" / f), "gray")
        np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "port" / f),
                                                      cv2.IMREAD_GRAYSCALE))
        assert port_bytes == imencode(".webp", got), f
        want = cv2.imread(str(tmp_path / "jax" / f), cv2.IMREAD_GRAYSCALE)
        assert got.shape == want.shape and (got == want).mean() >= 0.999, f
        assert set(np.unique(got)) <= {0, 255} and got.any(), f


def test_dataset_mode_writes_jp2_masks(tmp_path):
    """``--dataset-mode`` on a tree whose instance-mask paths end in
    ``.jp2`` (one record's in ``.JP2``): both packages write a JPEG 2000 file
    for every mask, the port's holding ``imencode(".jp2")``'s bytes of its
    mask (cv2's encoder, byte for byte), and the same bytes as the JAX
    run's wherever the masks read back equal (at least all but one; the
    masks agree on at least 99.9 % of the pixels, float32 weights)."""
    data = tmp_path / "data"
    jax_make(str(data), num_images=3, objects_per_image=1, seed=13)
    k_obj, k_mask = key_combine("object", "sub_list"), key_combine("instance_mask", "mask_path")
    for k, name in enumerate(sorted(os.listdir(data / "data"))):
        path = data / "data" / name
        rec = json.loads(path.read_text())
        for obj in rec[k_obj]:
            old = obj[k_mask]
            obj[k_mask] = os.path.splitext(old)[0] + (".JP2" if k == 2 else ".jp2")
            os.rename(data / old, data / obj[k_mask])
        path.write_text(json.dumps(rec))
    argv = ["-i", str(data), "--dataset-mode", "--size", str(SIZE), "--batch", "2",
            "--float32", "--checkpoint", DEMO]
    assert main(["-o", str(tmp_path / "port")] + argv, device="cpu") == 0
    assert jax_main(["-o", str(tmp_path / "jax")] + argv) == 0
    files = _files(str(tmp_path / "port"))
    assert files == _files(str(tmp_path / "jax")) and len(files) == 3
    assert sorted(os.path.splitext(f)[1] for f in files) == [".JP2", ".jp2", ".jp2"]
    same_bytes = 0
    for f in files:
        port_bytes = (tmp_path / "port" / f).read_bytes()
        jax_bytes = (tmp_path / "jax" / f).read_bytes()
        assert port_bytes[4:8] == jax_bytes[4:8] == b"jP  ", f
        got = imread(str(tmp_path / "port" / f), "gray")
        np.testing.assert_array_equal(got, cv2.imread(str(tmp_path / "port" / f),
                                                      cv2.IMREAD_GRAYSCALE))
        assert port_bytes == imencode(".jp2", got), f
        want = cv2.imread(str(tmp_path / "jax" / f), cv2.IMREAD_GRAYSCALE)
        assert got.shape == want.shape and (got == want).mean() >= 0.999, f
        if np.array_equal(got, want):
            assert port_bytes == jax_bytes, f
            same_bytes += 1
        assert set(np.unique(got)) <= {0, 255} and got.any(), f
    assert same_bytes >= len(files) - 1


def test_write_png_is_encode_png(tmp_path):
    """``write_png`` (filter Sub, its default) writes ``encode_png``'s bytes,
    which are ``imwrite``'s for ``.png`` and cv2's."""
    rng = np.random.default_rng(3)
    for shape in ((1, 1), (7, 9), (30, 41, 3), (5, 6, 4)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        write_png(str(tmp_path / "a.png"), a, filter_type=1)
        assert imwrite(str(tmp_path / "b.png"), a)
        data = (tmp_path / "a.png").read_bytes()
        assert data == encode_png(a) == (tmp_path / "b.png").read_bytes()
        bgr = a if a.ndim == 2 else a[..., [2, 1, 0, 3][:a.shape[2]]]
        assert data == cv2.imencode(".png", np.ascontiguousarray(bgr))[1].tobytes()


def test_proposal_mode(synth, tmp_path):
    """``--proposals``: the first image's object box and a shifted copy; NMS
    at 0.5 keeps one; images without an entry write nothing."""
    ann = next(common_ann_loader(synth))
    name = os.path.splitext(os.path.basename(ann[key_combine("image", "image_path")]))[0]
    box = ann[key_combine("object", "sub_list")][0][key_combine("box", "box_xyxy")]
    props = tmp_path / "props.json"
    props.write_text(json.dumps({name: {"boxes": [box, [b + 1 for b in box]],
                                        "scores": [0.9, 0.5]}}))
    argv = ["-i", os.path.join(synth, "image"), "--proposals", str(props), "--size",
            str(SIZE), "--float32", "--nms-threshold", "0.5", "--in-channels", "20",
            "--checkpoint", DEMO]
    assert main(["-o", str(tmp_path / "port")] + argv, device="cpu") == 0
    assert jax_main(["-o", str(tmp_path / "jax")] + argv) == 0
    assert _same_masks(str(tmp_path / "port"), str(tmp_path / "jax")) == [f"{name}_0.png"]


def test_list_images_filters_extensions(tmp_path):
    for f in ("a.jpg", "b.png", "c.txt", "d.jpgerr", "e.BMP", "f.jpeg"):
        (tmp_path / f).write_bytes(b"x")
    assert [os.path.basename(p) for p in list_images(str(tmp_path))] == [
        "a.jpg", "b.png", "e.BMP", "f.jpeg"]


@pytest.mark.parametrize("mode", [[], ["--proposals", "props.json"]], ids=["whole", "proposals"])
def test_jpeg_raises_naming_the_file(mode, tmp_path):
    """A listed BMP decodes as cv2 decodes it since the BMP codec landed (RLE
    too, since its decoder landed; a TIFF, a WebP and a JPEG 2000 too, since
    their decoders landed; an 8-bit AVIF too, since its decoder landed); a
    listed image of a form the port does not decode (a 10-bit AVIF named
    ``.bmp``: cv2 goes by content; ROADMAP A10 part 3, step 6b) is never
    skipped: the command raises ``UnsupportedImage`` naming the
    file, here before it writes anything."""
    img = tmp_path / "img"
    img.mkdir()
    cv2.imwrite(str(img / "a.png"), np.zeros((20, 20, 3), np.uint8))
    pixels = np.random.default_rng(2).integers(0, 256, (20, 20, 3), dtype=np.uint8)
    cv2.imwrite(str(img / "b.bmp"), pixels)
    np.testing.assert_array_equal(imread(str(img / "b.bmp")), pixels[..., ::-1])
    rle8 = bytearray((img / "b.bmp").read_bytes()[:54]) + bytes(1024)
    rle8 += b"\x14\x07\x00\x00" * 20 + b"\x00\x01"  # 20 rows of one run of 20 pixels
    rle8[28:34] = struct.pack("<HI", 8, 1)  # 8 bits per pixel, BI_RLE8
    rle8[10:14] = struct.pack("<I", 54 + 1024)
    (img / "d.bmp").write_bytes(bytes(rle8))
    np.testing.assert_array_equal(imread(str(img / "d.bmp")),
                                  cv2.imread(str(img / "d.bmp"))[..., ::-1])
    (img / "d.bmp").unlink()
    ok, tiff = cv2.imencode(".tiff", pixels)
    (img / "d.bmp").write_bytes(tiff.tobytes())
    np.testing.assert_array_equal(imread(str(img / "d.bmp")), pixels[..., ::-1])
    (img / "d.bmp").unlink()
    ok, webp = cv2.imencode(".webp", pixels)
    (img / "d.bmp").write_bytes(webp.tobytes())
    np.testing.assert_array_equal(imread(str(img / "d.bmp")),
                                  cv2.imread(str(img / "d.bmp"))[..., ::-1])
    (img / "d.bmp").unlink()
    ok, jp2 = cv2.imencode(".jp2", np.tile(pixels, (2, 2, 1)))  # OpenJPEG needs 33+ pixels a side
    (img / "d.bmp").write_bytes(jp2.tobytes())
    np.testing.assert_array_equal(imread(str(img / "d.bmp")),
                                  cv2.imread(str(img / "d.bmp"))[..., ::-1])
    (img / "d.bmp").unlink()
    ok, avif = cv2.imencode(".avif", np.tile(pixels, (2, 2, 1)))
    (img / "d.bmp").write_bytes(avif.tobytes())
    np.testing.assert_array_equal(imread(str(img / "d.bmp")),
                                  cv2.imread(str(img / "d.bmp"))[..., ::-1])
    (img / "d.bmp").unlink()
    ok, avif = cv2.imencode(".avif", np.tile(pixels, (2, 2, 1)).astype(np.uint16) * 257,
                            [cv2.IMWRITE_AVIF_DEPTH, 10])
    (img / "c.bmp").write_bytes(avif.tobytes())
    assert cv2.imread(str(img / "c.bmp")) is not None
    (tmp_path / "props.json").write_text(json.dumps({"c": {"boxes": [[0, 0, 9, 9]],
                                                           "scores": [1.0]}}))
    mode = [str(tmp_path / m) if m.endswith(".json") else m for m in mode]
    out = tmp_path / "out"
    with pytest.raises(UnsupportedImage, match="c.bmp"):
        main(["-i", str(img), "-o", str(out), "--size", "32", "--float32"] + mode, device="cpu")
    assert not out.exists() or not os.listdir(out)


def test_whole_image_mode_reads_jpeg(synth, tmp_path):
    """``.jpg`` and ``.jpeg`` inputs (written by cv2, one progressive)
    decode as cv2 decodes them: the masks match JAX's as from PNG."""
    img = tmp_path / "img"
    img.mkdir()
    for k, src in enumerate(sorted(os.listdir(os.path.join(synth, "image")))):
        pixels = cv2.imread(os.path.join(synth, "image", src))
        name = f"im{k}." + ("jpeg" if k == 1 else "jpg")
        cv2.imwrite(str(img / name), pixels, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                               cv2.IMWRITE_JPEG_PROGRESSIVE, int(k == 2)])
    argv = ["-i", str(img), "--size", str(SIZE), "--batch", "4", "--float32",
            "--in-channels", "20", "--checkpoint", DEMO]
    assert main(["-o", str(tmp_path / "port")] + argv, device="cpu") == 0
    assert jax_main(["-o", str(tmp_path / "jax")] + argv) == 0
    assert _same_masks(str(tmp_path / "port"), str(tmp_path / "jax")) == [
        "im0.png", "im1.png", "im2.png"]


@pytest.mark.parametrize("flag", ["--int8", "--fused-stem"])
def test_unported_flags_raise(flag, synth, tmp_path, capsys):
    """Both flags, once refused, are ported.  ``--int8``: dataset mode
    calibrates on the input's first batches (printing JAX's line) and writes
    masks >= 99.9 % equal to JAX's.  ``--fused-stem``: dataset mode serves
    the keypoint-patch stem, masks >= 99.9 % equal to JAX's fused-stem run."""
    argv = ["-i", synth, "--dataset-mode", flag, "--size", str(SIZE), "--batch", "2",
            "--float32", "--checkpoint", DEMO]
    assert main(argv + ["-o", str(tmp_path / "port")], device="cpu") == 0
    out = capsys.readouterr().out
    assert jax_main(argv + ["-o", str(tmp_path / "jax")]) == 0
    jax_out = capsys.readouterr().out
    if flag == "--int8":
        assert "int8: calibrated 76 conv scales" in out
        assert "int8: calibrated 76 conv scales" in jax_out
    _same_masks(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_default_device_is_the_card(synth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-i", os.path.join(synth, "image"), "-o", str(tmp_path), "--size", "32"])
