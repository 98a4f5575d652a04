"""The port's warp, heatmap render, resize and device rule against the JAX
package and cv2 (f32, CPU)."""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.ops import heatmap as jheat
from instancesegmentation_tpu.ops import warp as jwarp
from instancesegmentation_tpu_torch.core.device import pick_device
from instancesegmentation_tpu_torch.infer.pipeline import resize, to_u8
from instancesegmentation_tpu_torch.ops import heatmap as theat
from instancesegmentation_tpu_torch.ops import warp as twarp

torch.set_num_threads(1)


def _boxes(rng, b, canvas):
    """Random obj/mask boxes, sizes and masks, some pushed off-canvas by
    the centring translation."""
    x0 = rng.uniform(-20, canvas * 0.6, (b, 2))
    wh = rng.uniform(8, canvas * 0.7, (b, 2))
    obj = np.concatenate([x0, x0 + wh], 1).astype(np.float32)
    mask_box = (obj + rng.uniform(-6, 6, (b, 4))).astype(np.float32)
    hw = np.stack([rng.integers(canvas // 2, canvas + 1, b),
                   rng.integers(canvas // 2, canvas + 1, b)], 1).astype(np.float32)
    mask = (rng.random((b, canvas, canvas)) > 0.6).astype(np.uint8) * 255
    mask[0] = 0  # no mask pixel: exercises the invalid box
    valid = rng.random(b) > 0.3
    return obj, mask_box, hw, mask, valid


def test_warp_params_and_mask_box_match_jax():
    rng = np.random.default_rng(0)
    obj, mask_box, hw, mask, valid = _boxes(rng, 6, 96)
    t_t = twarp.center_translation(torch.from_numpy(obj), torch.from_numpy(hw))
    j_t = jax.vmap(jwarp.center_translation)(obj, hw)
    for a, b in zip(t_t, j_t):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    box, ok = twarp.clipped_mask_box(torch.from_numpy(mask), t_t, torch.from_numpy(hw))
    jbox, jok = jax.vmap(jwarp.clipped_mask_box)(mask, j_t, hw)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(box.numpy(), np.asarray(jbox), atol=1e-5)

    p = twarp.instance_warp_params(torch.from_numpy(obj), torch.from_numpy(mask_box),
                                   torch.from_numpy(hw), (48, 40), 16,
                                   torch.from_numpy(valid))
    jp = jax.vmap(lambda o, m, h, v: jwarp.instance_warp_params(o, m, h, (48, 40), 16, v))(
        obj, mask_box, hw, valid)
    for a, b in zip(p, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_bounds", [False, True])
def test_warp_image_and_points_match_jax(with_bounds):
    rng = np.random.default_rng(1)
    obj, mask_box, hw, _, valid = _boxes(rng, 3, 80)
    p = twarp.instance_warp_params(torch.from_numpy(obj), torch.from_numpy(mask_box),
                                   torch.from_numpy(hw), (32, 48), 16,
                                   torch.from_numpy(valid))
    if not with_bounds:
        p = twarp.WarpParams(p.scale, p.offset)
    img = rng.integers(0, 255, (3, 80, 80, 3)).astype(np.float32)
    got = twarp.warp_image(torch.from_numpy(img), p, (32, 48)).numpy()
    jp = jwarp.WarpParams(*(None if a is None else jnp.asarray(a.numpy()) for a in p))
    want = np.stack([
        np.asarray(jwarp.warp_image(jnp.asarray(img[i]), jwarp.WarpParams(
            *(None if a is None else a[i] for a in jp)), (32, 48)))
        for i in range(3)])
    assert got.shape == want.shape == (3, 32, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    pts = rng.uniform(0, 80, (3, 17, 2)).astype(np.float32)
    tp = twarp.warp_points(torch.from_numpy(pts), p).numpy()
    jpts = jax.vmap(lambda q, s, o: jwarp.warp_points(q, jwarp.WarpParams(s, o)))(
        pts, jp.scale, jp.offset)
    np.testing.assert_allclose(tp, np.asarray(jpts), rtol=1e-5, atol=1e-5)


def test_render_heatmaps_matches_jax_and_numpy():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-15, 75, (3, 17, 2)).astype(np.float32)
    vis = rng.random((3, 17)) > 0.3
    got = theat.render_heatmaps(torch.from_numpy(pts), torch.from_numpy(vis), (64, 56)).numpy()
    want = np.asarray(jax.vmap(lambda p, v: jheat.render_heatmaps(p, v, (64, 56)))(pts, vis))
    assert got.shape == want.shape == (3, 64, 56, 17)
    np.testing.assert_allclose(got, want, atol=1e-6)
    for i in range(3):
        golden = jheat.render_heatmaps_numpy(pts[i], vis[i], (64, 56))
        np.testing.assert_allclose(got[i], golden, atol=1e-6)


def test_resize_stands_in_for_cv2():
    rng = np.random.default_rng(3)
    mask = (rng.random((37, 53)) > 0.5).astype(np.uint8) * 255
    for w, h in [(80, 61), (20, 15), (106, 74)]:
        want = cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST)
        got = resize(torch.from_numpy(mask), (h, w), "nearest").to(torch.uint8).numpy()
        np.testing.assert_array_equal(got, want)
    probs = rng.random((64, 64)).astype(np.float32)
    want = cv2.resize(probs, (70, 50), interpolation=cv2.INTER_LINEAR)
    got = resize(torch.from_numpy(probs), (50, 70)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # uint8: cv2's own fixed-point arithmetic, so equal
    img = rng.integers(0, 255, (50, 70, 3), dtype=np.uint8)
    want = cv2.resize(img, (64, 64), interpolation=cv2.INTER_LINEAR)
    got = to_u8(resize(torch.from_numpy(img), (64, 64))).numpy()
    np.testing.assert_array_equal(got, want)


# (in h, w) -> (out h, w): up, down, mixed, exact 2x down (cv2's INTER_AREA),
# 2x in one axis only, and 1-3 px edges on either side
_RESIZE_SWEEP = [
    ((37, 53), (80, 106)), ((120, 97), (41, 33)), ((30, 40), (31, 43)), ((40, 30), (120, 29)),
    ((64, 48), (32, 24)), ((64, 48), (32, 48)), ((1, 1), (5, 7)), ((1, 5), (2, 10)),
    ((3, 2), (7, 1)), ((2, 3), (1, 1)), ((5, 5), (3, 2)), ((720, 960), (480, 640)),
]


@pytest.mark.parametrize("channels", [1, 3])
def test_resize_uint8_bilinear_is_cv2_bit_for_bit(channels):
    """The uint8 INTER_LINEAR resize equals ``cv2.resize`` exactly over the
    sweep and over random sizes of 1-40 px to 1-60 px."""
    rng = np.random.default_rng(channels)
    cases = _RESIZE_SWEEP + [(tuple(rng.integers(1, 41, 2)), tuple(rng.integers(1, 61, 2)))
                             for _ in range(60)]
    for (h, w), (oh, ow) in cases:
        shape = (int(h), int(w)) + ((channels,) if channels > 1 else ())
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, (int(ow), int(oh)), interpolation=cv2.INTER_LINEAR)
        got = resize(torch.from_numpy(img), (int(oh), int(ow)))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(to_u8(got).numpy(), want, err_msg=f"{shape} -> {oh, ow}")


def test_device_rule():
    assert pick_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pick_device()
