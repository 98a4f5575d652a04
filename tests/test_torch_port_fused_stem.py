"""The port's fused stems and the engine's last serving options against the
JAX package (CPU, float32): ``models/fused_stem.py`` (the space-to-depth
stem), ``models/fused_stem_hm.py`` (the keypoint-patch stem),
``Segment(..., skip_stem=True)``, and ``InferenceEngine(fused_stem=True)``
and ``InferenceEngine(fold_bn=False)`` with and without ``quant``.  Mirrors
``tests/test_fused_stem.py`` and ``tests/test_fused_stem_hm.py``; both
packages get the same numpy inputs and the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.infer.pipeline import InferenceEngine as JaxEngine
from instancesegmentation_tpu.models import fused_stem as jfs
from instancesegmentation_tpu.models import fused_stem_hm as jhm
from instancesegmentation_tpu.models import quantize as jq
from instancesegmentation_tpu.models.segment import Segment as JaxSegment
from instancesegmentation_tpu.ops.heatmap import render_heatmaps as jax_render_heatmaps
from instancesegmentation_tpu_torch.data.synthetic import synthetic_host_batch
from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine
from instancesegmentation_tpu_torch.models import fused_stem as tfs
from instancesegmentation_tpu_torch.models import fused_stem_hm as thm
from instancesegmentation_tpu_torch.models import segment as tsegment
from instancesegmentation_tpu_torch.models.layers import init_weights_
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.ops.heatmap import render_heatmaps
from instancesegmentation_tpu_torch.utils.weights import (
    jax_quant_to_torch,
    jax_variables_to_torch,
    torch_to_jax_variables,
)

torch.set_num_threads(1)
SIZE = 64
CANVAS = 128
F32 = np.float32


def _variables(in_channels: int, seed: int) -> dict:
    """Segment variables in flax's layout (numpy): the port's seeded
    initialisation carried into the tree of ``jax.eval_shape(init)``, with
    random running statistics and PReLU slopes so that every fold matters."""
    args = [jnp.zeros((1, SIZE, SIZE, 3))]
    if in_channels > 3:
        args.append(jnp.zeros((1, SIZE, SIZE, in_channels - 3)))
    template = jax.eval_shape(lambda: JaxSegment(in_channels=in_channels).init(
        jax.random.PRNGKey(0), *args, train=False))
    port = Segment(in_channels)
    init_weights_(port, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)

    def f(path, v):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("mean"):
            return rng.normal(0, 0.3, v.shape).astype(F32)
        if name.endswith("var"):
            return rng.uniform(0.5, 2.0, v.shape).astype(F32)
        if name.endswith("alpha"):
            return rng.uniform(0.05, 0.45, v.shape).astype(F32)
        return np.asarray(v, F32)

    return jax.tree_util.tree_map_with_path(
        f, torch_to_jax_variables(port.state_dict(), template))


@pytest.fixture(scope="module")
def v20():
    return _variables(20, 0)


@pytest.fixture(scope="module")
def v3():
    return _variables(3, 1)


def _keypoints(rng, h, w, n=1, k=17):
    """[n, k, 2] keypoints and [n, k] visibility covering interior,
    border-clamped, off-image and invisible cases (JAX's fixture)."""
    pts = rng.uniform(-30, max(h, w) + 30, size=(n, k, 2)).astype(F32)
    pts[:, 0] = (2.0, 3.0)          # the window clamps at 0
    pts[:, 1] = (w - 2.0, h - 3.0)  # the window clamps at w-1 / h-1
    pts[:, 2] = (w / 2, h / 2)      # interior
    pts[:, 3] = (-40.0, 10.0)       # off the image: empty window
    vis = rng.uniform(size=(n, k)) > 0.3
    vis[:, 2] = True
    vis[:, 4] = False               # invisible with in-image coordinates
    return pts, vis


def _jax_patches(pts, vis, hw):
    return [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda p, v: jhm.render_heatmap_patches(p, v, hw)))(pts, vis)]


# -- models/fused_stem.py ---------------------------------------------------------------

def test_space_to_depth_layout():
    """The block channel is ``(ry*2 + rx)*C + c``, exactly JAX's layout."""
    x = np.arange(2 * 4 * 6 * 3, dtype=F32).reshape(2, 4, 6, 3)
    y = tfs.space_to_depth(torch.from_numpy(x)).numpy()
    assert y.shape == (2, 2, 3, 12)
    np.testing.assert_array_equal(y, np.asarray(jfs.space_to_depth(jnp.asarray(x))))
    assert y[0, 1, 2, 3 * 3 + 1] == x[0, 3, 5, 1]
    assert y[1, 0, 1, 0 * 3 + 2] == x[1, 0, 2, 2]


def _stem_inputs(c, h=64, w=96, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (2, h, w, c)).astype(F32)


@pytest.mark.parametrize("c", [3, 20])
def test_stem_apply_matches_jax_and_init_head(c, v3, v20):
    """``stem_apply`` on the port's state dict equals JAX's on the flax
    variables and the port's own ``InitHeadS4`` within 1e-5; the s2d kernels
    hold JAX's values in torch's layout."""
    variables = v3 if c == 3 else v20
    sd = jax_variables_to_torch(variables)
    x = _stem_inputs(c)
    stem = tfs.fold_stem(sd)
    jstem = jfs.fold_stem(variables)
    assert stem.in_channels == jstem.in_channels == c
    np.testing.assert_allclose(stem.k1.permute(2, 3, 1, 0).numpy(), np.asarray(jstem.k1),
                               rtol=1e-6, atol=1e-7)
    got = tfs.stem_apply(torch.from_numpy(x), stem).numpy()
    want = np.asarray(jfs.stem_apply(jnp.asarray(x), jstem, dtype=jnp.float32))
    assert got.shape == want.shape == (2, 16, 24, c + 16)
    np.testing.assert_allclose(got, want, atol=1e-5)
    model = Segment(c).eval()
    model.load_state_dict(sd)
    with torch.inference_mode():
        own = model.init_conv(tfs.nchw(torch.from_numpy(x))).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, own, atol=1e-5)


def test_stem_fold_edge_padding_exact(v3):
    """Edge blocks see the zero padding of the p=2 conv: impulses in the
    corners."""
    sd = jax_variables_to_torch(v3)
    x = np.zeros((2, 16, 16, 3), F32)
    x[:, 0, 0] = 5.0
    x[:, -1, -1] = -3.0
    got = tfs.stem_apply(torch.from_numpy(x), tfs.fold_stem(sd)).numpy()
    model = Segment(3).eval()
    model.load_state_dict(sd)
    with torch.inference_mode():
        own = model.init_conv(tfs.nchw(torch.from_numpy(x))).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, own, atol=1e-5)
    want = np.asarray(jfs.stem_apply(jnp.asarray(x), jfs.fold_stem(v3), dtype=jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- models/fused_stem_hm.py: patches and placement -------------------------------------

@pytest.mark.parametrize("hw", [(96, 96), (64, 128), (48, 48)])
def test_patches_equal_the_dense_render(hw):
    """The patches, placed into a zero stack, equal the port's dense render
    bit for bit, and JAX's patches and dense render within the port's
    heatmap tolerance (1e-6); the origins equal JAX's."""
    rng = np.random.default_rng(0)
    pts, vis = _keypoints(rng, *hw, n=3)
    patches, x0, y0 = thm.render_heatmap_patches(torch.from_numpy(pts),
                                                 torch.from_numpy(vis), hw)
    p = min(thm.PATCH, *hw)
    assert patches.shape == (3, p, p, 17) and patches.dtype == torch.float32
    dense = render_heatmaps(torch.from_numpy(pts), torch.from_numpy(vis), hw).numpy()
    rebuilt = np.zeros_like(dense)
    for n in range(3):
        for k in range(17):
            ox, oy = int(x0[n, k]), int(y0[n, k])
            assert ox % 4 == 0 or ox == hw[1] - p
            rebuilt[n, oy:oy + p, ox:ox + p, k] = patches[n, :, :, k].numpy()
    np.testing.assert_array_equal(rebuilt, dense)
    jp, jx0, jy0 = _jax_patches(pts, vis, hw)
    np.testing.assert_array_equal(x0.numpy(), jx0)
    np.testing.assert_array_equal(y0.numpy(), jy0)
    np.testing.assert_allclose(patches.numpy(), jp, atol=1e-6)
    jdense = np.asarray(jax.vmap(lambda a, b: jax_render_heatmaps(a, b, hw))(pts, vis))
    np.testing.assert_allclose(rebuilt, jdense, atol=1e-6)


def test_patches_of_non_finite_points_follow_the_dense_render():
    """A visible keypoint at a non-finite coordinate renders nothing, as in
    the dense render; its origin is that of the point (0, 0), as in JAX."""
    pts = np.full((1, 17, 2), 30.0, F32)
    pts[0, 5] = (np.nan, 10.0)
    pts[0, 6] = (np.inf, -np.inf)
    vis = np.ones((1, 17), bool)
    patches, x0, y0 = thm.render_heatmap_patches(torch.from_numpy(pts),
                                                 torch.from_numpy(vis), (64, 64))
    assert not patches[0, :, :, 5:7].any()
    assert x0[0, 5] == y0[0, 6] == 0
    dense = render_heatmaps(torch.from_numpy(pts), torch.from_numpy(vis), (64, 64))
    assert not dense[0, :, :, 5:7].any()
    with pytest.raises(ValueError, match="multiple of 4"):
        thm.render_heatmap_patches(torch.from_numpy(pts), torch.from_numpy(vis), (42, 64))


def test_placement_matches_jax_mm_and_dus():
    """The keypoint-at-a-time placement equals JAX's one-hot ("mm") and
    dynamic-update-slice ("dus") placements within 1e-4; the pooled planes
    equal both."""
    rng = np.random.default_rng(0)
    out, b, k, p = 96, 3, 17, 48
    op = p // 2 + 2
    deltas = rng.normal(size=(b, k, op, op, 16)).astype(F32)
    patches = rng.uniform(0, 1, size=(b, p, p, k)).astype(F32)
    offs = (rng.integers(0, (out - p) // 4 + 1, size=(b, k, 2)) * 4).astype(np.int32)
    got = thm._accumulate_conv_patches(torch.from_numpy(deltas), torch.from_numpy(offs[..., 0]),
                                       torch.from_numpy(offs[..., 1]), (out, out)).numpy()
    planes = thm._pooled_hm_planes(torch.from_numpy(patches), torch.from_numpy(offs[..., 0]),
                                   torch.from_numpy(offs[..., 1]), (out, out)).numpy()
    assert got.shape == (b, out // 2, out // 2, 16) and planes.shape == (b, out // 4, out // 4, k)
    jargs = (jnp.asarray(offs[..., 0]), jnp.asarray(offs[..., 1]), (out, out), jnp.float32)
    for impl in ("mm", "dus"):
        want = jhm._accumulate_conv_patches(jnp.asarray(deltas), *jargs, impl=impl)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
        np.testing.assert_array_equal(
            planes, np.asarray(jhm._pooled_hm_planes(jnp.asarray(patches), *jargs, impl=impl)))


# -- stem_hm_apply and the skip-stem forward ---------------------------------------------

def _conditioned_inputs(h=96, w=96, n=3, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, size=(n, h, w, 3)).astype(F32)
    pts, vis = _keypoints(rng, h, w, n=n)
    return images, pts, vis


@pytest.fixture(scope="module")
def stem_hm_case(v20):
    images, pts, vis = _conditioned_inputs()
    sd = jax_variables_to_torch(v20)
    got = thm.stem_hm_apply(torch.from_numpy(images), torch.from_numpy(pts),
                            torch.from_numpy(vis), thm.fold_stem_hm(sd), dtype=torch.float32)
    return v20, sd, images, pts, vis, got.numpy()


@pytest.mark.parametrize("conv_impl", ["gconv", "dot"])
def test_stem_hm_apply_matches_jax(conv_impl, stem_hm_case):
    """Against JAX's folded stem under both of its conv lowerings: conv
    channels within 2e-5, the pooled RGB channels equal, the pooled heatmap
    channels within the port's heatmap tolerance of JAX's render (1e-6:
    torch's and XLA's ``exp`` differ by an ulp on a few values; the next
    test holds them bit-equal to the port's own dense render)."""
    v20, _, images, pts, vis, got = stem_hm_case
    stem = jhm.fold_stem_hm(v20)
    want = np.asarray(jax.jit(lambda a, b, c: jhm.stem_hm_apply(
        a, b, c, stem, dtype=jnp.float32, conv_impl=conv_impl))(images, pts, vis))
    assert got.shape == want.shape == (3, 24, 24, 36)
    np.testing.assert_array_equal(got[..., :3], want[..., :3])
    np.testing.assert_allclose(got[..., 3:20], want[..., 3:20], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., 20:], want[..., 20:], atol=2e-5)


def test_stem_hm_apply_matches_the_dense_stem(stem_hm_case):
    """Against the port's own ``InitHeadS4`` on the dense stack: pooled
    channels bit-equal (the patches are the dense render), conv channels
    within 2e-5."""
    _, sd, images, pts, vis, got = stem_hm_case
    model = Segment(20).eval()
    model.load_state_dict(sd)
    hm = render_heatmaps(torch.from_numpy(pts), torch.from_numpy(vis), images.shape[1:3])
    with torch.inference_mode():
        x = tfs.nchw(torch.cat([torch.from_numpy(images), hm], dim=-1))
        ref = model.init_conv(x).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got[..., :20], ref[..., :20])
    np.testing.assert_allclose(got[..., 20:], ref[..., 20:], atol=2e-5)


@pytest.mark.parametrize("in_channels", [3, 20])
def test_skip_stem_forward_matches_jax(in_channels, v3, v20):
    """``Segment(..., skip_stem=True)`` fed ``stem_apply``'s output against
    JAX's unfused forward: rtol 1e-4, atol 1e-3 (JAX's bound: stem rounding
    grows through ~60 layers with logits of tens)."""
    variables = v3 if in_channels == 3 else v20
    rng = np.random.default_rng(1)
    imgs = rng.normal(0, 1, (2, 64, 64, 3)).astype(F32)
    hm = rng.uniform(0, 1, (2, 64, 64, 17)).astype(F32) if in_channels > 3 else None
    want = np.asarray(JaxSegment(in_channels=in_channels).apply(
        variables, imgs, hm, train=False))
    sd = jax_variables_to_torch(variables)
    model = Segment(in_channels).eval()
    model.load_state_dict(sd)
    x = imgs if hm is None else np.concatenate([imgs, hm], -1)
    with torch.inference_mode():
        feats = tfs.stem_apply(torch.from_numpy(x), tfs.fold_stem(sd))
        got = model(feats, skip_stem=True).numpy()
        dense = model(torch.from_numpy(imgs), None if hm is None else torch.from_numpy(hm))
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, dense.numpy(), rtol=1e-4, atol=1e-3)


def test_skip_stem_guards():
    """Where JAX asserts, the port raises ``ValueError``: heatmaps given, or
    features of the wrong width."""
    model = Segment(3).eval()
    with torch.inference_mode():
        with pytest.raises(ValueError, match="channels"):
            model(torch.zeros((1, 8, 8, 7)), skip_stem=True)
        with pytest.raises(ValueError, match="heatmaps"):
            model(torch.zeros((1, 8, 8, 19)), torch.zeros((1, 32, 32, 17)), skip_stem=True)
        assert model(torch.zeros((1, 8, 8, 19)), skip_stem=True).shape == (1, 32, 32, 1)


# -- the engine ------------------------------------------------------------------------------

def _count_chains(monkeypatch):
    calls = []
    chain = tsegment._chain
    monkeypatch.setattr(tsegment, "_chain", lambda y, spec: calls.append(spec) or chain(y, spec))
    return calls


@pytest.fixture(scope="module")
def batch():
    return synthetic_host_batch(3, CANVAS, seed=3)


def test_engine_fused_stem_matches_jax(v20, batch, monkeypatch):
    """``InferenceEngine(fused_stem=True)`` against JAX's: probabilities
    within 2e-4, masks >= 99.9 % equal; against the port's dense engine
    within the same bounds; the chains still run (2 per dispatch)."""
    calls = _count_chains(monkeypatch)
    port = InferenceEngine(v20, in_channels=20, size=SIZE, dtype=torch.float32,
                           fused_stem=True, device="cpu")
    assert port._fused_stem
    probs, masks = port.predict_instances(batch)
    assert len(calls) == 2
    jprobs, jmasks = JaxEngine(v20, in_channels=20, size=SIZE, dtype=jnp.float32,
                               fused_stem=True).predict_instances(batch)
    np.testing.assert_allclose(probs, jprobs, atol=2e-4)
    assert (masks == jmasks).mean() >= 0.999
    dprobs, dmasks = InferenceEngine(v20, in_channels=20, size=SIZE, dtype=torch.float32,
                                     device="cpu").predict_instances(batch)
    np.testing.assert_allclose(probs, dprobs, atol=2e-4)
    assert (masks == dmasks).mean() >= 0.999


def test_engine_fused_stem_skips_the_dense_render(v20, batch, monkeypatch):
    """With the fused stem the instance program renders no dense heatmap
    stack and runs no ``init_conv``."""
    from instancesegmentation_tpu_torch.infer import pipeline

    rendered = []
    monkeypatch.setattr(pipeline, "render_heatmaps",
                        lambda *a, **k: rendered.append(1) or render_heatmaps(*a, **k))
    port = InferenceEngine(v20, in_channels=20, size=SIZE, dtype=torch.float32,
                           fused_stem=True, device="cpu")
    stems = []
    port.model.init_conv.register_forward_hook(lambda *a: stems.append(1))
    port.predict_instances(batch)
    assert not rendered and not stems


def test_fused_stem_three_channel_gate(v3, batch):
    """As in the JAX engine, ``fused_stem`` applies to 20-channel models
    only: a 3-channel engine serves the dense path, the same bits as without
    the option."""
    gated = InferenceEngine(v3, in_channels=3, size=SIZE, dtype=torch.float32,
                            fused_stem=True, device="cpu")
    plain = InferenceEngine(v3, in_channels=3, size=SIZE, dtype=torch.float32, device="cpu")
    assert not gated._fused_stem
    for a, b in zip(gated.predict_instances(batch), plain.predict_instances(batch)):
        np.testing.assert_array_equal(a, b)
    images = [np.random.default_rng(2).integers(0, 255, (50, 70, 3), dtype=np.uint8)]
    np.testing.assert_array_equal(gated.predict_images(images)[0], plain.predict_images(images)[0])


def test_fused_stem_engine_whole_image_is_dense(v20):
    """The whole-image program of a 20-channel fused-stem engine is the
    dense one (zero heatmaps), bit for bit."""
    images = [np.random.default_rng(4).integers(0, 255, (70, 50, 3), dtype=np.uint8)]
    a = InferenceEngine(v20, in_channels=20, size=SIZE, dtype=torch.float32, fused_stem=True,
                        device="cpu").predict_images(images)
    b = InferenceEngine(v20, in_channels=20, size=SIZE, dtype=torch.float32,
                        device="cpu").predict_images(images)
    np.testing.assert_array_equal(a[0], b[0])


@pytest.fixture(scope="module")
def quant20(v20):
    """JAX's calibration of ``v20`` on random model inputs."""
    rng = np.random.default_rng(7)
    x = (rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(F32),
         rng.uniform(0, 1, (2, SIZE, SIZE, 17)).astype(F32))
    model = JaxSegment(in_channels=20, dtype=jnp.float32, quant_mode="calibrate")
    return jax.tree_util.tree_map(np.asarray, jq.calibrate(model, v20, [x]))


@pytest.mark.parametrize("quant", [False, True])
def test_fold_bn_false_matches_jax(quant, v20, quant20, batch, monkeypatch):
    """``fold_bn=False`` serves the unfolded state dict through the layer
    modules (no chain), each BN after its conv, as JAX's ``fold_bn=False``
    engine: probabilities within 2e-4 and masks >= 99.9 % equal to it, and
    to the port's folded engine; with ``quant`` ("int8_mxu") the covered
    convs are quantised from the unfolded weights, masks >= 99.9 % equal to
    JAX's unfolded int8 engine."""
    calls = _count_chains(monkeypatch)
    kw = {"quant": quant20} if quant else {}
    port = InferenceEngine(v20, in_channels=20, size=SIZE, dtype=torch.float32, fold_bn=False,
                           device="cpu", **kw)
    sd = jax_variables_to_torch(v20)
    for k, t in port.variables.items():
        assert torch.equal(t, sd[k]), k
    assert port.model.chains is None
    probs, masks = port.predict_instances(batch)
    assert not calls
    jprobs, jmasks = JaxEngine(v20, in_channels=20, size=SIZE, dtype=jnp.float32, fold_bn=False,
                               **kw).predict_instances(batch)
    assert (masks == jmasks).mean() >= 0.999
    if not quant:
        np.testing.assert_allclose(probs, jprobs, atol=2e-4)
        fprobs, fmasks = InferenceEngine(v20, in_channels=20, size=SIZE, dtype=torch.float32,
                                         device="cpu").predict_instances(batch)
        np.testing.assert_allclose(probs, fprobs, atol=2e-4)
        assert (masks == fmasks).mean() >= 0.999
        return
    convs = port.model.quant_convs()
    w = convs["bottle1_1.convs.0.conv"]
    np.testing.assert_array_equal(w.quant.qconv.wq.numpy(),
                                  _quantised_unfolded(sd["bottle1_1.convs.0.conv.weight"]))


def _quantised_unfolded(weight):
    from instancesegmentation_tpu_torch.ops.int8_conv import quantize_weight

    return quantize_weight(weight)[0].numpy()


def test_fold_bn_false_with_fused_stem_and_quant(v20, quant20, batch):
    """The options compose: ``fold_bn=False`` with the fused stem and int8
    against the JAX engine with the same three options, masks >= 99.9 %."""
    port = InferenceEngine(v20, in_channels=20, size=SIZE, dtype=torch.float32, fold_bn=False,
                           fused_stem=True, quant=jax_quant_to_torch(quant20), device="cpu")
    _, masks = port.predict_instances(batch)
    _, jmasks = JaxEngine(v20, in_channels=20, size=SIZE, dtype=jnp.float32, fold_bn=False,
                          fused_stem=True, quant=quant20).predict_instances(batch)
    assert (masks == jmasks).mean() >= 0.999
