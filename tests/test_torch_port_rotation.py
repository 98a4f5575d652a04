"""The port's rotated warp, its two-level kernels' plain version and the
preprocessing program against the JAX package (f32, CPU).

Inputs are numpy from a seed.  The rotated samplers get identical
``RotWarpParams`` values on both sides; ``preprocess_batch`` gets the draws
the JAX pipeline makes from its key (``_jax_draws`` repeats
``instancesegmentation_tpu/data/pipeline.py``'s ``jax.random`` calls).
"""
import dataclasses
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancesegmentation_tpu.data import pipeline as jpipe
from instancesegmentation_tpu.ops import warp as jw
from instancesegmentation_tpu_torch.data import pipeline as tpipe
from instancesegmentation_tpu_torch.data.synthetic import synthetic_host_batch
from instancesegmentation_tpu_torch.ops import warp as tw
from instancesegmentation_tpu_torch.ops import warp_2level as w2

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W, OUT = 96, 128, 64
#: the translation cut of the probe finding: t = (10, -12), src_lo = (0, 12),
#: src_hi = (86, 128) on a 96 x 128 canvas
CUT = dict(t=(10.0, -12.0), src_lo=(0.0, 12.0), src_hi=(86.0, 128.0))
NO_CUT = dict(t=(3.0, -2.0), src_lo=(0.0, 0.0), src_hi=(float(H), float(W)))


def _probe():
    spec = importlib.util.spec_from_file_location(
        "rot_pallas_probe", ROOT / "tools" / "rot_pallas_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _params(deg, cut, flip, b=2, out=OUT):
    """(JAX RotWarpParams of one sample, port RotWarpParams of ``b`` copies)
    with the same float32 values."""
    th = math.radians(deg)
    c = CUT if cut else NO_CUT
    f = dict(scale=(H / out, W / out), origin=(-4.0, -4.0),
             cos_sin=(math.cos(th), math.sin(th)), center=(H / 2 - 0.5, W / 2 - 0.5),
             t=c["t"], src_lo=c["src_lo"], src_hi=c["src_hi"], canvas_hw=(H, W))
    jp = jw.RotWarpParams(**{k: jnp.asarray(v, jnp.float32) for k, v in f.items()})
    if flip:
        jp = jw.flip_rot_params_x(jp, out)
    tp = tw.RotWarpParams(*(torch.from_numpy(np.stack([np.asarray(v)] * b)) for v in jp))
    return jp, tp


def _canvas(b, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)
    mask = (rng.random((b, H, W)) > 0.5).astype(np.uint8) * 255
    return img, mask


SAMPLERS = {
    "gather": (jw.warp_image_rotated, tw.warp_image_rotated, {}),
    "2pass": (jw.warp_image_rotated_2pass, tw.warp_image_rotated_2pass, {}),
    "2level": (jw.warp_image_rotated_2level, tw.warp_image_rotated_2level,
               dict(theta_max_deg=25.0)),
}


@pytest.mark.parametrize("cut", [False, True], ids=["no_cut", "cut"])
@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
@pytest.mark.parametrize("deg", [0.0, 13.0, -25.0])
@pytest.mark.parametrize("impl", list(SAMPLERS))
def test_rotated_samplers_match_jax(impl, deg, flip, cut):
    jf, tf, kw = SAMPLERS[impl]
    img, mask = _canvas(1)
    x = np.concatenate([img, mask[..., None]], -1).astype(np.float32)
    jp, tp = _params(deg, cut, flip, b=1)
    want = np.asarray(jf(jnp.asarray(x[0]), jp, (OUT, OUT), **kw))[None]
    got = tf(torch.from_numpy(x), tp, (OUT, OUT), **kw).numpy()
    assert got.shape == want.shape == (1, OUT, OUT, 4)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def _boxes(rng, b, h, w):
    """obj boxes, image sizes and masks; some boxes sit near the canvas edge,
    so the centring translation cuts content off."""
    x0 = rng.uniform(-10, w * 0.6, b)
    y0 = rng.uniform(-10, h * 0.6, b)
    bw, bh = rng.uniform(10, w * 0.5, b), rng.uniform(10, h * 0.5, b)
    obj = np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.float32)
    hw = np.stack([rng.integers(h // 2, h + 1, b), rng.integers(w // 2, w + 1, b)], 1)
    mask = (rng.random((b, h, w)) > 0.6).astype(np.uint8) * 255
    mask[0] = 0  # no mask pixel: the invalid box
    return obj, hw.astype(np.float32), mask


def test_rotated_box_params_and_points_match_jax():
    rng = np.random.default_rng(1)
    b = 6
    obj, hw, mask = _boxes(rng, b, H, W)
    theta = np.radians(rng.uniform(-25, 25, b)).astype(np.float32)
    theta[1] = 0.0
    jitter = rng.uniform(-0.1, 0.1, (b, 4)).astype(np.float32)
    t_obj, t_hw, t_th = (torch.from_numpy(a) for a in (obj, hw, theta))

    jt = jax.vmap(jw.center_translation)(obj, hw)
    tt = tw.center_translation(t_obj, t_hw)
    jbox, jvalid = jax.vmap(jw.rotated_mask_box)(mask, jt, theta, hw)
    box, valid = tw.rotated_mask_box(torch.from_numpy(mask), tt, t_th, t_hw)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert not valid[0] and valid[1:].all()
    np.testing.assert_allclose(box.numpy(), np.asarray(jbox), atol=1e-4, rtol=0)

    for jit_ in (None, jitter):
        jp = jax.vmap(lambda o, r, h, th, v, j=None: jw.rotated_instance_warp_params(
            o, r, h, th, (OUT, OUT), 16, v, j))(
                *((obj, jbox, hw, theta, jvalid) + (() if jit_ is None else (jit_,))))
        tp = tw.rotated_instance_warp_params(
            t_obj, box, t_hw, t_th, (OUT, OUT), 16, valid,
            None if jit_ is None else torch.from_numpy(jit_))
        for name, a, e in zip(jp._fields, tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-4, rtol=0,
                                       err_msg=name)
        pts = rng.uniform(0, W, (b, 17, 2)).astype(np.float32)
        want = jax.vmap(jw.warp_points_rotated)(pts, jp)
        got = tw.warp_points_rotated(torch.from_numpy(pts), tp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
        jf = jax.vmap(lambda p: jw.flip_rot_params_x(p, OUT))(jp)
        for a, e in zip(tw.flip_rot_params_x(tp, OUT), jf):
            np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=1e-4, rtol=0)


@pytest.mark.parametrize("cut", [False, True], ids=["no_cut", "cut"])
def test_2level_plain_version_against_the_probe_kernels(cut):
    """Without a translation cut the port's plain 2level version (which the
    kernels compute) agrees with both TPU probe kernels; with the cut it
    follows ``warp_image_rotated_2level`` (content cut first) and NOT the
    probe kernels, which mask the hat taps after the residual shift and so
    leak cut content near the cut edges.  One sample at 13 deg, one at
    -25 deg."""
    probe = _probe()
    img, mask = _canvas(2, seed=2)
    x = np.concatenate([img, mask[..., None]], -1).astype(np.float32)
    pairs = [_params(deg, cut, flip=False, b=1) for deg in (13.0, -25.0)]
    tp = tw.RotWarpParams(*(torch.cat(f) for f in zip(*(p[1] for p in pairs))))
    got = w2.warp_2level(torch.from_numpy(img), torch.from_numpy(mask), tp, (OUT, OUT),
                         25.0).numpy()
    xla = np.stack([np.asarray(jw.warp_image_rotated_2level(
        jnp.asarray(x[i]), pairs[i][0], (OUT, OUT), theta_max_deg=25.0)) for i in range(2)])
    np.testing.assert_allclose(got, xla, atol=1e-3, rtol=0)
    coefs = jnp.stack([probe._coeffs(p[0]) for p in pairs])
    cm = jnp.transpose(jnp.asarray(x), (0, 3, 1, 2))
    for kernel in (probe.warp_2level_pallas, probe.warp_2level_pallas_fused):
        pk = np.transpose(np.asarray(kernel(cm, coefs, (OUT, OUT), 25.0, interpret=True)),
                          (0, 2, 3, 1))
        for i in range(2):
            diff = np.abs(got[i] - pk[i])
            if cut:
                assert diff.max() > 100.0 and (diff > 1.0).sum() > 100, kernel.__name__
            else:
                assert diff.max() < 1e-2, kernel.__name__


@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
def test_2level_at_theta_zero_is_the_separable_sample(flip):
    img, mask = _canvas(2, seed=3)
    _, tp = _params(0.0, cut=True, flip=flip)
    got = w2.warp_2level(torch.from_numpy(img), torch.from_numpy(mask), tp, (OUT, OUT), 25.0)
    sep = tw.WarpParams(tp.scale, tp.origin - tp.t, tp.src_lo, tp.src_hi)
    x = torch.cat([torch.from_numpy(img).float(), torch.from_numpy(mask)[..., None].float()], -1)
    want = tw.warp_image(x, sep, (OUT, OUT))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3, rtol=0)


def test_2level_wrappers_run_the_plain_version_on_cpu_and_raise_out_of_contract():
    img, mask = _canvas(2, seed=4)
    ti, tm = torch.from_numpy(img), torch.from_numpy(mask)
    _, tp = _params(13.0, cut=True, flip=False)
    w2.warp_2level.launches = 0
    w2.warp_2level_fused.launches = 0
    ref = w2.warp_2level_reference(ti, tm, tp, (OUT, OUT), 25.0)
    for fn in (w2.warp_2level, w2.warp_2level_fused):
        np.testing.assert_array_equal(fn(ti, tm, tp, (OUT, OUT), 25.0).numpy(), ref.numpy())
        for bad in (0.0, 60.0, 90.0, -75.0):
            with pytest.raises(ValueError, match="DEGREES"):
                fn(ti, tm, tp, (OUT, OUT), bad)
        with pytest.raises(ValueError):
            fn(ti[0], tm[0], tp, (OUT, OUT), 25.0)            # rank
        with pytest.raises(ValueError):
            fn(torch.cat([ti, ti[..., :1]], -1), tm, tp, (OUT, OUT), 25.0)  # 4 channels
        with pytest.raises(TypeError):
            fn(ti.float(), tm, tp, (OUT, OUT), 25.0)          # dtype
        with pytest.raises(TypeError):
            fn(ti, tm.float(), tp, (OUT, OUT), 25.0)
    assert w2.warp_2level.launches == 0 and w2.warp_2level_fused.launches == 0


# -- preprocess_batch --------------------------------------------------------


def _jax_draws(rng, b, cfg):
    """The draws ``instancesegmentation_tpu/data/pipeline.py:preprocess_batch``
    makes from ``rng`` (its ``jax.random`` calls, in its order), as the port's
    draw dict."""
    r_jit, r_flip, r_bri, r_con, r_noise = jax.random.split(rng, 5)
    oh, ow = cfg.out_size

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    theta = jnp.zeros((b,), jnp.float32)
    if cfg.rotate > 0:
        gate = jax.random.bernoulli(jax.random.fold_in(rng, 101), cfg.rotate_prob, (b,))
        theta = jnp.where(gate, jax.random.uniform(
            jax.random.fold_in(rng, 102), (b,), minval=-1.0, maxval=1.0)
            * (cfg.rotate * math.pi / 180.0), 0.0)
    return {
        "theta": t(theta),
        "flip": t(jax.random.bernoulli(r_flip, cfg.flip_prob, (b,)) if cfg.flip_prob > 0
                  else jnp.zeros((b,), bool)),
        "jitter": t(jax.random.uniform(r_jit, (b, 4), minval=-cfg.jitter, maxval=cfg.jitter)
                    if cfg.jitter > 0 else None),
        "brightness": t(jax.random.uniform(r_bri, (b, 1, 1, 1), minval=1 - cfg.brightness,
                                           maxval=1 + cfg.brightness)[:, 0, 0, 0]
                        if cfg.brightness > 0 else None),
        "contrast": t(jax.random.uniform(r_con, (b, 1, 1, 1), minval=1 - cfg.contrast,
                                         maxval=1 + cfg.contrast)[:, 0, 0, 0]
                      if cfg.contrast > 0 else None),
        "noise": t(jax.random.normal(r_noise, (b, oh, ow, 3)) if cfg.noise_std > 0 else None),
    }


def _pipeline_batch(b=4, canvas=96, seed=5):
    """synthetic_host_batch with per-sample boxes moved about, so that the
    centring translation cuts content off some samples."""
    batch = synthetic_host_batch(b, canvas, seed=seed)
    rng = np.random.default_rng(seed)
    shift = rng.uniform(-canvas * 0.35, canvas * 0.35, (b, 2)).astype(np.float32)
    batch["obj_box"] = batch["obj_box"] + np.tile(shift, 2)
    batch["mask_box"] = batch["mask_box"] + np.tile(shift, 2)
    batch["image_hw"][1] = [canvas - 10, canvas - 20]
    return batch


BASE = dict(out_size=(64, 64), flip_prob=0.5, jitter=0.1, brightness=0.2, contrast=0.2,
            noise_std=5.0)
PIPELINE_CASES = {
    "separable": dict(BASE),
    "rot_2level": dict(BASE, rotate=25.0),
    "rot_2level_all_rotated_chunk1": dict(BASE, rotate=25.0, rotate_prob=1.0, rotate_chunk=1),
    "rot_2pass": dict(BASE, rotate=25.0, rotate_prob=1.0, rotate_impl="2pass"),
    "rot_gather": dict(BASE, rotate=25.0, rotate_prob=1.0, rotate_impl="gather"),
    "rot_2level_at_70_falls_back_to_gather": dict(BASE, rotate=70.0, rotate_prob=1.0),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_preprocess_batch_matches_jax(case):
    kw = PIPELINE_CASES[case]
    jcfg = jpipe.AugmentConfig(**kw)
    tcfg = tpipe.AugmentConfig(**kw)
    batch = _pipeline_batch()
    rng = jax.random.PRNGKey(7)
    draws = _jax_draws(rng, 4, jcfg)
    if jcfg.rotate > 0:
        assert (draws["theta"] != 0).any()
    assert draws["flip"].any() and not draws["flip"].all()
    # JAX stages through a compiled lax.map, whose fused XLA arithmetic differs
    # from its own eager path by up to 1.5e-5 in the masks; staging is
    # numerically neutral in both packages, so the staged case is held
    # against JAX's eager unstaged program, and against the port unstaged
    # bit for bit
    want = jpipe.preprocess_batch({k: jnp.asarray(v) for k, v in batch.items()}, rng,
                                  dataclasses.replace(jcfg, rotate_chunk=0))
    tpipe.warp_2level.launches = 0
    got = tpipe.preprocess_batch(tpipe.batch_to(batch, "cpu"), draws, tcfg)
    assert tpipe.warp_2level.launches == 0  # the plain version on a CPU tensor
    if tcfg.rotate_chunk:
        whole = tpipe.preprocess_batch(tpipe.batch_to(batch, "cpu"), draws,
                                       dataclasses.replace(tcfg, rotate_chunk=0))
        for g, u in zip(got, whole):
            assert torch.equal(g, u)
    for name, g, e, atol in zip(("images", "heatmaps", "masks"), got, want,
                                (1e-4, 1e-4, 1e-5)):
        assert g.dtype == torch.float32 and tuple(g.shape) == e.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=atol, rtol=0, err_msg=name)


def test_preprocess_batch_out_dtype():
    kw = dict(PIPELINE_CASES["rot_2level"])
    batch = tpipe.batch_to(_pipeline_batch(), "cpu")
    draws = _jax_draws(jax.random.PRNGKey(7), 4, jpipe.AugmentConfig(**kw))
    f32 = tpipe.preprocess_batch(batch, draws, tpipe.AugmentConfig(**kw))
    b16 = tpipe.preprocess_batch(batch, draws,
                                 tpipe.AugmentConfig(**kw, out_dtype=torch.bfloat16))
    for a, b in zip(f32[:2], b16[:2]):
        assert b.dtype == torch.bfloat16
        assert torch.equal(b, a.to(torch.bfloat16))
    assert b16[2].dtype == torch.float32 and torch.equal(b16[2], f32[2])


def test_host_batch_matches_jax():
    rng = np.random.default_rng(6)
    samples = [type("Sample", (), dict(
        image=rng.integers(0, 255, (8, 8, 3), dtype=np.uint8),
        mask=rng.integers(0, 2, (8, 8), dtype=np.uint8) * 255,
        image_hw=np.asarray([8.0, 8.0], np.float32), obj_box=rng.random(4).astype(np.float32),
        mask_box=rng.random(4).astype(np.float32), mask_valid=bool(i % 2),
        keypoints=rng.random((17, 3)).astype(np.float32)))() for i in range(3)]
    got, want = tpipe.host_batch(samples), jpipe.host_batch(samples)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_draw_augment_contract():
    cfg = tpipe.AugmentConfig(**PIPELINE_CASES["rot_2level"])
    d = tpipe.draw_augment(64, cfg, torch.Generator().manual_seed(0))
    assert d["theta"].abs().max() <= math.radians(25.0) + 1e-6
    assert 0 < (d["theta"] == 0).sum() < 64      # the rotate_prob gate
    assert 0 < d["flip"].sum() < 64
    assert d["jitter"].shape == (64, 4) and d["jitter"].abs().max() <= 0.1
    assert d["noise"].shape == (64, 64, 64, 3)
    assert ((d["brightness"] - 1).abs().max() <= 0.2 and (d["contrast"] - 1).abs().max() <= 0.2)
    none = tpipe.draw_augment(3, tpipe.AugmentConfig(out_size=(64, 64)))
    assert not none["theta"].any() and not none["flip"].any() and none["noise"] is None
    with pytest.raises(ValueError):
        tpipe.draw_augment(3, cfg)
    assert tpipe._FLIP_PERM == jpipe._FLIP_PERM
    assert dataclasses.asdict(tpipe.AugmentConfig()).keys() == \
        dataclasses.asdict(jpipe.AugmentConfig()).keys()
    assert tpipe.AugmentConfig().rotate_impl == "2level"


# -- the tiled warp kernel: its plan and its schedule, emulated ---------------

F32 = np.float32


def _hat(pos, tap):
    return np.maximum(F32(0), F32(1) - np.abs(pos - tap.astype(F32)))


def _residual(slope, idx, block, d):
    """csrc/warp_2level.cu:residual for indices ``idx``: (k0, w0, w1)."""
    r = (idx % block).astype(F32) - F32(0.5) * F32(block - 1)
    delta = np.minimum(np.maximum(F32(slope) * r, F32(-d)), F32(d))
    k0 = np.floor(delta).astype(np.int64)
    return k0, _hat(delta, k0), np.where(k0 + 1 <= d, _hat(delta, k0 + 1), F32(0))


def _centre(idx, block):
    return ((idx // block) * block).astype(F32) + F32(0.5) * F32(block - 1)


def _pass1(content, k, block, d1, ys, vs):
    """csrc/warp_2level.cu:pass1_value of canvas rows ``ys`` and output
    columns ``vs`` -> [len(ys), len(vs), 4], in float32 in its order."""
    h, w = content.shape[:2]
    ax, bx, cx, lox, hix, _, _, _, loy, hiy = k[:10]
    k0, w0, w1 = _residual(bx, ys, block, d1)
    vpos = (ax * vs.astype(F32))[None, :] + (bx * _centre(ys, block))[:, None]
    vpos = vpos + cx
    x0 = np.floor(vpos).astype(np.int64)
    hix = np.minimum(hix, F32(w))

    def pixel(x):
        ok = (x >= 0) & (x < w) & (x.astype(F32) >= lox) & (x.astype(F32) < hix)
        return np.where(ok[..., None], content[ys[:, None], np.clip(x, 0, w - 1)], F32(0))

    acc = np.zeros((len(ys), len(vs), 4), F32)
    for t in range(2):
        x = x0 + t
        hw = _hat(vpos, x)
        use = (x >= 0) & (x < w) & (hw != 0)
        lerp = (w0[:, None, None] * pixel(x + k0[:, None])
                + w1[:, None, None] * pixel(x + k0[:, None] + 1))
        acc = np.where(use[..., None], acc + hw[..., None] * lerp, acc)
    row_ok = (ys.astype(F32) >= loy) & (ys.astype(F32) < np.minimum(hiy, F32(h)))
    return np.where(row_ok[:, None, None], acc, F32(0))


def _upos(k, block, u, v):
    return (k[5] * F32(u)) + (k[6] * _centre(np.asarray(v), block)) + k[7]


def _pass2(rows, k, h, block, d2, us, vs):
    """csrc/warp_2level.cu:pass2_value of pixels ``us x vs``; ``rows(y,
    need)`` gives tmp rows y [U, C] where ``need``, as the kernel loads them."""
    a_y, b_y, a_x, b_x, ch, cw = k[10:16]
    pyu, pxv = a_y * us.astype(F32) + b_y, a_x * vs.astype(F32) + b_x
    cut = ((pyu >= 0) & (pyu < ch))[:, None] & ((pxv >= 0) & (pxv < cw))[None, :]
    k0, w0, w1 = _residual(k[6], vs, block, d2)
    upos = (k[5] * us.astype(F32))[:, None] + (k[6] * _centre(vs, block))[None, :]
    upos = upos + k[7]
    y0 = np.floor(upos).astype(np.int64)
    acc = np.zeros((len(us), len(vs), 4), F32)
    for t in range(2):
        y = y0 + t
        hw = _hat(upos, y)
        use = cut & (y >= 0) & (y < h) & (hw != 0)
        ya = y + k0[None, :]
        a = rows(ya, use & (ya >= 0) & (ya < h))
        c = rows(ya + 1, use & (ya + 1 >= 0) & (ya + 1 < h))
        acc = np.where(use[..., None],
                       acc + hw[..., None] * (w0[None, :, None] * a + w1[None, :, None] * c), acc)
    return acc


def _row_span(k, h, block, d2, ua, ub, va, vb):
    """csrc/warp_2level.cu:row_span: the rows [lo, hi] pass 2 of output rows
    [ua, ub) and columns [va, vb] reads, from upos at the corners."""
    p = np.array([_upos(k, block, u, v) for u in (ua, ub - 1) for v in (va, vb)], F32)
    lo = max(np.floor(p.min()) - F32(d2), F32(0))
    hi = min(np.floor(p.max()) + F32(2 + d2), F32(h - 1))
    return int(lo), int(hi)


def _emulate_tiled(img, mask, params, out_hw, theta_max_deg, block, plan):
    """Run csrc/warp_2level.cu:warp_2level_tiled_kernel CTA by CTA: the
    sub-tile height (halved until every sub-tile's span fits ``cap_rows``),
    pass 1 of each sub-tile's span into its tile buffer, pass 2 from it,
    asserting that every row pass 2 loads lies inside the span; a one-row
    sub-tile beyond the capacity takes tmp values straight from pass 1.
    Returns (out [B, oh, ow, 4], counts of split tiles and direct rows)."""
    b, h, w, _ = img.shape
    oh, ow = out_hw
    d1, d2 = tw.two_level_bands(theta_max_deg, block, (w + 2 * tw.SRC_PAD) / ow)
    coefs = w2.coefficients(params).numpy()
    content = np.concatenate([img, mask[..., None]], -1).astype(F32)
    out = np.zeros((b, oh, ow, 4), F32)
    stats = {"split_tiles": 0, "direct_rows": 0}
    gv, gu = plan.grid
    for s in range(b):
        k = coefs[s]
        for tu in range(gu):
            for tv in range(gv):
                v0, u0 = tv * w2.TILE_V, tu * plan.tile_u
                nv, u_end = min(w2.TILE_V, ow - v0), min(u0 + plan.tile_u, oh)
                vs = np.arange(v0, v0 + nv)

                def nrows(ua, ub):
                    lo, hi = _row_span(k, h, block, d2, ua, ub, v0, v0 + nv - 1)
                    return hi - lo + 1

                su = u_end - u0
                while su > 1 and any(nrows(ua, min(ua + su, u_end)) > plan.cap_rows
                                     for ua in range(u0, u_end, su)):
                    su = (su + 1) >> 1
                stats["split_tiles"] += su < u_end - u0
                for ua in range(u0, u_end, su):
                    ub = min(ua + su, u_end)
                    lo, hi = _row_span(k, h, block, d2, ua, ub, v0, v0 + nv - 1)
                    direct = hi - lo + 1 > plan.cap_rows
                    if direct:
                        assert ub == ua + 1
                        stats["direct_rows"] += 1
                        lo, hi = 0, h - 1
                    tile = _pass1(content[s], k, block, d1, np.arange(lo, hi + 1), vs)

                    def rows(y, need, lo=lo, hi=hi, tile=tile):
                        assert ((y[need] >= lo) & (y[need] <= hi)).all(), "a row off the span"
                        if not len(tile):
                            return np.zeros(y.shape + (4,), F32)
                        got = tile[np.clip(y - lo, 0, len(tile) - 1), np.arange(nv)[None, :]]
                        return np.where(need[..., None], got, F32(0))

                    out[s, ua:ub, v0:v0 + nv] = _pass2(rows, k, h, block, d2,
                                                       np.arange(ua, ub), vs)
    return out, stats


def test_tile_plan_at_the_training_config():
    """At 640 -> 480, rotate 25, block 16: one CTA's tmp rows fit well under
    the 227 KB of an SM (three CTAs per SM), the tiles cover the output
    exactly once, and the training path's own params need no sub-tile."""
    plan = w2.plan_tiles(25.0, 16, (640 + 2 * tw.SRC_PAD) / 480, (480, 480))
    assert plan.smem_bytes == plan.cap_rows * w2.ROW_BYTES
    assert plan.smem_bytes <= w2.PLAN_SMEM_BYTES < 227 * 1024 // 3
    cover = np.zeros((480, 480), int)
    gv, gu = plan.grid
    for tu in range(gu):
        for tv in range(gv):
            cover[tu * plan.tile_u:(tu + 1) * plan.tile_u, tv * w2.TILE_V:(tv + 1) * w2.TILE_V] += 1
    assert (cover == 1).all()
    assert gv * w2.TILE_V >= 480 > (gv - 1) * w2.TILE_V
    assert gu * plan.tile_u >= 480 > (gu - 1) * plan.tile_u
    # the spans of in-contract samples (rotate 25, jitter, flips) fit the plan
    cfg = tpipe.AugmentConfig(out_size=(480, 480), rotate=25.0, rotate_prob=1.0,
                              flip_prob=0.5, jitter=0.1)
    batch = synthetic_host_batch(8, 640, seed=9)
    draws = tpipe.draw_augment(8, cfg, torch.Generator().manual_seed(9))
    params, _ = tpipe.rotated_warp_params(tpipe.batch_to(batch, "cpu"), draws, cfg)
    coefs = w2.coefficients(params).numpy()
    _, d2 = tw.two_level_bands(25.0, 16, (640 + 2 * tw.SRC_PAD) / 480)
    worst = max(hi - lo + 1
                for k in coefs for tu in range(gu) for tv in range(gv)
                for lo, hi in [_row_span(k, 640, 16, d2, tu * plan.tile_u,
                                         min((tu + 1) * plan.tile_u, 480), tv * w2.TILE_V,
                                         min((tv + 1) * w2.TILE_V, 480) - 1)])
    assert worst <= plan.cap_rows


@pytest.mark.parametrize("cut", [False, True], ids=["no_cut", "cut"])
@pytest.mark.parametrize("flip", [False, True], ids=["unflipped", "flipped"])
@pytest.mark.parametrize("deg", [0.0, 13.0, -25.0])
def test_tiled_warp_schedule_matches_the_plain_version(deg, flip, cut):
    img, mask = _canvas(1, seed=11)
    _, tp = _params(deg, cut, flip, b=1)
    plan = w2.plan_tiles(25.0, 16, (W + 2 * tw.SRC_PAD) / OUT, (OUT, OUT))
    got, stats = _emulate_tiled(img, mask, tp, (OUT, OUT), 25.0, 16, plan)
    assert stats == {"split_tiles": 0, "direct_rows": 0}
    want = w2.warp_2level_reference(torch.from_numpy(img), torch.from_numpy(mask), tp,
                                    (OUT, OUT), 25.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("cap", ["split", "direct"])
def test_tiled_warp_schedule_splits_what_outgrows_the_plan(cap):
    """A capacity below the tile's span splits the tile along u; one below
    a single row's span sends that row to pass 1 directly.  Both stay equal
    to the plain version."""
    img, mask = _canvas(2, seed=12)
    pairs = [_params(deg, cut=True, flip=deg < 0, b=1) for deg in (13.0, -25.0)]
    tp = tw.RotWarpParams(*(torch.cat(f) for f in zip(*(p[1] for p in pairs))))
    plan = w2.plan_tiles(25.0, 16, (W + 2 * tw.SRC_PAD) / OUT, (OUT, OUT))
    small = plan.cap_rows // 3 if cap == "split" else 8
    plan = plan._replace(cap_rows=small, smem_bytes=small * w2.ROW_BYTES)
    got, stats = _emulate_tiled(img, mask, tp, (OUT, OUT), 25.0, 16, plan)
    assert stats["split_tiles"] > 0
    assert (stats["direct_rows"] > 0) == (cap == "direct")
    want = w2.warp_2level_reference(torch.from_numpy(img), torch.from_numpy(mask), tp,
                                    (OUT, OUT), 25.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _sample_coefs(table):
    """csrc/warp_2level.cu:sample_coefs in float32, one rounded operation at
    a time, over the params table [8, B, 2] -> [B, 16]."""
    scale, origin, cos_sin, center, t, src_lo, src_hi, canvas_hw = (table[i] for i in range(8))
    a_y, a_x, cth, sth = scale[:, 0], scale[:, 1], cos_sin[:, 0], cos_sin[:, 1]
    cy, cx = center[:, 0], center[:, 1]
    half = F32(0.5)
    b_y = ((half * a_y) - half) + origin[:, 0]
    b_x = ((half * a_x) - half) + origin[:, 1]
    m00, m01 = cth * a_y, (-sth) * a_x
    m10, m11 = sth * a_y, cth * a_x
    dy, dx = b_y - cy, b_x - cx
    ky0 = ((cy + cth * dy) - sth * dx) - t[:, 0]
    kx0 = ((cx + sth * dy) + cth * dx) - t[:, 1]

    def clamp_min0(x):
        return np.where(x < 0, F32(0), x)

    return np.stack([m11 - (m10 * m01) / m00, m10 / m00, kx0 - (m10 * ky0) / m00,
                     clamp_min0(src_lo[:, 1]), src_hi[:, 1], m00, m01, ky0,
                     clamp_min0(src_lo[:, 0]), src_hi[:, 0], a_y, b_y, a_x, b_x,
                     canvas_hw[:, 0], canvas_hw[:, 1]], 1)


def test_kernel_coefficients_equal_the_plain_version_bit_for_bit():
    """The kernels compute the per-sample terms from the params table the
    wrapper stacks; the transliteration of that device function equals
    ``coefficients`` (the plain version's ``_affine_terms``) bit for bit,
    flips, cuts and a -0.0 / NaN cut bound included."""
    pairs = [_params(deg, cut, flip, b=1) for deg in (0.0, 13.0, -25.0)
             for cut in (False, True) for flip in (False, True)]
    tp = tw.RotWarpParams(*(torch.cat(f) for f in zip(*(p[1] for p in pairs))))
    lo = tp.src_lo.clone()
    lo[1, 0], lo[2, 1], lo[3, 1] = -0.0, float("nan"), -3.5
    tp = tp._replace(src_lo=lo)
    table = torch.stack(tuple(tp)).float().numpy()
    got, want = _sample_coefs(table), w2.coefficients(tp).numpy()
    assert got.dtype == want.dtype == F32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
