"""The port's int8 post-training quantisation against the JAX package's
(CPU, float32): ``models/quantize.py`` (calibration), ``ops/int8_conv.py``
(the s8 x s8 -> s32 conv and its epilogue), ``Segment.set_quant`` and the
engine's ``quant``.  Mirrors ``tests/test_quantize.py`` and holds each part
to JAX's: the int8 weights and scales bit for bit, the int32 accumulators of
every conv kind bit for bit, the outputs within one ulp of the epilogue's
product plus one of the output (XLA on the CPU contracts the multiply-add
into an FMA),
the calibrated abs-max within 1e-5 relative, and the whole model in both int8
modes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from instancesegmentation_tpu.infer.pipeline import InferenceEngine as JaxEngine
from instancesegmentation_tpu.models.export import fold_batchnorm as jax_fold_batchnorm
from instancesegmentation_tpu.models.fused_head import fold_head as jax_fold_head
from instancesegmentation_tpu.models.fused_head import head_apply as jax_head_apply
from instancesegmentation_tpu.models.layers import _Int8Conv
from instancesegmentation_tpu.models import quantize as jq
from instancesegmentation_tpu.models.segment import Segment as JaxSegment
from instancesegmentation_tpu_torch.data.synthetic import make_synthetic_dataset
from instancesegmentation_tpu_torch.infer.pipeline import InferenceEngine, resize, to_u8
from instancesegmentation_tpu_torch.models import quantize as tq
from instancesegmentation_tpu_torch.models import segment as tsegment
from instancesegmentation_tpu_torch.models.export import fold_batchnorm
from instancesegmentation_tpu_torch.models.layers import init_weights_, int8_selected
from instancesegmentation_tpu_torch.models.segment import Segment
from instancesegmentation_tpu_torch.ops.fused_chain import extract_s1_chain, extract_s23_chain
from instancesegmentation_tpu_torch.ops.int8_conv import (
    Int8Conv,
    epilogue_scale,
    int8_conv,
    quantize_input_reference,
    quantize_weight,
)
from instancesegmentation_tpu_torch.utils.weights import (
    flax_to_torch_key,
    jax_quant_to_torch,
    jax_variables_to_torch,
    torch_quant_to_jax,
    torch_to_jax_variables,
)

torch.set_num_threads(1)
SIZE = 64
F32 = np.float32


def _randomize(variables, rng):
    """Random running statistics and PReLU slopes, so that folding matters."""
    def f(path, v):
        name = "/".join(str(p.key) for p in path)
        if name.endswith("mean"):
            return rng.normal(0, 0.3, v.shape).astype(F32)
        if name.endswith("var"):
            return rng.uniform(0.5, 2.0, v.shape).astype(F32)
        if name.endswith("alpha"):
            return rng.uniform(0.05, 0.45, v.shape).astype(F32)
        return np.asarray(v, F32)

    return jax.tree_util.tree_map_with_path(f, dict(variables))


def _variables(in_channels: int, seed: int) -> dict:
    """Segment variables in flax's layout (numpy): the port's seeded
    initialisation carried into the tree of ``jax.eval_shape(init)`` (no
    compile of flax's init), with random statistics and slopes."""
    args = [jnp.zeros((1, SIZE, SIZE, 3))]
    if in_channels > 3:
        args.append(jnp.zeros((1, SIZE, SIZE, in_channels - 3)))
    template = jax.eval_shape(lambda: JaxSegment(in_channels=in_channels).init(
        jax.random.PRNGKey(0), *args, train=False))
    port = Segment(in_channels)
    init_weights_(port, torch.Generator().manual_seed(seed))
    return _randomize(torch_to_jax_variables(port.state_dict(), template),
                      np.random.default_rng(seed))


def _inputs(in_channels: int, seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(F32)
    hm = (rng.uniform(0, 1, (n, SIZE, SIZE, in_channels - 3)).astype(F32)
          if in_channels > 3 else None)
    return images, hm


def _port_model(variables, in_channels: int = 20) -> Segment:
    model = Segment(in_channels).eval()
    model.load_state_dict(jax_variables_to_torch(variables))
    return model


def _run(model, images, hm):
    with torch.inference_mode():
        return model(torch.from_numpy(images),
                     None if hm is None else torch.from_numpy(hm)).numpy()


@pytest.fixture(scope="module")
def v20():
    return _variables(20, 0)


@pytest.fixture(scope="module")
def x20():
    return _inputs(20, 0)


@pytest.fixture(scope="module")
def jax_cal20(v20, x20):
    """JAX's calibration of ``v20`` on ``x20``: compiled once for the module."""
    model = JaxSegment(in_channels=20, dtype=jnp.float32, quant_mode="calibrate")
    return jax.tree_util.tree_map(np.asarray, jq.calibrate(model, v20, [x20]))


def _jax_int8(mode, variables, quant, images, hm):
    """JAX's int8 program (``apply`` compiled with the variables as arguments)
    -> (logits, {port conv path: the conv's input}), the inputs caught by
    intercepting every ``_Int8Conv``."""
    model = JaxSegment(in_channels=20 if hm is not None else 3, dtype=jnp.float32,
                       quant_mode=mode)

    def f(v, a, b):
        caught = {}

        def catch(next_fun, args, kwargs, ctx):
            if isinstance(ctx.module, _Int8Conv) and ctx.method_name == "__call__":
                key, _ = flax_to_torch_key(tuple(ctx.module.scope.path) + ("kernel",), "params")
                caught[key.removesuffix(".weight")] = args[0]
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(catch):
            return model.apply(v, a, b, train=False), caught

    logits, caught = jax.jit(f)({**variables, "quant": quant}, images, hm)
    return np.asarray(logits), {k: np.array(v) for k, v in caught.items()}


def _port_conv_inputs(model) -> tuple[dict, dict]:
    """Wrap every quantised conv of ``model`` to record its NHWC input:
    ({path: input}, {path: its s_in})."""
    seen, s_in = {}, {}
    for path, m in model.quant_convs().items():
        if m.quant is None:
            continue
        inner, s_in[path] = m.quant, m.quant.qconv.s_in

        def wrapped(mod, x, inner=inner, path=path):
            seen[path] = x.permute(0, 2, 3, 1).numpy().copy()
            return inner(mod, x)

        m.quant = wrapped
    return seen, s_in


# -- the parameter tree, calibration, the quant collection -----------------------------


def test_param_tree_bijection_with_float(v20, jax_cal20):
    """The quantisation modes leave the state dict as the float model's (the
    scales live outside it, as JAX's separate ``quant`` collection), and
    calibration gives one scalar per conv: JAX's 76."""
    model = _port_model(v20)
    keys = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    scales = jax_quant_to_torch(jax_cal20)
    assert len(jax.tree_util.tree_leaves(jax_cal20)) == len(scales) == 76
    assert all(np.shape(a) == () for a in jax.tree_util.tree_leaves(jax_cal20))
    for mode in ("calibrate", "int8", "int8_mxu", "off"):
        model.set_quant(mode, scales)
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == keys
    assert set(scales) == set(model.quant_convs())


def test_calibrate_mode_is_float_math(v20, x20, jax_cal20):
    """"calibrate" computes the float model exactly and records a positive
    abs-max per conv, each within 1e-5 relative of JAX's."""
    model = _port_model(v20)
    ref = _run(model, *x20)
    model.set_quant("calibrate")
    got = _run(model, *x20)
    np.testing.assert_array_equal(got, ref)
    scales = model.calibration_scales()
    want = jax_quant_to_torch(jax_cal20)
    assert scales.keys() == want.keys() and len(scales) == 76
    assert all(a > 0 for a in scales.values())
    for k, a in scales.items():
        assert a == pytest.approx(want[k], rel=1e-5), k
    assert tq.calibrate(model, None, [x20]) == scales  # the same through calibrate()
    assert model.quant_mode == "off"


def test_calibrate_running_max_across_batches(v20, x20):
    model = _port_model(v20)
    images, hm = x20
    small_then_big = tq.calibrate(model, None, [(images * 0.1, hm * 0.1), (images, hm)])
    big = tq.calibrate(model, None, [(images, hm)])
    assert small_then_big == big  # the maximum is the big batch's
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate(model, None, [])


def test_quant_collection_carried_both_ways(jax_cal20):
    """JAX's nested ``quant`` collection <-> the port's scales by module path:
    a bijection over the 76 convs (raw convs, ``uppool_conv``, ``convm`` and
    the blocks' lists included)."""
    scales = jax_quant_to_torch(jax_cal20)
    assert "bottle2_x.4.convs.1" in scales and "bottle4_1up.uppool.1" in scales
    assert "bottle1_1.convm.0.conv" in scales and "bottle1_x.3.convs.2.conv" in scales
    back = torch_quant_to_jax(scales)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, dict(jax_cal20)))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(dict(jax_cal20))):
        assert pa == pb and a.dtype == np.float32 and a == b


# -- the int8 conv against JAX's _Int8Conv -----------------------------------------------


@jax.jit
def _jax_weight_quant(kernel):
    """``_Int8Conv``'s weight quantisation (``layers.py:151-153``), compiled."""
    s_w = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-12) / 127.0
    return s_w, jnp.clip(jnp.round(kernel / s_w), -127, 127).astype(jnp.int8)


def test_int8_weights_bit_equal_to_jax(v20):
    """From the same BN-folded kernel of each of the 76 convs: the int8
    weights and the per-channel scales bit-equal to JAX's."""
    folded = jax_fold_batchnorm(jax.tree_util.tree_map(jnp.asarray, v20))
    sd = jax_variables_to_torch(jax.tree_util.tree_map(np.asarray, folded))
    for path in Segment(20).quant_convs():
        w = sd[f"{path}.weight"]
        s_w, kq = (np.asarray(t) for t in _jax_weight_quant(w.numpy().transpose(2, 3, 1, 0)))
        wq, s_w_port = quantize_weight(w)
        np.testing.assert_array_equal(wq.numpy(), kq.transpose(3, 2, 0, 1), err_msg=path)
        np.testing.assert_array_equal(s_w_port.numpy(), s_w, err_msg=path)


#: (NHWC input shape, weight [out, in/groups, kh, kw], stride, padding, dilation, groups)
CONV_KINDS = {
    "5x5_s2_w20": ((2, 24, 24, 20), (16, 20, 5, 5), 2, 2, 1, 1),
    "5x5_s2_w3": ((2, 24, 24, 3), (16, 3, 5, 5), 2, 2, 1, 1),
    "5x5_s2_w16": ((2, 12, 12, 16), (16, 16, 5, 5), 2, 2, 1, 1),
    "2x2_s2_w36": ((2, 12, 12, 36), (16, 36, 2, 2), 2, 0, 1, 1),
    "2x2_s2_w19": ((2, 12, 12, 19), (16, 19, 2, 2), 2, 0, 1, 1),
    "2x2_s2_w48": ((2, 8, 8, 48), (16, 48, 2, 2), 2, 0, 1, 1),
    "3x3_dense_w16": ((2, 8, 8, 16), (16, 16, 3, 3), 1, 1, 1, 1),
    "3x3_dense_c4": ((2, 16, 16, 4), (4, 4, 3, 3), 1, 1, 1, 1),
    "1x1_w48_o128": ((2, 6, 6, 48), (128, 48, 1, 1), 1, 0, 1, 1),
    "1x1_w256_o128": ((2, 4, 4, 256), (128, 256, 1, 1), 1, 0, 1, 1),
    "1x1_w35_o16": ((2, 8, 8, 35), (16, 35, 1, 1), 1, 0, 1, 1),
    "1x1_w52_o16": ((2, 8, 8, 52), (16, 52, 1, 1), 1, 0, 1, 1),
    "1x1_w16_o4": ((2, 8, 8, 16), (4, 16, 1, 1), 1, 0, 1, 1),
    "dw3x3_d1": ((2, 8, 8, 48), (48, 1, 3, 3), 1, 1, 1, 48),
    "dw3x3_d2": ((2, 8, 8, 48), (48, 1, 3, 3), 1, 2, 2, 48),
    "dw3x3_d4": ((2, 12, 12, 48), (48, 1, 3, 3), 1, 4, 4, 48),
    "dw3x3_c16": ((2, 8, 8, 16), (16, 1, 3, 3), 1, 1, 1, 16),
    "grouped_5x1": ((2, 8, 8, 48), (48, 1, 5, 1), 1, (2, 0), 1, 48),
    "grouped_1x5": ((2, 8, 8, 48), (48, 1, 1, 5), 1, (0, 2), 1, 48),
}


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@pytest.mark.parametrize("kind", list(CONV_KINDS))
def test_int8_conv_matches_jax(kind):
    """One conv, the port's ``int8_conv`` (its plain version on the CPU)
    against JAX's ``_Int8Conv`` compiled on the same float32 input, weights,
    bias and abs-max (below the input's, so that clipping happens): the
    quantised input and the int32 accumulators bit-equal (JAX's recovered
    from its output with a zero bias, exact below 2^22), the outputs within
    one ulp of the product ``acc * scale`` plus one of the output (XLA's FMA
    rounds once, the port twice)."""
    xshape, wshape, stride, pad, dil, groups = CONV_KINDS[kind]
    rng = np.random.default_rng(sum(map(ord, kind)))
    x = rng.normal(0, 1, xshape).astype(F32)
    w = rng.normal(0, 0.3, wshape).astype(F32)
    bias = rng.normal(0, 0.5, wshape[0]).astype(F32)
    amax = F32(0.8 * np.abs(x).max())
    mod = _Int8Conv(features=wshape[0], kernel_size=wshape[2:], strides=_pair(stride),
                    padding=tuple((p, p) for p in _pair(pad)), feature_group_count=groups,
                    kernel_dilation=_pair(dil), mode="int8", dtype=jnp.float32)
    apply = jax.jit(mod.apply)
    kernel = w.transpose(2, 3, 1, 0)

    def jax_out(b):
        return np.asarray(apply({"params": {"kernel": kernel, "bias": b},
                                 "quant": {"amax": amax}}, x))

    conv = Int8Conv(torch.from_numpy(w), torch.from_numpy(bias), amax, _pair(stride),
                    _pair(pad), _pair(dil), groups)
    xt = torch.from_numpy(x)
    acc = int8_conv(xt, conv, torch.int32).numpy()
    got = int8_conv(xt, conv).numpy()
    scale = conv.scale.numpy()
    jax_acc = np.rint(jax_out(np.zeros_like(bias)).astype(np.float64) / scale)
    want = jax_out(bias)
    assert acc.dtype == np.int32 and acc.shape == want.shape
    assert np.abs(acc).max() < 2 ** 22
    np.testing.assert_array_equal(acc, jax_acc)
    # an FMA rounds once where the port rounds the product and the sum
    bound = np.spacing(np.abs(acc.astype(F32) * scale)) + np.spacing(np.abs(want))
    assert (np.abs(got - want) <= bound).all(), kind
    q = quantize_input_reference(xt, conv.s_in).numpy()
    assert (np.abs(q) == 127).any(), "the abs-max clips"
    np.testing.assert_array_equal(epilogue_scale(torch.from_numpy(w), amax).numpy(), scale)


def test_int8_conv_dtypes_and_shapes():
    """bfloat16 in: the output in bfloat16, the float32 epilogue's value
    rounded once; an input of the wrong width raises."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(0, 0.3, (16, 19, 2, 2)).astype(F32))
    conv = Int8Conv(w, torch.zeros(16), 2.0, (2, 2), (0, 0), (1, 1), 1)
    x = torch.from_numpy(rng.normal(0, 1, (1, 8, 8, 19)).astype(F32)).bfloat16()
    got = int8_conv(x, conv)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 4, 4, 16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  int8_conv(x.float(), conv).bfloat16().float().numpy())
    with pytest.raises(ValueError, match="expects"):
        int8_conv(torch.zeros((1, 8, 8, 20)), conv)


# -- the whole model in both modes -------------------------------------------------------


def _err_agree(got, ref):
    spread = ref.std() + 1e-6
    confident = np.abs(ref) > 0.2 * spread
    return (np.abs(got - ref).mean() / spread, confident.mean(),
            ((got > 0) == (ref > 0))[confident].mean())


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v.astype(np.float64)))


def _against_jax(mode, v20, x20, jax_cal20):
    """The port's model in ``mode`` against JAX's: the logits, and the
    flipped quantised elements over all quantised convs."""
    model = _port_model(v20)
    model.set_quant(mode, jax_quant_to_torch(jax_cal20))
    port_in, s_in = _port_conv_inputs(model)
    got = _run(model, *x20)
    ref, jax_in = _jax_int8(mode, v20, jax_cal20, *x20)
    assert port_in.keys() == jax_in.keys()
    flips = total = 0
    for path, xj in jax_in.items():
        a = quantize_input_reference(torch.from_numpy(xj), s_in[path])
        b = quantize_input_reference(torch.from_numpy(port_in[path]), s_in[path])
        flips += int((a != b).sum())
        total += a.numel()
    print(f"{mode}: {len(jax_in)} quantised convs, {flips} of {total} quantised input "
          f"elements flip against JAX")
    return got, ref, len(jax_in), flips, total


@pytest.mark.parametrize("mode,convs", [("int8", 76), ("int8_mxu", 6)])
def test_whole_model_matches_jax(mode, convs, v20, x20, jax_cal20):
    """Both int8 modes against JAX's (f32, 64 px, unfolded BN, the same
    scales): probabilities within 1e-2, masks >= 99.9 % equal; at most 1e-4
    of the quantised input elements flip (an ulp of a float op before a
    quantiser crosses a .5 boundary)."""
    got, ref, n_convs, flips, total = _against_jax(mode, v20, x20, jax_cal20)
    assert n_convs == convs
    assert total and flips <= 1e-4 * total
    np.testing.assert_allclose(_sigmoid(got), _sigmoid(ref), rtol=0, atol=1e-2)
    assert ((got > 0) == (ref > 0)).mean() >= 0.999


def test_int8_forward_tracks_float(v20, x20, jax_cal20):
    """JAX's own bounds (``tests/test_quantize.py``): the int8 model tracks
    the float one within 0.12 of the logit spread, and agrees on > 99 % of
    the confident pixels."""
    model = _port_model(v20)
    ref = _run(model, *x20)
    model.set_quant("int8", jax_quant_to_torch(jax_cal20))
    err, confident, agree = _err_agree(_run(model, *x20), ref)
    assert err < 0.12 and confident > 0.3 and agree > 0.99, (err, confident, agree)


def test_int8_mxu_selective_mode(v20, x20, jax_cal20):
    """"int8_mxu" quantises only the 6 spatial non-grouped convs, from the
    same calibration (the other scales are ignored), and tracks the float
    model at least as tightly as "int8"."""
    model = _port_model(v20)
    scales = jax_quant_to_torch(jax_cal20)
    ref = _run(model, *x20)
    covered = [p for p, m in model.quant_convs().items()
               if int8_selected("int8_mxu", m.kernel_size, m.groups)]
    assert covered == ["init_conv.layer1.conv", "init_conv.layer2.conv",
                       "bottle1_1.convs.0.conv", "bottle2_1.convs.0.conv",
                       "bottle4_3.convs.1.conv", "bottle5_2.convs.1.conv"]
    errs = {}
    for mode in ("int8", "int8_mxu"):
        model.set_quant(mode, scales)
        errs[mode] = _err_agree(_run(model, *x20), ref)[0]
    assert errs["int8_mxu"] < errs["int8"] * 1.1 + 1e-3, errs
    assert errs["int8_mxu"] < 0.12, errs
    with pytest.raises(KeyError, match="no calibrated scale"):
        model.set_quant("int8_mxu", {k: v for k, v in scales.items() if "init_conv" not in k})
    with pytest.raises(ValueError, match="unknown quant_mode"):
        model.set_quant("int4")


def test_chain_sections_hold_the_convs_the_chains_compute():
    """``Segment.chain_sections``, from which ``set_quant`` decides whether a
    quantised conv keeps the chains from running, holds exactly the convs
    whose weights the two chain extractors read."""
    model = Segment(20).eval()
    read = set()

    class Reads(dict):
        def __getitem__(self, key):
            read.add(key)
            return super().__getitem__(key)

    sd = Reads(fold_batchnorm(model.state_dict()))
    extract_s1_chain(sd, SIZE // 8, SIZE // 8)
    extract_s23_chain(sd, SIZE // 16, SIZE // 16)
    convs = model.quant_convs()
    path_of = {id(m): p for p, m in convs.items()}
    chained = {path_of[id(m)] for section in model.chain_sections() for top in section
               for m in top.modules() if id(m) in path_of}
    assert len(chained) == 48  # 12 in section 1, 36 in sections 2 and 3
    assert {k.removesuffix(".weight") for k in read} & convs.keys() == chained


# -- the engine ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine3():
    """Segment(3) variables, 2 images and JAX's calibration on their crops
    (as ``tests/test_quantize.py``'s engine cases)."""
    v = _variables(3, 1)
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, size=(80, 96, 3), dtype=np.uint8) for _ in range(2)]
    cal = np.stack([i[:SIZE, :SIZE] for i in images]).astype(F32) / 127.5 - 1.0
    model = JaxSegment(in_channels=3, dtype=jnp.float32, quant_mode="calibrate")
    quant = jax.tree_util.tree_map(np.asarray, jq.calibrate(model, v, [cal]))
    return v, images, cal, quant


def _jax_whole_program(variables, quant, mode):
    """JAX's whole-image int8 program (fold, backbone, folded head, sigmoid;
    ``infer/pipeline.py``'s ``_forward_whole``) compiled with the variables
    and scales as arguments.  The JAX engine closes over them as constants
    instead, and XLA then rewrites ``x / s_in`` into ``x * (1 / s_in)``."""
    folded = jax_fold_batchnorm(jax.tree_util.tree_map(jnp.asarray, variables))
    head = jax_fold_head(folded["params"])
    model = JaxSegment(in_channels=3, dtype=jnp.float32, quant_mode=mode)

    @jax.jit
    def run(v, images_u8):
        x = images_u8.astype(jnp.float32) / 127.5 - 1.0
        feats = model.apply(v, x, None, train=False, truncate_head=True)
        return jax.nn.sigmoid(jax_head_apply(feats, head, dtype=jnp.float32))

    return lambda images_u8: np.asarray(run({**folded, "quant": quant}, images_u8))


@pytest.mark.parametrize("mode,chains,vs_engine", [("int8_mxu", 2, 0.999), ("int8", 0, 0.9)])
def test_quantized_engine_serves_agreeing_masks(mode, chains, vs_engine, engine3, monkeypatch):
    """``InferenceEngine(quant=...)`` (JAX's collection or the port's dict)
    serves masks that agree > 0.9 with the float engine's (JAX's bound); its
    program on the resized batch equals JAX's int8 program within 1e-4 (masks
    >= 99.9 %); under "int8_mxu" both chain sections run their chain, under
    "int8" neither does.  Against the JAX engine end to end: >= 99.9 % under
    "int8_mxu"; under "int8" > 0.9, since the JAX engine's constant scales
    quantise by a multiplication (one image's masks agree 96.2 % here)."""
    v, images, cal, quant = engine3
    calls = []
    chain = tsegment._chain
    monkeypatch.setattr(tsegment, "_chain", lambda y, spec: calls.append(spec) or chain(y, spec))
    ef = InferenceEngine(v, in_channels=3, size=SIZE, dtype=torch.float32, device="cpu")
    eq = InferenceEngine(v, in_channels=3, size=SIZE, dtype=torch.float32, quant=quant,
                         quant_mode=mode, device="cpu")
    ed = InferenceEngine(v, in_channels=3, size=SIZE, dtype=torch.float32,
                         quant=jax_quant_to_torch(quant), quant_mode=mode, device="cpu")
    float_masks = ef.predict_images(images)
    calls.clear()
    masks = eq.predict_images(images)
    assert len(calls) == chains
    batch = np.stack([to_u8(resize(torch.from_numpy(im), (SIZE, SIZE))).numpy() for im in images])
    with torch.inference_mode():
        probs = eq._forward_whole(torch.from_numpy(batch)).numpy()
    want = _jax_whole_program(v, quant, mode)(batch)
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-4)
    assert ((probs > 0.5) == (want > 0.5)).mean() >= 0.999
    jax_masks = JaxEngine(v, in_channels=3, size=SIZE, dtype=jnp.float32, quant=quant,
                          quant_mode=mode).predict_images(images)
    for a, b, c, d in zip(float_masks, masks, jax_masks, ed.predict_images(images)):
        assert a.shape == b.shape == c.shape
        assert (a == b).mean() > 0.9, (a == b).mean()
        assert (b == c).mean() >= vs_engine, (b == c).mean()
        np.testing.assert_array_equal(b, d)


def test_engine_takes_jax_defaults(engine3):
    """The JAX engine's serving keywords with their defaults build an engine
    equal to the plain one.  The other values, once refused, build:
    ``fused_stem=True`` on this 3-channel model is JAX's gate (the plain
    engine, no stem fold), ``fold_bn=False`` serves the unfolded weights
    with no chain."""
    v = engine3[0]
    plain = InferenceEngine(v, in_channels=3, size=SIZE, dtype=torch.float32, device="cpu")
    jax_defaults = InferenceEngine(v, 3, SIZE, torch.float32, 0.5, fused_stem=False,
                                   quant=None, quant_mode="int8_mxu", fold_bn=True,
                                   device="cpu")
    for k, t in plain.variables.items():
        assert torch.equal(jax_defaults.variables[k], t)
    gated = InferenceEngine(v, in_channels=3, size=SIZE, dtype=torch.float32, fused_stem=True,
                            device="cpu")
    assert not gated._fused_stem
    for k, t in plain.variables.items():
        assert torch.equal(gated.variables[k], t)
    unfolded = InferenceEngine(v, in_channels=3, size=SIZE, dtype=torch.float32, fold_bn=False,
                               device="cpu")
    assert unfolded.model.chains is None
    for k, t in jax_variables_to_torch(v).items():
        assert torch.equal(unfolded.variables[k], t)


# -- calibration through the data paths ----------------------------------------------------


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_quant"))
    make_synthetic_dataset(root, num_images=3, seed=13)
    return root


def test_calibrate_on_dataset_matches_jax(synth, v20):
    """Through the serving preprocess with every augmentation off: the
    scales within 1e-5 relative of JAX's."""
    got = tq.calibrate_on_dataset(v20, synth, in_channels=20, size=SIZE, batches=1,
                                  batch_size=2, device="cpu")
    want = jax_quant_to_torch(jq.calibrate_on_dataset(v20, synth, in_channels=20, size=SIZE,
                                                      batches=1, batch_size=2))
    assert got.keys() == want.keys() and len(got) == 76
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_calibrate_on_images_matches_jax(engine3):
    """cv2's uint8 resize and the engine's normalise: the scales within 1e-5
    relative of JAX's."""
    v, images = engine3[:2]
    got = tq.calibrate_on_images(v, images, in_channels=3, size=SIZE, device="cpu")
    want = jax_quant_to_torch(jq.calibrate_on_images(v, images, in_channels=3, size=SIZE))
    assert got.keys() == want.keys() and len(got) == 76
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    with pytest.raises(ValueError, match="at least one image"):
        tq.calibrate_on_images(v, [], device="cpu")
