"""Write the text fixtures of ``chip_smoke.py``'s ``visual_qa_phase``: cv2's
``draw_label`` and ``draw_keypoint(labeled=True)`` outputs, for a machine
with no cv2.

    python tests/data/text/make_fixtures.py

``labels.npz`` holds, per case ``k``: ``bg_k`` (the uint8 image drawn on),
``out_k`` (what the JAX package's ``core/visualize.py`` draws there with
cv2), and ``case_k``, a JSON string of the call: ``{"label", "origin",
"color", "thickness", "scale"}`` for ``draw_label``, ``{"keypoints",
"radius"}`` for ``draw_keypoint(..., labeled=True)``.  The cases are the 17
COCO keypoint names and "person" at scales 0.35 and 0.6, the printable
ASCII at four scales and both weights, a clipped and a multi-line label,
the 27 glyphs past ASCII of ROADMAP C7 at both weights, on 1-, 3- and
4-channel images, and labeled keypoints; then the labels cv2 draws with its
fallback font, WenQuanYi Micro Hei (ROADMAP A14), at both weights: CJK
alone, glyphs with scaled components, code points past the BMP, mixed
Latin / CJK strings over several lines, and characters in neither font
(controls, private use), which cv2 draws as Rubik's "?".
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from instancesegmentation_tpu.core import visualize as jvis  # noqa: E402
from instancesegmentation_tpu.core.keys import key_combine  # noqa: E402

COCO_NAMES = ("nose", "left_eye", "right_eye", "left_ear", "right_ear", "left_shoulder",
              "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
              "left_hip", "right_hip", "left_knee", "right_knee", "left_ankle", "right_ankle")
ASCII = "".join(chr(c) for c in range(32, 127))
PAST_ASCII = "\u00ae\u00b0\u00b7\u00c5\u00e5\u016e\u016f\u02da\u030a\u040e\u0419\u045e\u04c1\u04d0\u04d1\u04d6\u04d7\u05b2\u05b3\u05b7\u05c7\u0652\u2022\ufb2e\ufb2f\ufb43\ufb44"


def background(rng, h, w, channels, noisy):
    """A smooth picture (it compresses well), or a noisy one."""
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 255 // max(w - 1, 1) + (y * 3 if noisy else 0)) % 256
    img = np.stack([(base + 40 * k) % 256 for k in range(channels)], -1)
    if noisy:
        img = (img + rng.integers(0, 8, img.shape)) % 256
    return img.astype(np.uint8) if channels > 1 else img[..., 0].astype(np.uint8)


def label_cases():
    cases = []
    for scale in (0.35, 0.6):
        for name in COCO_NAMES + ("person",):
            cases.append(dict(label=name, origin=[2, 3], color=[255, 255, 255], thickness=1,
                              scale=scale, shape=[24, 96, 3]))
    for k, (scale, thickness) in enumerate([(0.3, 1), (0.6, 2), (1.0, 1), (1.5, 3)]):
        cases.append(dict(label=ASCII, origin=[1, 2], color=[30, 200, 90, 128],
                          thickness=thickness, scale=scale, shape=[64, 1500, (1, 3, 4, 3)[k]]))
    cases.append(dict(label="clipped jgQ", origin=[-9.7, -11.2], color=[255, 0, 0],
                      thickness=1, scale=1.0, shape=[20, 60, 3]))
    cases.append(dict(label="two\nlines", origin=[3, 0], color=[0, 255, 255], thickness=2,
                      scale=0.6, shape=[48, 60, 4]))
    # the glyphs past ASCII whose untouched points or intermediate region
    # take cv2's own rules (ROADMAP C7)
    for scale, thickness in [(1.0, 1), (0.6, 2)]:
        cases.append(dict(label=PAST_ASCII, origin=[2, 14], color=[250, 250, 250],
                          thickness=thickness, scale=scale, shape=[52, 800, 3]))
    return cases


#: labels of the fallback font: CJK (Chinese "pedestrian", Japanese, Korean),
#: glyphs with scaled components (U+4E04, U+650A, U+9D63), code points past
#: the BMP, mixed strings over several lines, and characters in neither font
FALLBACK_LABELS = ("\u884c\u4eba", "\u4eba\u7269 \u3072\u3068 \uc0ac\ub78c", "\u4e04\u650a\u9d63",
                   "\U00010400\U0001d30c",
                   "left_\u80a9 (\u5de6\u80a9)\n\u53f3\u80a9 right\n\n\u4eba",
                   "\u4eba\n\nN\u4e2d\n \u6587", "tab\there\rcr\x01\ue000\U0001f600!")


def fallback_cases():
    cases = []
    for k, label in enumerate(FALLBACK_LABELS):
        for thickness, scale in ((1, (0.6, 1.3)[k % 2]), (2, (1.0, 0.45)[k % 2])):
            cases.append(dict(label=label, origin=[3, 30], color=[240, 30, 200, 77],
                              thickness=thickness, scale=scale,
                              shape=[120, 420, (1, 3, 4)[(k + thickness) % 3]]))
    return cases


def keypoint_cases(rng):
    status_key, point_key = (key_combine("status", "keypoint_status"),
                             key_combine("point", "point_xy"))
    out = []
    for _ in range(4):
        body = {key_combine(name, "sub_dict"): {
            status_key: str(rng.choice(["vis", "not_vis", "missing"])),
            point_key: [float(v) for v in rng.uniform(-8, 90, 2)]} for name in COCO_NAMES}
        out.append(dict(keypoints=body, radius=3, shape=[96, 120, 3]))
    return out


def main():
    rng = np.random.default_rng(2026)
    arrays = {}
    for k, case in enumerate(label_cases() + keypoint_cases(rng) + fallback_cases()):
        h, w, c = case.pop("shape")
        bg = background(rng, h, w, c, noisy=k % 8 == 0)
        if "label" in case:
            out = jvis.draw_label(bg.copy(), case["label"], case["origin"],
                                  color=tuple(case["color"]), thickness=case["thickness"],
                                  scale=case["scale"])
        else:
            out = jvis.draw_keypoint(bg.copy(), case["keypoints"], labeled=True,
                                     radius=case["radius"])
        arrays[f"bg_{k}"], arrays[f"out_{k}"] = bg, out
        arrays[f"case_{k}"] = np.array(json.dumps(case))
    np.savez_compressed(os.path.join(HERE, "labels.npz"), **arrays)
    print(f"wrote {len(arrays) // 3} cases to labels.npz")


if __name__ == "__main__":
    main()
