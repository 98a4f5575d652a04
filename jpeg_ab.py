"""Time this tree's JPEG decoder (``ops/native/jpeg.cpp``) against another
version of the source, in turns on one host.

    git show <commit>:instancesegmentation_tpu_torch/ops/native/jpeg.cpp > build/ab/jpeg_base.cpp
    python3 jpeg_ab.py build/ab/jpeg_base.cpp [--rounds 40]

Both sources are built with ``ops/native/build.py``'s flags into
``build/ab/``.  Each round decodes each timed fixture of ``tests/data/jpeg``
(the 480 x 640 4:2:0 quality-95 baseline and progressive files) in colour,
10 calls per turn, in the order base, change, change, base (then reversed
the next round); the outputs of both must equal the cv2 decode stored
beside the fixture.  The summary gives each side's median and minimum ms
per call and the change's median over the base's, with the card's name and
power limit as ``nvidia-smi`` prints them, then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "instancesegmentation_tpu_torch" / "ops" / "native" / "jpeg.cpp"
FIXTURES = ROOT / "tests" / "data" / "jpeg"
TIMED = ("base_480x640_420_q95", "prog_480x640_420_q95")
OUT = ROOT / "build" / "ab"


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def build(src: Path, name: str) -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT))
    from instancesegmentation_tpu_torch.ops.native.build import CXX_FLAGS

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    cxx = shutil.which("g++") or shutil.which("c++")
    subprocess.run([cxx, *CXX_FLAGS, f"-I{SRC.parent}", str(src), "-o", str(lib)], check=True,
                   timeout=300)
    dll = ctypes.CDLL(str(lib))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    dll.jpeg_decode.restype = ctypes.c_int
    dll.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, u8p, ctypes.c_int64,
                                ctypes.c_char_p, ctypes.c_int64]
    return dll


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", help="the jpeg.cpp to compare against")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    libs = {"base": build(Path(args.base), "jpeg_base"), "change": build(SRC, "jpeg_change")}
    msg = ctypes.create_string_buffer(256)
    result = {"card": card(), "rounds": args.rounds, "calls_per_turn": args.calls}
    for name in TIMED:
        data = (FIXTURES / f"{name}.jpg").read_bytes()
        want = np.load(FIXTURES / f"{name}.npz")["color"]
        out = np.empty(want.shape, np.uint8)
        for side, lib in libs.items():
            out[:] = 0
            assert lib.jpeg_decode(data, len(data), 0, out, out.size, msg, 256) == 0, side
            assert np.array_equal(out, want), f"{side} differs from cv2's decode of {name}"
        times = {side: [] for side in libs}
        for r in range(args.rounds):
            order = ("base", "change", "change", "base") if r % 2 == 0 else (
                "change", "base", "base", "change")
            for side in order:
                lib = libs[side]
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    lib.jpeg_decode(data, len(data), 0, out, out.size, msg, 256)
                times[side].append((time.perf_counter() - t0) * 1e3 / args.calls)
        row = {f"{side}_{stat}_ms": float(fn(t)) for side, t in times.items()
               for stat, fn in (("median", np.median), ("min", np.min))}
        row["change_over_base_median"] = row["change_median_ms"] / row["base_median_ms"]
        result[name] = row
        print(f"{name}: base {row['base_median_ms']:.3f} ms (min {row['base_min_ms']:.3f}), "
              f"change {row['change_median_ms']:.3f} ms (min {row['change_min_ms']:.3f}), "
              f"change / base {row['change_over_base_median']:.4f} (median of "
              f"{2 * args.rounds} turns of {args.calls} calls; host clock); {result['card']}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
