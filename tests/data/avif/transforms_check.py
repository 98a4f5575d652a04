"""Hold the port's AV1 inverse transforms against libaom's own C functions.

    python tests/data/avif/transforms_check.py

cv2's libaom 3.14.1 keeps its symbol table (``extract_tables.py``), so its
1-D inverse transforms (``av1_idct4`` ... ``av1_idct64``, ``av1_iadst4`` ...
``av1_iadst16``, ``av1_iidentity4_c`` ... ``av1_iidentity32_c``) and its 2-D
ones (``av1_inv_txfm2d_add_<w>x<h>_c``, after its run-time dispatch tables
are set up) can be called here on seeded coefficients, large ones included
(libaom's 16-bit clamps), and compared with the port's
(``ops/native/av1.cpp``'s ``av1_test_tx1d`` and ``av1_test_tx2d``), every
value equal.  Prints ``ok`` or the first difference (exit 1).
"""
import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)
_spec = importlib.util.spec_from_file_location("extract_tables",
                                               os.path.join(HERE, "extract_tables.py"))
et = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(et)

from instancesegmentation_tpu_torch.ops.native.av1 import load_av1  # noqa: E402

#: (port type: 0 DCT, 1 ADST, 3 identity; log2 size) -> libaom's function
ONE_D = {(0, 2): "av1_idct4", (0, 3): "av1_idct8", (0, 4): "av1_idct16", (0, 5): "av1_idct32",
         (0, 6): "av1_idct64", (1, 2): "av1_iadst4", (1, 3): "av1_iadst8", (1, 4): "av1_iadst16",
         (3, 2): "av1_iidentity4_c", (3, 3): "av1_iidentity8_c", (3, 4): "av1_iidentity16_c",
         (3, 5): "av1_iidentity32_c"}


def libaom():
    path = et.libaom_path()
    elf = et.Elf(open(path, "rb").read())
    out = subprocess.run(["nm", "-D", "--defined-only", path], capture_output=True, text=True,
                         check=True).stdout
    dyn = {p[2]: int(p[0], 16) for p in (line.split() for line in out.splitlines()) if len(p) == 3}
    lib = ctypes.CDLL(path)
    base = ctypes.cast(lib.aom_codec_version, ctypes.c_void_p).value - dyn["aom_codec_version"]

    def fn(name, *argtypes):
        return ctypes.CFUNCTYPE(None, *argtypes)(base + elf.symbols[name][0])
    return fn


def allowed(w: int, h: int, tx_type: int) -> bool:
    """The types AV1 codes at each size (64: DCT only; 32: DCT and IDTX;
    16 x 16: no 1-D types)."""
    if max(w, h) == 64:
        return tx_type == 0
    if max(w, h) == 32:
        return tx_type in (0, 9)
    return not (w == h == 16 and tx_type >= 12)


def main() -> int:
    fn = libaom()
    port = load_av1()
    p32 = ctypes.POINTER(ctypes.c_int32)
    port.av1_test_tx1d.argtypes = [p32, ctypes.c_int, ctypes.c_int]
    port.av1_test_tx2d.argtypes = [p32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int]
    stage_range = (ctypes.c_int8 * 16)(*([16] * 16))
    rng = np.random.default_rng(27)
    for (kind, n), name in ONE_D.items():
        f = fn(name, p32, p32, ctypes.c_int8, ctypes.c_void_p)
        for trial in range(300):
            x = rng.integers(-[100, 3000, 32767][trial % 3], [100, 3000, 32767][trial % 3] + 1,
                             1 << n).astype(np.int32)
            want = np.zeros(1 << n, np.int32)
            f(x.ctypes.data_as(p32), want.ctypes.data_as(p32), 12, stage_range)
            got = x.copy()
            port.av1_test_tx1d(got.ctypes.data_as(p32), kind, n)
            if not np.array_equal(got, want):
                print(f"{name}: {x.tolist()} gives {got.tolist()}, libaom {want.tolist()}")
                return 1
    fn("aom_dsp_rtcd")()
    fn("av1_rtcd")()
    for t, (name, w, h) in enumerate(et.TX_SIZES):
        f = fn(f"av1_inv_txfm2d_add_{name}_c", ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_int, ctypes.c_int)
        tw, th = min(w, 32), min(h, 32)
        for tx_type in range(16):
            if not allowed(w, h, tx_type):
                continue
            for trial in range(12):
                amp = [50, 500, 4000][trial % 3]
                coef = np.zeros((th, tw), np.int32)
                k = int(rng.integers(1, tw * th + 1))
                coef.flat[rng.choice(tw * th, k, replace=False)] = rng.integers(-amp, amp + 1, k)
                pred = rng.integers(0, 256, (h, w)).astype(np.uint8)
                want = pred.astype(np.uint16)
                column_major = np.ascontiguousarray(coef.T)  # libaom's layout, kept alive
                f(column_major.ctypes.data, want.ctypes.data, w, tx_type, 8)
                got = pred.copy()
                port.av1_test_tx2d(coef.ctypes.data_as(p32), t, tx_type, 0, got.ctypes.data, w)
                if not np.array_equal(got, want):
                    print(f"{name} type {tx_type}: differs at {np.argwhere(got != want)[:3]}")
                    return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
