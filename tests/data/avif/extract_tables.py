"""Copy the AV1 decoder's tables out of cv2's libaom into the port and check
them.

    python tests/data/avif/extract_tables.py [--check]

cv2 5.0 reads AVIF through its bundled libavif 1.4.2 over libaom 3.14.1
(``opencv_python.libs/libaom-*.so.3.14.1``; libaom's BSD-2 licence is in
``LICENSE-libaom.txt`` beside this script).  That library keeps its symbol
table, so each table the port's AV1 decoder needs is read by its name and
size: the coefficient CDFs (``av1_default_*_cdfs``), the quantiser lookups
and inverse weight matrices, the scan orders (through the relocations of
``av1_scan_orders``), the coefficient context offsets, the filter-intra
taps, the smooth weights, the directional derivatives, the self-guided
parameters and their reciprocals, the transform constants, the inter
transform-type CDFs and the sets' member lists, the chroma block sizes of
each subsampling (``av1_ss_size_lookup``), CDEF's 4:2:2 chroma direction
map (``conv422``) and the default motion-vector context, which intra block
copy's displacement vectors start from (``default_nmv_context``).  The
small mode CDFs have no symbol of their own: libaom's ``av1_init_mode_probs``
copies them into a frame context, so the script calls it on a buffer and
reads them at their places in that struct, anchored by the tables that do
have symbols (kf y mode, partition, uv mode, intra tx type; the palette
colour index CDFs, which have symbols too, lie between them); the
transform-partition CDFs of intra block copy's transform trees are read
there too.

CDFs stay in libaom's inverse form (32768 - the spec's value, with the
adaptation counter in the last slot).  Scans, context offsets and
quantiser matrices are stored by libaom column by column; they are written
here row by row, as the AV1 specification indexes coefficients.

It writes ``instancesegmentation_tpu_torch/ops/native/av1_tables.h``; with
``--check`` it only compares the file with what it would write (exit 1 on a
difference).  The port reads only that committed header.
"""
import argparse
import ctypes
import os
import struct
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
OUT = os.path.join(ROOT, "instancesegmentation_tpu_torch", "ops", "native", "av1_tables.h")

#: TX_SIZES_ALL in libaom's order: (name, width, height)
TX_SIZES = [("4x4", 4, 4), ("8x8", 8, 8), ("16x16", 16, 16), ("32x32", 32, 32),
            ("64x64", 64, 64), ("4x8", 4, 8), ("8x4", 8, 4), ("8x16", 8, 16),
            ("16x8", 16, 8), ("16x32", 16, 32), ("32x16", 32, 16), ("32x64", 32, 64),
            ("64x32", 64, 32), ("4x16", 4, 16), ("16x4", 16, 4), ("8x32", 8, 32),
            ("32x8", 32, 8), ("16x64", 16, 64), ("64x16", 64, 16)]
#: the quantiser matrix blocks of one level and plane, in libaom's order
QM_SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16), (16, 8), (16, 32),
            (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)]

#: (C name, libaom symbol, dtype, shape) of the tables read by name
NAMED = [
    ("kTxbSkipCdf", "av1_default_txb_skip_cdfs", "u16", (4, 5, 13, 3)),
    ("kEobExtraCdf", "av1_default_eob_extra_cdfs", "u16", (4, 5, 2, 9, 3)),
    ("kDcSignCdf", "av1_default_dc_sign_cdfs", "u16", (4, 2, 3, 3)),
    ("kEobMulti16Cdf", "av1_default_eob_multi16_cdfs", "u16", (4, 2, 2, 6)),
    ("kEobMulti32Cdf", "av1_default_eob_multi32_cdfs", "u16", (4, 2, 2, 7)),
    ("kEobMulti64Cdf", "av1_default_eob_multi64_cdfs", "u16", (4, 2, 2, 8)),
    ("kEobMulti128Cdf", "av1_default_eob_multi128_cdfs", "u16", (4, 2, 2, 9)),
    ("kEobMulti256Cdf", "av1_default_eob_multi256_cdfs", "u16", (4, 2, 2, 10)),
    ("kEobMulti512Cdf", "av1_default_eob_multi512_cdfs", "u16", (4, 2, 2, 11)),
    ("kEobMulti1024Cdf", "av1_default_eob_multi1024_cdfs", "u16", (4, 2, 2, 12)),
    ("kCoeffBaseEobCdf", "av1_default_coeff_base_eob_multi_cdfs", "u16", (4, 5, 2, 4, 4)),
    ("kCoeffBaseCdf", "av1_default_coeff_base_multi_cdfs", "u16", (4, 5, 2, 42, 5)),
    ("kCoeffBrCdf", "av1_default_coeff_lps_multi_cdfs", "u16", (4, 5, 2, 21, 5)),
    ("kDcQLookup", "dc_qlookup_QTX", "i16", (256,)),
    ("kAcQLookup", "ac_qlookup_QTX", "i16", (256,)),
    ("kFilterIntraTaps", "av1_filter_intra_taps", "i8", (5, 8, 8)),
    ("kSmoothWeights", "smooth_weights", "u8", (124,)),
    ("kDrIntraDerivative", "dr_intra_derivative", "u16", (90,)),
    ("kModeToAngle", "mode_to_angle_map", "u8", (13,)),
    ("kSgrParams", "av1_sgr_params", "i32", (16, 4)),
    ("kXByXplus1", "av1_x_by_xplus1", "u32", (256,)),
    ("kOneByX", "av1_one_by_x", "i32", (25,)),
    ("kCospi", "av1_cospi_arr_data", "i32", (4, 64)),
    ("kSinpi", "av1_sinpi_arr_data", "i32", (4, 5)),
    ("kExtTxInv", "av1_ext_tx_inv", "i32", (6, 16)),
    ("kExtTxSetIndex", "ext_tx_set_index", "i32", (2, 6)),
    ("kPaletteYColorCdf", "default_palette_y_color_index_cdf", "u16", (7, 5, 9)),
    ("kPaletteUvColorCdf", "default_palette_uv_color_index_cdf", "u16", (7, 5, 9)),
    ("kInterExtTxCdf", "default_inter_ext_tx_cdf", "u16", (4, 4, 17)),
    ("kExtTxUsed", "av1_ext_tx_used", "i32", (6, 16)),
    ("kSsSizeLookup", "av1_ss_size_lookup", "u8", (22, 2, 2)),
    ("kConv422", "conv422.1", "i32", (8,)),
    ("kNmvContext", "default_nmv_context", "u16", (143,)),
]
#: (C name, shape, uint16 offset in the frame context) of the mode CDFs
#: that ``av1_init_mode_probs`` writes (libaom 3.14.1's FRAME_CONTEXT)
FRAME_CONTEXT = [
    ("kPaletteYSizeCdf", (7, 8), 4860),
    ("kPaletteUvSizeCdf", (7, 8), 4916),
    ("kPaletteYModeCdf", (7, 3, 3), 5602),
    ("kPaletteUvModeCdf", (2, 3), 5665),
    ("kTxfmPartitionCdf", (21, 3), 5827),
    ("kSkipCdf", (3, 3), 5935),
    ("kIntrabcCdf", (3,), 6242),
    ("kSegIdCdf", (3, 9), 6254),
    ("kFilterIntraCdf", (22, 3), 6281),
    ("kFilterIntraModeCdf", (6,), 6347),
    ("kRestoreSwitchableCdf", (4,), 6353),
    ("kRestoreWienerCdf", (3,), 6357),
    ("kRestoreSgrprojCdf", (3,), 6360),
    ("kUvModeCdf", (2, 13, 15), 6419),
    ("kPartitionCdf", (20, 11), 6809),
    ("kKfYModeCdf", (5, 5, 14), 7093),
    ("kAngleDeltaCdf", (8, 8), 7443),
    ("kTxSizeCdf", (4, 3, 4), 7507),
    ("kDeltaQCdf", (5,), 7555),
    ("kDeltaLfMultiCdf", (4, 5), 7560),
    ("kDeltaLfCdf", (5,), 7580),
    ("kIntraExtTxCdf", (3, 4, 13, 17), 7585),
    ("kCflSignCdf", (9,), 10509),
    ("kCflAlphaCdf", (6, 17), 10518),
]
#: frame-context tables that also have a symbol: their bytes must agree
ANCHORS = {"kUvModeCdf": "default_uv_mode_cdf", "kPartitionCdf": "default_partition_cdf",
           "kKfYModeCdf": "default_kf_y_mode_cdf", "kIntraExtTxCdf": "default_intra_ext_tx_cdf"}
DTYPES = {"u8": (np.uint8, "uint8_t"), "i8": (np.int8, "int8_t"), "u16": (np.uint16, "uint16_t"),
          "i16": (np.int16, "int16_t"), "i32": (np.int32, "int32_t"), "u32": (np.uint32, "uint32_t")}


def libaom_path() -> str:
    import cv2
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
    names = [n for n in os.listdir(libs) if n.startswith("libaom-") and n.endswith(".so.3.14.1")]
    if len(names) != 1:
        raise FileNotFoundError(f"no libaom 3.14.1 in {libs}")
    return os.path.join(libs, names[0])


class Elf:
    """The section headers, symbols and relative relocations of an ELF64 file."""

    def __init__(self, data: bytes):
        self.data = data
        shoff, = struct.unpack_from("<Q", data, 0x28)
        shentsize, shnum, shstrndx = struct.unpack_from("<HHH", data, 0x3A)
        secs = [struct.unpack_from("<IIQQQQIIQQ", data, shoff + i * shentsize) for i in range(shnum)]
        names = secs[shstrndx]

        def sname(off):
            start = names[4] + off
            return data[start:data.index(b"\0", start)].decode()
        self.sections = {sname(s[0]): s for s in secs}
        symtab, strtab = self.sections[".symtab"], self.sections[".strtab"]
        self.symbols = {}
        for i in range(symtab[5] // 24):
            name, info, _, shndx, value, size = struct.unpack_from("<IBBHQQ", data, symtab[4] + 24 * i)
            start = strtab[4] + name
            n = data[start:data.index(b"\0", start)].decode()
            if n and (info & 0xF) in (0, 1, 2) and size:
                self.symbols.setdefault(n, (value, size))
        rela = self.sections[".rela.dyn"]
        self.relocs = {}
        for i in range(rela[5] // 24):
            off, info, addend = struct.unpack_from("<QQq", data, rela[4] + 24 * i)
            if info & 0xFFFFFFFF == 8:  # R_X86_64_RELATIVE
                self.relocs[off] = addend
        self.by_address = {}
        for n, (v, s) in self.symbols.items():
            self.by_address.setdefault(v, n)

    def offset(self, addr: int) -> int:
        for s in self.sections.values():
            if s[1] != 8 and s[3] <= addr < s[3] + s[5]:
                return addr - s[3] + s[4]
        raise KeyError(hex(addr))

    def array(self, name: str, dtype) -> np.ndarray:
        value, size = self.symbols[name]
        off = self.offset(value)
        return np.frombuffer(self.data[off:off + size], dtype).copy()


def frame_context(path: str, elf: Elf) -> np.ndarray:
    """The uint16 words ``av1_init_mode_probs`` writes into a frame context."""
    out = subprocess.run(["nm", "-D", "--defined-only", path], capture_output=True, text=True,
                         check=True).stdout
    dyn = {p[2]: int(p[0], 16) for p in (line.split() for line in out.splitlines()) if len(p) == 3}
    lib = ctypes.CDLL(path)
    base = ctypes.cast(lib.aom_codec_version, ctypes.c_void_p).value - dyn["aom_codec_version"]
    init = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(base + elf.symbols["av1_init_mode_probs"][0])
    buf = np.full(1 << 16, 0xAAAA, np.uint16)
    init(buf.ctypes.data)
    return buf


def check_cdfs(name: str, a: np.ndarray) -> None:
    """Every CDF ends with 0 (the inverse of 32768) and a zero counter and
    does not rise (all-zero rows are libaom's unused slots)."""
    rows = a.reshape(-1, a.shape[-1]).astype(np.int64)
    for r in rows:
        if not r.any():
            continue
        n = int(np.nonzero(r)[0].max()) + 2
        assert n <= len(r) and (np.diff(r[:n - 1]) <= 0).all() and r[n - 1] == 0, (name, r)


def nmv_rows(a: np.ndarray) -> np.ndarray:
    """The CDFs of an ``nmv_context`` (the joints, then per component the
    classes, class0 fractions, fractions, sign, class0 and high-precision
    bits, class0 and the ten offset bits), each padded to 12 words."""
    sizes = [5] + 2 * ([12, 5, 5, 5, 3, 3, 3, 3] + [3] * 10)
    assert sum(sizes) == a.size, a.size
    rows, o = np.zeros((len(sizes), 12), a.dtype), 0
    for i, n in enumerate(sizes):
        rows[i, :n] = a[o:o + n]
        o += n
    return rows


def row_major(libaom_pos: np.ndarray, w: int, h: int) -> np.ndarray:
    """libaom's column-major coefficient positions as row-major ones."""
    return (libaom_pos % h) * w + libaom_pos // h


def tables(path: str) -> list:
    """(C name, C type, array) of every table, in the header's order."""
    with open(path, "rb") as f:
        elf = Elf(f.read())
    out = []
    for cname, sym, dt, shape in NAMED:
        a = elf.array(sym, DTYPES[dt][0])
        assert a.size == int(np.prod(shape)), (sym, a.size, shape)
        a = a.reshape(shape)
        if cname.endswith("Cdf"):
            check_cdfs(cname, a)
        if cname == "kNmvContext":
            check_cdfs(cname, nmv_rows(a))
        out.append((cname, DTYPES[dt][1], a))
    fc = frame_context(path, elf)
    for cname, shape, off in FRAME_CONTEXT:
        a = fc[off:off + int(np.prod(shape))].reshape(shape)
        check_cdfs(cname, a)
        if cname in ANCHORS:
            assert np.array_equal(a.ravel(), elf.array(ANCHORS[cname], np.uint16)), cname
        out.append((cname, "uint16_t", a))
    assert (fc[:4045] == 0xAAAA).all() and (fc[10620:] == 0xAAAA).all() and fc[10619] != 0xAAAA
    # quantiser matrices: 15 levels x (luma, chroma) x the 14 blocks, row-major
    iwt = elf.array("iwt_matrix_ref", np.uint8).reshape(15, 2, 3344)
    qm = np.empty_like(iwt)
    off = 0
    for w, h in QM_SIZES:
        block = iwt[:, :, off:off + w * h].reshape(15, 2, w, h)  # [.., col, row]
        qm[:, :, off:off + w * h] = block.transpose(0, 1, 3, 2).reshape(15, 2, w * h)
        off += w * h
    out.append(("kQmIwt", "uint8_t", qm))
    # scans of every (tx size, tx type), as row-major positions, and the
    # coefficient base context offsets, row-major
    so_addr = elf.symbols["av1_scan_orders"][0]
    pool, index = [], {}
    scan_of = np.zeros((19, 16), np.int32)
    for t, (_, w, h) in enumerate(TX_SIZES):
        for k in range(16):
            target = elf.relocs[so_addr + (t * 16 + k) * 16]
            sym = elf.by_address[target]
            if sym not in index:
                sw = min(w, 32)
                sh = min(h, 32)
                s = elf.array(sym, np.int16).astype(np.int64)
                assert sorted(s.tolist()) == list(range(sw * sh)), sym
                index[sym] = len(pool)
                pool.append(row_major(s, sw, sh))
            scan_of[t, k] = index[sym]
    offs = np.zeros(len(pool) + 1, np.int32)
    offs[1:] = np.cumsum([len(p) for p in pool])
    out.append(("kScanPool", "int16_t", np.concatenate(pool).astype(np.int16)))
    out.append(("kScanOffset", "int32_t", offs))
    out.append(("kScanOf", "int32_t", scan_of))
    nz_addr = elf.symbols["av1_nz_map_ctx_offset"][0]
    nz = np.zeros((19, 32 * 32), np.int8)
    for t, (_, w, h) in enumerate(TX_SIZES):
        sym = elf.by_address[elf.relocs[nz_addr + 8 * t]]
        a = elf.array(sym, np.int8)
        # libaom points some sizes at a wider table of the same height
        # (8x4 at 16x4's, 16x8 at 32x8's), read with that table's height
        sym_h = min(int(sym.rsplit("x", 1)[1]), 32)
        sw, sh = min(w, 32), min(h, 32)
        assert sym_h == sh and a.size >= sw * sh, sym
        pos = np.arange(sw * sh)
        nz[t, row_major(pos, sw, sh)] = a[pos]
    out.append(("kNzMapCtxOffset", "int8_t", nz))
    return out


def render(tabs: list) -> str:
    lines = ["// Generated by tests/data/avif/extract_tables.py from libaom 3.14.1 as",
             "// cv2 5.0 bundles it (BSD-2 licence: tests/data/avif/LICENSE-libaom.txt).",
             "// Do not edit: regenerate, or check with --check.",
             "#pragma once", "#include <cstdint>", ""]
    for cname, ctype, a in tabs:
        dims = "".join(f"[{d}]" for d in a.shape)
        flat = a.ravel().tolist()
        body = []
        for i in range(0, len(flat), 16):
            body.append("  " + ", ".join(str(v) for v in flat[i:i + 16]) + ",")
        lines.append(f"static const {ctype} {cname}{dims} = {{")
        lines.extend(body)
        lines.append("};")
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args(argv)
    text = render(tables(libaom_path()))
    if args.check:
        with open(OUT) as f:
            same = f.read() == text
        print("av1_tables.h matches libaom" if same else "av1_tables.h differs from libaom")
        return 0 if same else 1
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
