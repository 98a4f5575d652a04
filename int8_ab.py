"""Hold this tree's int8 conv kernel against another version of
``csrc/int8_conv.cu`` on one NVIDIA GPU: their SASS and their times.

    git show <commit>:instancesegmentation_tpu_torch/csrc/int8_conv.cu > build/ab/base.cu
    python3 int8_ab.py build/ab/base.cu

Both sources are built with the port's nvcc flags (``ops/_build.py``) into
``build/ab/``. Printed: for every dense instantiation of the base (one
slice of at most 128 outputs), whether this tree's matching one-slice
instantiation has the same SASS, and where not, its instruction counts and
the first differing lines; then the model's int8 conv geometries
(``Segment(20)`` at 480, ``Segment(3)`` at 512, as
``tests/test_torch_port_int8_plan.py`` traces them) at batch 128 in
bfloat16 through each library, in turns (base, tree, tree, base, base,
tree; CUDA events), their outputs bit-equal; and the card's name and power
limit.
"""
import ctypes
import difflib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from instancesegmentation_tpu_torch.ops import _build  # noqa: E402
from instancesegmentation_tpu_torch.ops import int8_conv as ic  # noqa: E402

OUT = os.path.join(ROOT, "build", "ab")


def build(sources: dict) -> None:
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {k: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", os.path.join(OUT, f"{k}.so"), v],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, v in sources.items()}
    for k, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed on {sources[k]}:\n{log}")


def dense_sass(name: str) -> dict:
    """{function name without the WIDE flag: instructions} of the dense
    kernel's one-slice instantiations."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", os.path.join(OUT, f"{name}.so")], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            fn = fn if "dense" in fn and "Lb1E" not in fn else None
            if fn:
                fn = fn.replace("Lb0E", "")
                out[fn] = []
        elif fn and "/*" in line and ";" in line:
            out[fn].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line.split(";")[0]).strip())
    return out


def compare_sass() -> dict:
    base, tree = dense_sass("base"), dense_sass("tree")
    same = [n for n in base if tree.get(n) == base[n]]
    differing = {}
    for n in base:
        if n in tree and tree[n] != base[n]:
            d = [l for l in difflib.unified_diff(base[n], tree[n], lineterm="", n=0)
                 if not l.startswith(("---", "+++", "@@"))]
            differing[n] = {"instructions": [len(base[n]), len(tree[n])], "lines_differing": len(d),
                            "first": d[:4]}
    return {"base_instantiations": len(base), "identical": len(same),
            "missing_in_tree": [n for n in base if n not in tree], "differing": differing}


def time_geometries(iters: int = 10) -> dict:
    from test_torch_port_int8_plan import GEOMETRIES, _conv

    dev = torch.device("cuda:0")
    libs = {}
    for k in ("base", "tree"):
        fn = ctypes.CDLL(os.path.join(OUT, f"{k}.so")).int8_conv_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, p, ctypes.c_int, p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        libs[k] = fn
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for key in sorted(GEOMETRIES):
        for h, w in sorted(GEOMETRIES[key]):
            c = _conv(key, 0)
            q = ic.Int8Conv(c.wq.float(), c.bias, 2.0, c.stride, c.padding, c.dilation, c.groups,
                            device=dev)
            cases.append((q, torch.randn((128, h, w, key[0]), generator=g, device=dev).bfloat16()))
    ms, ref = {}, None
    for name in ("base", "tree", "tree", "base", "base", "tree"):
        ic._library = lambda name=name: libs[name]
        outs = [ic._launch(x, q, torch.bfloat16) for q, x in cases]
        if ref is None:
            ref = outs
        elif not all(torch.equal(a, b) for a, b in zip(ref, outs)):
            raise SystemExit(f"{name}'s outputs differ from the base's")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            for q, x in cases:
                ic._launch(x, q, torch.bfloat16)
        end.record()
        torch.cuda.synchronize()
        ms.setdefault(name, []).append(start.elapsed_time(end) / iters)
    return {"geometries": len(cases), "ms_per_pass_in_turns": ms, "outputs_bit_equal": True}


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    build({"base": sys.argv[1], "tree": os.path.join(_build.CSRC, "int8_conv.cu")})
    print(json.dumps({"sass": compare_sass()}))
    print(json.dumps({"times": time_geometries()}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
