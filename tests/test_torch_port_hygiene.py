"""The port imports neither JAX nor the JAX package nor cv2/PIL/matplotlib,
nor the repo's ``tools/`` (the JAX tools), nor msgpack (which the card's
machine does not have)."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "instancesegmentation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cv2", "PIL", "matplotlib", "msgpack", "grain",
             "orbax", "instancesegmentation_tpu", "tools", "show_aug")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_jax():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    ]
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {sorted(modules)!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_native_decoders_use_no_system_codec():
    """The port's C++ (the WebP and JPEG 2000 decoders and the TIFF codecs
    among it) includes no libwebp, libtiff or OpenJPEG header and links no
    library: ``build.py`` compiles each source alone, with no ``-march`` and
    with ``-ffp-contract=off`` (so that g++ contracts no FMA into the
    CIELab, SGILog and 9/7 wavelet arithmetic), and no port source names
    libwebp's, libtiff's or OpenJPEG's library or asks ctypes to find one."""
    native = PORT / "ops" / "native"
    for src in sorted(native.glob("*.cpp")) + sorted(native.glob("*.h")):
        includes = [line for line in src.read_text().splitlines() if line.startswith("#include")]
        assert not [i for i in includes if "webp/" in i or "<webp" in i or "tiff" in i
                    or "openjp" in i], src.name
    build = (native / "build.py").read_text()
    flags = build.split("CXX_FLAGS =")[1].split("\n")[0]
    assert "-lwebp" not in build and "-ltiff" not in build and "-l" not in flags
    assert "-lopenjp2" not in build
    assert "-march" not in flags and "-mfma" not in flags and "-ffast-math" not in flags
    assert "-ffp-contract=off" in flags
    for path in SOURCES + sorted(native.glob("*.cpp")):
        text = path.read_text()
        assert "libwebp.so" not in text and "libtiff.so" not in text, path.name
        assert "libopenjp2" not in text, path.name
        assert "find_library" not in text, path.name
