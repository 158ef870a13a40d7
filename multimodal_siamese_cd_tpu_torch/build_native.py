"""Build the optional native GeoTIFF decoders (LZW, PackBits) of the port.

    python -m multimodal_siamese_cd_tpu_torch.build_native [--out-dir DIR]

Compiles the repository's ``native/fastcodecs.c`` (a CPython extension)
with setuptools and the host's C compiler into ``build/native/`` at the
repository root (:data:`.geotiff.NATIVE_DIR`), where :mod:`.geotiff` loads
it when the package is imported. Nothing is written into the package.
Everything works without it: :mod:`.geotiff` then decodes with its
pure-Python decoders.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

from . import geotiff

SOURCE = Path(__file__).resolve().parent.parent / "native" / "fastcodecs.c"


def build(out_dir: Path | None = None) -> Path:
    """Compile :data:`SOURCE` (``-O3``) and place the extension at
    :func:`.geotiff.native_path` of ``out_dir``, replacing any earlier build
    in one rename. Returns its path."""
    from setuptools import Distribution, Extension
    from setuptools.command.build_ext import build_ext

    target = geotiff.native_path(out_dir)
    target.parent.mkdir(parents=True, exist_ok=True)
    ext = Extension("_fastcodecs", sources=[str(SOURCE)],
                    extra_compile_args=["-O3"])
    with tempfile.TemporaryDirectory(prefix="fastcodecs_") as tmp:
        cmd = build_ext(Distribution({"name": "fastcodecs", "ext_modules": [ext]}))
        cmd.build_lib = str(Path(tmp) / "lib")
        cmd.build_temp = str(Path(tmp) / "obj")
        cmd.finalize_options()
        cmd.run()
        staged = target.with_name(f".{target.name}.{os.getpid()}")
        staged.write_bytes(Path(cmd.get_ext_fullpath("_fastcodecs")).read_bytes())
        staged.replace(target)
    return target


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", type=Path, default=None,
                   help=f"where to build (default {geotiff.NATIVE_DIR})")
    args = p.parse_args(argv)
    target = build(args.out_dir)
    print(f"built {target}")
    module = geotiff.load_native(args.out_dir)
    if module is None:
        raise SystemExit(f"{target} was built but does not load")
    assert module.packbits_decode(bytes([1, 7, 7])) == bytes([7, 7])
    if args.out_dir is None:
        geotiff._fastcodecs = module   # this process decodes natively too
    print("import + smoke test OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
