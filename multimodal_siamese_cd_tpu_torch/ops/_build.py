"""Build and load the package's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled at first
use, from the sources in the checkout only, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -shared -Xcompiler -fPIC -Xptxas -v -o <lib>.so <src>.cu

into ``build/torch_ext/`` at the repository root, and loaded with ctypes.
This needs no ninja, no pybind and no PyTorch headers, so a build takes
seconds. Sources may include the shared headers ``csrc/*.cuh`` (PTX
wrappers). The library name carries a hash of the source, every header and
the flags (:func:`library_path`), so an edited source or header is rebuilt
and a stale library is never loaded. A build or load failure raises;
nothing falls back to a plain version. Every wrapper launches through
:func:`launch`, which also declares each entry point's ctypes signature.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import uuid
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()          # guards _locks
_locks: dict = {}                 # name -> lock: kernels build in parallel
_loaded: dict = {}
_entries: dict = {}               # (library, symbol) -> declared entry point
# name -> {"seconds": build wall time (0.0 when the library was already
# built), "log": nvcc's output (ptxas register / shared-memory report)}
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else
    ``/usr/local/cuda/bin``; raises when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/{name}.cu`` builds to: ``BUILD_DIR/{name}_{hash}.so``,
    the hash taken over the source, every ``csrc/*.cuh`` header (names and
    contents, in name order) and the flags."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:12]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/{name}.cu`` if needed and return the loaded library.
    Different kernels may build at once from different threads."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC / f"{name}.cu"
        lib_path = library_path(name)
        info = {"seconds": 0.0, "log": ""}
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # unique temp name + atomic replace: concurrent builders never
            # load a half-written library
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.{uuid.uuid4().hex[:8]}")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            info["seconds"] = time.perf_counter() - t0
            info["log"] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n"
                                   f"{info['log']}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        BUILD_INFO[name] = info
        _loaded[name] = lib
        return lib


def launch(library: str, symbol: str, argtypes: tuple, device, *args,
           why: dict | None = None) -> None:
    """Call the C entry point ``symbol`` of ``csrc/{library}.cu`` with
    ``args`` and, as its last argument, the current stream of ``device``,
    with that device current. The entry point is loaded once
    (:func:`load_library`) and declared with ``argtypes`` (the stream's
    ``c_void_p`` last) and ``restype`` ``c_int``: the launch's
    ``cudaError``. A non-zero return raises ``RuntimeError`` naming
    ``symbol``, with ``why``'s text for that code where it has one."""
    fn = _entries.get((library, symbol))
    if fn is None:
        fn = getattr(load_library(library), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[library, symbol] = fn
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        text = (why or {}).get(err, f"cudaError {err}")
        raise RuntimeError(f"{symbol} kernel launch failed: {text}")
