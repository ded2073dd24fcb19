"""Build and load the port's CUDA kernels and its host C++ libraries.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/matcha_tpu_torch/`` of the checkout (gitignored), keyed on a hash
of the source, every header in ``csrc/`` and the flags, and loaded with
``ctypes``. The host
libraries of the repo's ``native/`` sources are compiled with ``g++``
into the same directory (``build_host_library``), never next to their
source.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "matcha_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_loaded = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.name.encode() + h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _finish(name: str, proc: subprocess.Popen, tmp: Path, path: Path) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{out}")
    os.replace(tmp, path)


def load_all(names) -> dict:
    """The loaded libraries for ``csrc/<name>.cu``, each name built first
    if needed, all missing ones at once (one ``nvcc`` each, started
    together). A build writes a file of its own and renames it into
    place, so processes that build at once do not see each other's
    partial output."""
    builds = []
    for name in names:
        path = library_path(name)
        if name in _loaded or path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds.append((name, proc, tmp, path))
    try:
        for build in builds:
            _finish(*build)
    finally:
        for _, proc, _, _ in builds:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in names:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return {name: _loaded[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    return load_all([name])[name]


def host_library_path(source: Path, stem: str, build_dir: Path = BUILD_DIR) -> Path:
    """Where ``build_host_library`` puts ``source``'s library: keyed on a
    hash of the source and ``GXX_FLAGS``."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir / f"{stem}-{digest}.so"


def build_host_library(source: Path, path: Path) -> Path:
    """Compile ``source`` with ``g++ GXX_FLAGS`` into ``path`` unless it is
    there; raises when ``g++`` fails. The build writes a file of its own
    and renames it into place, so processes that build at once do not see
    each other's partial output."""
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, str(source), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {source.name} (rc {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, path)
    return path
