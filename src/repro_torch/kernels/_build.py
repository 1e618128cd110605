"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ctypes.
All sources compile in parallel, one ``nvcc`` each.  A library's file
name carries a digest of its source, of the ``csrc/*.cuh`` headers it
includes, and of the flags, so an edited source or header never loads a
stale build.  The build directory ``kernels/build/`` is listed in
``.gitignore``; ``nvcc -Xptxas -v`` output (registers, shared memory,
spills per kernel) is kept beside each library as ``<name>-<digest>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'\s*#\s*include\s*"([^"]+\.cuh)"')
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_targets: Dict[str, Path] = {}
build_seconds = None     # wall time of the last build, for reports


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit (sm_90a)")


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers(src: Path) -> Sequence[Path]:
    """The ``csrc/*.cuh`` headers ``src`` includes, directly or through
    another header, sorted by name."""
    found, todo = set(), [src]
    while todo:
        for line in todo.pop().read_text().splitlines():
            m = _INCLUDE.match(line)
            if m and (CSRC / m.group(1)).is_file() and m.group(1) not in found:
                found.add(m.group(1))
                todo.append(CSRC / m.group(1))
    return [CSRC / name for name in sorted(found)]


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for hdr in headers(src):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once, and
    return {source stem: library path}.  Raises with nvcc's output if any
    compile fails."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    targets = {src.stem: _target(src) for src in sources()}
    procs = []
    for src in sources():
        out = targets[src.stem]
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=log, stderr=subprocess.STDOUT)
        procs.append((proc, log, tmp, out))
    failed = []
    for proc, log, tmp, out in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{out.name} (exit {rc}):\n"
                          + out.with_suffix(".log").read_text())
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for\n" + "\n".join(failed))
    _targets.update(targets)
    return targets


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building every
    source on the first call)."""
    with _lock:
        if stem not in _libs:
            if stem not in _targets:
                build_all()
            _libs[stem] = ctypes.CDLL(str(_targets[stem]))
        return _libs[stem]


def bind(stem: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """C function ``name`` of ``csrc/<stem>.cu`` with its argument types
    declared (pointers and the stream as ``c_void_p``, or ctypes would cut
    them to 32 bits) and an int return: the ``cudaError_t`` of the
    launch."""
    fn = getattr(library(stem), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(stem: str, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (a refused launch never
    runs, and no later synchronize reports it).  Every source exports
    ``const char* cuda_error_string(int)`` for the message."""
    if err != 0:
        fn = library(stem).cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({fn(err).decode()})")


def logs() -> Dict[str, str]:
    """{stem: nvcc -Xptxas -v output} of the libraries built so far."""
    return {stem: p.with_suffix(".log").read_text()
            for stem, p in _targets.items() if p.with_suffix(".log").exists()}
