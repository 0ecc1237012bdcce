"""Build the port's CUDA kernels with ``nvcc`` into plain-C shared
libraries and load them with ``ctypes``.

Each source under ``src/repro_torch/csrc/`` compiles on its own, for
``sm_90a``, into ``build/kernels/<stem>-<hash>.so`` at the repository root
(the hash covers the source and the flags, so an edited source rebuilds).
Nothing is built when a module is imported: the first launch builds, and
:func:`build_all` builds every source at once, one ``nvcc`` each, all
started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    """The nvcc binary: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return str(path)


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build_all(sources: Iterable[Path] = ()) -> Dict[str, dict]:
    """Compile every given source (default: all of ``csrc/*.cu``) that has
    no library yet, all nvcc processes at once. Returns, per source name,
    the build seconds and nvcc's resource report (``-Xptxas -v``).
    Raises with nvcc's output when a build fails."""
    sources = list(sources) or sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (tmp, out, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report = {}
    failed = []
    for src, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)     # atomic: a concurrent loader never sees half a file
        report[src.name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(source_name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source_name>``, built on first use."""
    src = CSRC / source_name
    if src not in _loaded:
        path = library_path(src)
        if not path.exists():
            build_all([src])
        _loaded[src] = ctypes.CDLL(str(path))
    return _loaded[src]
