"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``kernels/<family>/csrc/<name>.cu`` exposes a plain C interface and
is compiled on its own into ``build/kernels/lib<name>-<hash>.so`` at the
repo root (``build/`` is generated and listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -I kernels/common \
         -o lib<name>-<hash>.so <name>.cu

``kernels/common/`` holds the headers every kernel may include
(``hopper.cuh``: mbarriers, TMA, wgmma, setmaxnreg, tensor maps).  The
hash covers the source, the headers beside it, the shared headers and the
flags, so an edited source or header rebuilds at its next use and an
unchanged one never does.
``build()`` starts one ``nvcc`` per source, all at once, and waits for all
of them; the compiler's output (``-Xptxas -v``: registers, shared memory,
spills) is kept beside each library as ``.log``.  No PyTorch headers are
involved, so a build takes seconds.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
COMMON_DIR = KERNELS_DIR / "common"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(COMMON_DIR))

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name → its ``.cu`` source, for every kernel in the package."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in ([src] + sorted(src.parent.glob("*.cuh"))
              + sorted(COMMON_DIR.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    src = sources().get(name)
    if src is None:
        raise KeyError(f"no kernel source named {name!r}; have "
                       f"{sorted(sources())}")
    return BUILD_DIR / f"lib{name}-{_digest(src)}.so"


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises ``FileNotFoundError`` if none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise FileNotFoundError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) whose library is missing,
    one ``nvcc`` per source, started together.  Returns name → library
    path.  Raises ``RuntimeError`` with the compiler output if any compile
    fails (after every started compiler has exited)."""
    names = list(sources()) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc() if todo else None
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n"
                          f"{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)        # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """The compiler output kept from the build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
