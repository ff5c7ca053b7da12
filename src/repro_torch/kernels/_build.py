"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<hash>/lib<name>.so``
at the repository root, at first use.  ``<hash>`` covers the source, the
shared headers and the flags, so an edited source builds afresh and an
unchanged one is reused.  Several sources build in parallel, one nvcc each.
Each library is written to a temp name and renamed into place, so
concurrent builds never load a half-written file.  ptxas's report
(registers, shared memory, spills) is kept beside it as ``ptxas.txt``.

nvcc is looked up in ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
then ``PATH``.  A missing nvcc or a failed build raises: nothing falls
back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError("nvcc not found: the CUDA kernels cannot be built")
    return found


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _out_dir(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"


def library_path(name: str) -> Path:
    return _out_dir(name) / f"lib{name}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Build every named source that is not built yet, all nvcc processes
    started together; returns name -> library path.  Raises on failure."""
    names = sources() if names is None else list(names)
    pending = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=out.parent, prefix=".inflight-", suffix=".so")
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending[name] = (proc, tmp, out)
    failures = []
    for name, (proc, tmp, out) in pending.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        (out.parent / "ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: library_path(name) for name in names}


def ptxas_report(name: str) -> str:
    """What ptxas printed for ``name`` (after :func:`build`)."""
    return (_out_dir(name) / "ptxas.txt").read_text()


def load(name: str) -> ctypes.CDLL:
    """Open the library ``name``, building it first if needed (callers
    keep the handle)."""
    return ctypes.CDLL(str(build([name])[name]))
