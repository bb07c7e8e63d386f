"""Build and load the hand-written CUDA kernels of pcf_torch/csrc/.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc, for
sm_90a, into its own shared library under `pcf_torch/_build/`, which ctypes
loads. A library's file name carries a hash of its source, the headers in
`csrc/` and the flags, so an edited source or header is rebuilt at its next
use. `build()` starts one nvcc per source, all at once, and raises if any of
them fails. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("window_resolve", "window_scatter", "pcf_conv_linear", "layer_eval")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # the sources share headers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, with one nvcc
    process per source running at the same time. Returns the compiler's
    report (ptxas registers, shared memory and spills) for each name, read
    back from the log kept beside a library built earlier."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, so)
    failed = []
    for name, (proc, tmp, so) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
