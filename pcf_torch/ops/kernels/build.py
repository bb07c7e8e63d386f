"""Build and load the hand-written CUDA kernels of pcf_torch/csrc/.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc, for
sm_90a, into its own shared library under `pcf_torch/_build/`, which ctypes
loads. A library's file name carries a hash of its source, the headers in
`csrc/`, the flags and its split into parts, so an edited source or header
is rebuilt at its next use. `build()` starts one nvcc per source, all at
once, and raises if any of them fails. A source named in PARTS is compiled
as that many translation units at once (nvcc -c with -DPCF_PART=k
-DPCF_PARTS=n; the source puts its kernel instantiations in part k's unit by
that macro, its host code in part 0's), linked into its one library. Each
build prints its nvcc seconds. Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("window_resolve", "window_scatter", "pcf_conv_linear", "layer_eval", "knn_scene")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# translation units per source, compiled in parallel: layer_eval.cu's eight
# kernel instantiations one a unit, pcf_conv_linear.cu's nine (each in B's
# and C's mode) over five; as one unit each, they were the two longest builds
PARTS = {"layer_eval": 8, "pcf_conv_linear": 5}


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
    if name in PARTS:
        h.update(f"parts {PARTS[name]}".encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _commands(name: str, tmp: Path) -> tuple[list, list]:
    """(compile commands, link command or None) building csrc/<name>.cu
    into `tmp`: one nvcc, or one per part and a link of their objects."""
    source = str(CSRC_DIR / f"{name}.cu")
    n = PARTS.get(name, 1)
    if n == 1:
        return [[nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), source]], None
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{tmp}.part{k}.o" for k in range(n)]
    compiles = [[nvcc_path(), *flags, "-c", f"-DPCF_PART={k}", f"-DPCF_PARTS={n}", "-o", o,
                 source] for k, o in enumerate(objs)]
    return compiles, [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *objs]


def _start(cmd: list, log: Path) -> subprocess.Popen:
    with open(log, "w") as f:
        return subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, with one nvcc
    process per source (or per part, PARTS) running at the same time, and
    print each source's seconds. Returns the compiler's report (ptxas
    registers, shared memory and spills) for each name, read back from the
    log kept beside a library built earlier."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {}  # name -> [processes, link command, tmp, so, log files]
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        compiles, link = _commands(name, tmp)
        logs = [Path(f"{tmp}.{k}.log") for k in range(len(compiles))]
        running[name] = [[_start(cmd, log) for cmd, log in zip(compiles, logs)], link, tmp,
                         so, logs]
    failed = []
    while running:
        for name, (procs, link, tmp, so, logs) in list(running.items()):
            if any(p.poll() is None for p in procs):
                continue
            del running[name]
            if link is not None and all(p.returncode == 0 for p in procs):
                logs.append(Path(f"{tmp}.link.log"))
                procs.append(_start(link, logs[-1]))
                running[name] = [procs, None, tmp, so, logs]
                continue
            log = "".join(f.read_text() for f in logs)
            for f in logs:
                f.unlink()
            for o in BUILD_DIR.glob(f"{tmp.name}.part*.o"):
                o.unlink()
            bad = [p.returncode for p in procs if p.returncode != 0]
            if bad:
                failed.append(f"nvcc failed on {name}.cu (exit {bad[0]}):\n{log}")
                continue
            so.with_suffix(".log").write_text(log)
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
            print(f"[build] {name}.cu: nvcc {time.perf_counter() - t0:.1f} s "
                  f"({PARTS.get(name, 1)} translation unit(s))", flush=True)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
