"""Builds and loads the port's CUDA kernels.

Each source under dddpm_tpu_torch/csrc/ is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

(plus a -D flag per define asked for) into dddpm_tpu_torch/_build/
(listed in .gitignore) as a shared library with a plain C interface,
then loaded with ctypes.  The library's file name carries a hash of its
source, the headers of csrc/ and its defines, so an edited source or
header is rebuilt and an unchanged one is reused; nvcc's ptxas report
is kept beside it (`build_log`).  `build_all` starts one nvcc per
source at once.  Nothing is compiled when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """The library of csrc/<name>.cu built with `defines`; its nvcc log
    is the same path with the suffix .log.  The name hashes the source,
    every header of csrc/ (a source may include any of them) and the
    defines."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    for d in defines:
        digest.update(b"\0-D" + d.encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str, defines: Tuple[str, ...] = ()):
    """Starts nvcc for csrc/<name>.cu unless its library and log exist."""
    out = _target(name, defines)
    if out.exists() and out.with_suffix(".log").exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    # atomic: concurrent builders never see half a file
    tmp.with_suffix(".logtmp").write_text(log)
    os.replace(tmp.with_suffix(".logtmp"), out.with_suffix(".log"))
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> None:
    """Compiles the named sources in parallel (one nvcc each)."""
    names = list(names)
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (compiled with a -D flag per
    entry of `defines`), building it if needed."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        _finish(name, _start(name, key[1]))
        lib = _LIBS[key] = ctypes.CDLL(str(_target(*key)))
    return lib


def build_log(name: str) -> str:
    """nvcc's output (the `-Xptxas -v` report) for csrc/<name>.cu's
    present library, kept beside it by the build that made it; raises
    when the library has not been built."""
    return _target(name).with_suffix(".log").read_text()


def ptxas_report(name: str) -> List[dict]:
    """Per kernel of csrc/<name>.cu's library: its mangled name,
    registers and spill bytes, parsed from `build_log(name)`.  The spill
    bytes of a function that is not inlined (its own "Function
    properties" after the kernel's) are added to the kernel's."""
    out: List[dict] = []
    function = ""
    for line in build_log(name).splitlines():
        if "Compiling entry function" in line:
            out.append({"kernel": line.split("'")[1]})
        elif "Function properties for" in line:
            function = line.split("Function properties for")[1].strip()
        elif out and "bytes spill stores" in line:
            words = line.replace(",", " ").split()
            spill = {"spill_stores": int(words[words.index("spill") - 2]),
                     "spill_loads": int(words[-4])}
            own = function == out[-1]["kernel"]
            for k, v in spill.items():
                out[-1][k] = v if own else out[-1].get(k, 0) + v
        elif out and "Used" in line and "registers" in line:
            words = line.split()
            out[-1]["registers"] = int(words[words.index("Used") + 1])
    return out


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer as a C argument."""
    return ctypes.c_void_p(t.data_ptr())


def aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned (the
    kernels load 16 bytes at a time; a view with an offset may not be)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on t's device, as a C argument."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(status: int, what: str) -> None:
    """Raises if a C entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
