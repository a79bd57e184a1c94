"""Build-on-first-use loader for the package's CUDA kernels.

``csrc/*.cu`` is compiled by ``nvcc`` into one shared library with a plain
C interface, keyed by a hash of the sources (with the ``*.cuh`` headers
they include) and the flags, and loaded with
``ctypes``. Each source compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects. The build lands in
``.rad_tpu_torch_build/`` beside the package (override with
``RAD_TPU_TORCH_BUILD_DIR``). No fast-math flag is passed: the kernels'
f32 divide must round to nearest, because bucket keys are the bits of the
similarity.

A missing ``nvcc`` or a failed build raises; nothing degrades to another
implementation.
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

__all__ = ["load_library", "build_info", "kernel_resources", "check",
           "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_info: dict = {}


def _build_dir() -> Path:
    env = os.environ.get("RAD_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parent.parent / ".rad_tpu_torch_build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the rad_tpu_torch CUDA "
        "kernels are compiled from csrc/ on first use")


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rad_tanimoto_matrix.argtypes = [vp, vp, ci, vp, vp, ci, ci, vp, vp]
    lib.rad_tanimoto_matrix.restype = ci
    lib.rad_tanimoto_bucketmin.argtypes = [vp, vp, ci, vp, vp, ci, ci, ci,
                                           ci, vp, vp]
    lib.rad_tanimoto_bucketmin.restype = ci
    lib.rad_tanimoto_bucket_topk.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci,
                                             ci, ci, ci, vp, vp, vp, vp]
    lib.rad_tanimoto_bucket_topk.restype = ci
    lib.rad_bucket_topk_max_words.argtypes = [ci, ci]
    lib.rad_bucket_topk_max_words.restype = ci
    lib.rad_tanimoto_nn.argtypes = [vp, vp, ci, vp, vp, ci, ci, ci, ci, vp,
                                    vp]
    lib.rad_tanimoto_nn.restype = ci
    lib.rad_nn_unpack_probe.argtypes = [vp, ci, ci, ci, ci, ci, vp, vp]
    lib.rad_nn_unpack_probe.restype = ci
    lib.rad_div_counts_check.argtypes = [ci, vp, vp]
    lib.rad_div_counts_check.restype = ci
    lib.rad_candidate_filter.argtypes = [vp, ci, vp, ci, vp, ci, vp, vp]
    lib.rad_candidate_filter.restype = ci
    lib.rad_integrate_candidates.argtypes = [vp, vp, ci, vp, vp, ci, vp, vp,
                                             ci, vp, ci, vp, ci, vp, vp, vp,
                                             vp]
    lib.rad_integrate_candidates.restype = ci
    lib.rad_scalar_gather.argtypes = [vp, ci, vp, ci, ci, vp, vp]
    lib.rad_scalar_gather.restype = ci
    lib.rad_scalar_checkset.argtypes = [vp, ci, vp, ci, vp, ci, ci, vp, vp]
    lib.rad_scalar_checkset.restype = ci
    lib.rad_scalar_chain.argtypes = [vp, ci, vp, vp, vp, ci, vp, ci, ci, vp,
                                     vp, vp, vp, vp]
    lib.rad_scalar_chain.restype = ci
    lib.rad_cuda_error_string.argtypes = [ci]
    lib.rad_cuda_error_string.restype = ctypes.c_char_p


def _compile_and_link(sources, so_path: Path, log_path: Path) -> None:
    """One ``nvcc -c`` per source, all running at once, then one link."""
    nvcc = _nvcc()
    tag = f"{so_path.stem}.{os.getpid()}"
    objs = [so_path.parent / f".{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    log, failed = [], []
    for src, proc in zip(sources, procs):
        out, err = proc.communicate()
        log.append(f"{nvcc} {' '.join(NVCC_FLAGS)} -c {src.name}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{err}")
    if not failed:
        tmp = so_path.parent / f".{tag}.so.tmp"
        proc = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log.append(f"{nvcc} -shared (link)\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stderr}")
    # the log lands before the library: a library found on disk has its log
    log_path.write_text("\n".join(log))
    if not failed:
        os.replace(tmp, so_path)  # atomic: concurrent builds agree
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(_CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources + sorted(_CSRC.glob("*.cuh")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        tag = h.hexdigest()[:16]
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        so_path = out_dir / f"librad_tpu_torch_{tag}.so"
        log_path = out_dir / f"librad_tpu_torch_{tag}.log"
        t0 = time.perf_counter()
        built = False
        if not so_path.exists():
            _compile_and_link(sources, so_path, log_path)
            built = True
        lib = ctypes.CDLL(str(so_path))
        _declare(lib)
        _info.update(path=str(so_path), built=built,
                     seconds=time.perf_counter() - t0,
                     flags=" ".join(NVCC_FLAGS),
                     sources=[str(s.relative_to(_CSRC.parent.parent))
                              for s in sources],
                     log=log_path.read_text())
        _lib = lib
        return lib


def build_info() -> dict:
    """Where the library came from: path, whether this process compiled
    it, seconds spent, nvcc flags, sources and the compiler's log (kept
    beside the library, so a library built earlier has it too)."""
    return dict(_info)


def kernel_resources(log: str | None = None) -> dict:
    """What ``ptxas -v`` said of each function in the build log (default:
    this process's library): mangled name -> ``{"registers", "spill_stores",
    "spill_loads"}`` (registers only for kernels, which ptxas reports
    them for)."""
    log = _info.get("log", "") if log is None else log
    out: dict = {}
    name = entry = None
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function '" in line:
            name = entry = line.split("'")[1]
        elif "Function properties for " in line:
            name = line.rsplit(" ", 1)[1]
        elif name and "bytes spill stores" in line:
            fields = line.replace(",", "").split()
            out.setdefault(name, {}).update(
                spill_stores=int(fields[fields.index("spill") - 2]),
                spill_loads=int(fields[-4]))
        elif entry and line.startswith("ptxas info") and (
                used := re.search(r"Used (\d+) registers", line)):
            out.setdefault(entry, {})["registers"] = int(used.group(1))
    return out


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = _lib.rad_cuda_error_string(code).decode() if _lib else ""
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
