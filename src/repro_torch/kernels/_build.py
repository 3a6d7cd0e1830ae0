"""Build and load the port's CUDA kernels, and count their launches.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` — one ``nvcc``
per source, all started together — and linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The build runs at first
use into ``build/repro_torch_kernels/`` under the repository root, keyed
by a digest of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing library.

``LAUNCHES`` holds one plain integer per kernel.  A wrapper adds one where
it launches its kernel, and nowhere else, so a run can show which kernels
its main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

KERNELS = ("topk_router", "adaptive_topk_router", "flash_attention",
           "ragged_gather", "ragged_expert_matmul", "ragged_combine",
           "lora_matmul", "lora_matmul_experts")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

# element-type codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lib: Optional[ctypes.CDLL] = None
BUILD_LOG: Dict[str, object] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _digest(csrc: Path) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(csrc.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Path = CSRC) -> Path:
    """Compile (if needed) and return the path of the kernel library built
    from the sources in ``csrc`` (this package's, unless an A/B names
    another build's)."""
    sources = sorted(csrc.glob("*.cu"))
    lib_path = BUILD_DIR / f"librepro_torch_kernels-{_digest(csrc)}.so"
    if lib_path.exists():
        BUILD_LOG.update(seconds=0.0, cached=True, ptxas="")
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp, src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for src, _obj, proc in procs:
            out, err = proc.communicate()
            logs.append(out + err)
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp, lib_path.name)
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _s, obj, _p in procs]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib_path)       # atomic: concurrent builds agree
    BUILD_LOG.update(seconds=time.perf_counter() - t0, cached=False,
                     ptxas="".join(logs))
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "rt_topk_router": (P, I, P, P, P, I, I, I, P),
        "rt_adaptive_topk_router": (P, I, P, P, P, P, I, I, I, P),
        "rt_flash_attention": (P, P, P, P, I, P, I, I, I, I, I, F, I, I, F,
                               P),
        "rt_ragged_gather": (P, P, P, P, I, I, I, P),
        "rt_ragged_combine": (P, P, P, P, I, I, I, I, P),
        "rt_ragged_expert_matmul": (P, P, P, P, P, P, I, I, I, I, I, I, F, P,
                                    I),
        "rt_lora_matmul": (P, P, P, P, P, I, I, I, I, I, F, P),
        "rt_lora_matmul_experts": (P, P, P, P, P, I, I, I, I, I, I, F, P),
        "rt_empty": (P,),
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name, None)
        if fn is None:      # an older build (an A/B's other arm)
            continue
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library, its C entry points declared."""
    handle = ctypes.CDLL(str(path))
    _declare(handle)
    return handle


def lib() -> ctypes.CDLL:
    """The kernel library the wrappers call (built at first use)."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def use(handle: ctypes.CDLL) -> None:
    """Make the wrappers call ``handle`` (from :func:`load`) from now on."""
    global _lib
    _lib = handle


def empty_launch(t: torch.Tensor) -> None:
    """Launch a kernel that does nothing on ``t``'s current stream: timed
    like a kernel, it is the floor under any launch's time."""
    check("empty", lib().rt_empty(stream_ptr(t)))


def check(name: str, code: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Wrapper precondition: every tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: the CUDA kernel needs every tensor on "
                             f"one CUDA device, got {t.device} and {dev}")


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {t.dtype} "
                        f"(float32, bfloat16, float16)")
    return DTYPE_CODES[t.dtype]


def require_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def require_int32(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
