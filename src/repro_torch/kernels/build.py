"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper), and the objects are linked into one
shared library with a plain C interface, loaded through ``ctypes``. The
build runs at first use, never at import, and is keyed by a hash of the
sources: ``build/repro_torch/<hash>/librepro_torch_kernels.so`` under the
checkout root. A failed build raises; nothing falls back.

Each kernel's C function returns ``cudaGetLastError()`` right after its
launch; :func:`launch` raises on a nonzero code and otherwise adds one to
the kernel's entry in :data:`LAUNCHES`, the count of launches a run can
read back to show which kernels it went through. A kernel with two
bodies (``zo_matmul`` and its three twins, ``flash_attention``,
``flash_prefill``, ``flash_verify``: bf16 tensor cores or the SIMT body,
as the C side's ``*_body`` rule picks; ``flash_decode``: the slot or the
split route, by G) also counts the body in :data:`BODIES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch_kernels.so"

#: launches of each kernel since the last reset (a plain int per kernel)
LAUNCHES: Dict[str, int] = {"zo_add": 0, "flash_decode": 0,
                            "flash_prefill": 0, "zo_matmul": 0,
                            "flash_attention": 0, "zo_add_q": 0,
                            "zo_matmul_q": 0, "zo_add_users": 0,
                            "zo_matmul_users": 0, "zo_matmul_users_q": 0,
                            "flash_verify": 0, "selective_scan": 0}

#: launches of the two-body kernels by body: ``"<kernel>/tc"`` (bf16
#: tensor cores) and ``"<kernel>/simt"``, the tensor-core launches of
#: ``zo_matmul`` and ``zo_matmul_users`` on the Hopper body (TMA, 2-CTA
#: clusters) also in ``"<kernel>/tc_tma"``; ``flash_decode`` by route:
#: ``"flash_decode/slot"`` (G = 1) and ``"flash_decode/split"`` (G >= 2),
#: the split launches on the tensor-core body (bf16, G 8-16) also in
#: ``"flash_decode/split_tc"``
BODIES: Dict[str, int] = {**{f"{k}/{b}": 0 for k in (
    "zo_matmul", "zo_matmul_q", "zo_matmul_users", "zo_matmul_users_q",
    "flash_attention", "flash_prefill", "flash_verify")
    for b in ("tc", "simt")},
    "zo_matmul/tc_tma": 0, "zo_matmul_users/tc_tma": 0,
    "flash_decode/slot": 0, "flash_decode/split": 0,
    "flash_decode/split_tc": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "repro_zo_add": (_P, _P, ctypes.c_int64, _I,
                     ctypes.POINTER(ctypes.c_int64), _I,
                     ctypes.POINTER(ctypes.c_int64), ctypes.c_uint32,
                     _I, ctypes.c_float, _I, _I, _P),
    "repro_flash_decode": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, ctypes.c_float, _P),
    "repro_flash_decode_split": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, ctypes.c_float, _P),
    "repro_flash_prefill": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, ctypes.c_float, _P),
    "repro_flash_verify": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, ctypes.c_float, _P),
    "repro_zo_matmul": (_P, _P, _P, _I, _I, _I, _I, ctypes.c_uint32, _I,
                        ctypes.c_float, _I, ctypes.c_int64, ctypes.c_int64,
                        _P),
    "repro_zo_add_q": (_P, _P, _P, ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_int64), _I, ctypes.c_uint32,
                       _I, ctypes.c_float, _I, _I, _P),
    "repro_zo_matmul_q": (_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint32,
                          _I, ctypes.c_float, _I, _P),
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, ctypes.c_float, _P),
    "repro_zo_add_users": (_P, _P, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int64, _I,
                           ctypes.POINTER(ctypes.c_int64), _I,
                           ctypes.POINTER(ctypes.c_uint32),
                           ctypes.POINTER(ctypes.c_float),
                           ctypes.POINTER(ctypes.c_int), _I, _I, _I, _I, _P),
    "repro_zo_matmul_users": (_P, _P, _P, _I, _I, _I, _I, ctypes.c_int64, _I,
                              ctypes.POINTER(ctypes.c_uint32),
                              ctypes.POINTER(ctypes.c_float), _I, _I, _I,
                              _P),
    "repro_zo_matmul_users_q": (_P, _P, _P, _P, _I, _I, _I, _I,
                                ctypes.POINTER(ctypes.c_uint32),
                                ctypes.POINTER(ctypes.c_float), _I, _I, _I,
                                _P),
    "repro_zo_matmul_body": (_I, _I, _I, _I, _I, ctypes.c_int64, _P, _P),
    "repro_zo_matmul_simt_tile": (_I, _I, _I, _I),
    "repro_flash_attention_body": (_I,),
    "repro_flash_prefill_body": (_I,),
    "repro_flash_verify_body": (_I,),
    "repro_flash_decode_split_body": (_I, _I),
    "repro_selective_scan": (_P,) * 11 + (_I,) * 6 + (ctypes.c_int64,
                                                      ctypes.c_int64, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path, cu_files) -> None:
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out_dir.parent, prefix=".tmp_"))
    try:
        procs = []
        for src in cu_files:              # one nvcc per source, in parallel
            obj = tmp / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(tmp / (s.stem + ".o")) for s in cu_files]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        try:
            os.replace(tmp, out_dir)      # atomic: a racing build may win
        except OSError:
            if not (out_dir / LIB_NAME).exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cu, cuh = _sources()
        if not cu:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        out_dir = BUILD_ROOT / _digest(cu + cuh)
        if not (out_dir / LIB_NAME).exists():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            _compile(out_dir, cu)
        lib = ctypes.CDLL(str(out_dir / LIB_NAME))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def launch(kernel: str, fn_name: str, *args, body=None) -> None:
    """Call ``fn_name`` of the library; raise on a launch error, else
    count one launch of ``kernel`` (and of its ``body``, if given: a name
    or a tuple of names)."""
    rc = getattr(library(), fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
    LAUNCHES[kernel] += 1
    for b in (body,) if isinstance(body, str) else body or ():
        BODIES[f"{kernel}/{b}"] += 1


def body(fn_name: str, *args) -> str:
    """``"tc"`` or ``"simt"``: the body the C side's rule ``fn_name``
    picks for these arguments (dtype, dist)."""
    return "tc" if getattr(library(), fn_name)(*args) else "simt"


def reset_launches() -> None:
    """Zero :data:`LAUNCHES`, :data:`BODIES` and the program's counters
    (``core.spans.COUNTS``)."""
    from repro_torch.core import spans   # core imports the kernels
    for counts in (LAUNCHES, BODIES, spans.COUNTS):
        for k in counts:
            counts[k] = 0
