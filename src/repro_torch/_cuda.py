"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) by an
``nvcc`` call of its own, all started together, and the objects are linked
by one more into a shared library with a plain C interface, which is loaded
through ``ctypes``.  The library is built at first use — never on import, so
the CPU tests need no ``nvcc`` — from the sources in this package and
nothing else, into ``build/repro_torch/`` at the root of the checkout.  Its
file name carries a hash of the sources and flags, so an edited source is
rebuilt.  A failed build raises with nvcc's command line and output.

Each C entry point launches on the caller's stream, does not synchronise,
allocates nothing and returns ``cudaGetLastError()`` after its launch;
:class:`Kernel` raises when that is not 0 and counts the launches.  A
lattice kernel takes one layout descriptor (``Layout.descriptor()``, an
int) for every field it reads or writes; :func:`check_field` checks a
tensor against its layout and returns that descriptor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

__all__ = ["Kernel", "build", "library", "check_tensor", "check_field", "check_typed_field",
           "check_batched_field",
           "reduce_dtype", "REDUCE_DTYPES", "smem_per_block_optin", "csrc_define", "CSRC",
           "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# a source's compile: every flag but -shared, which is the link's
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared")

_P = ctypes.c_void_p     # device pointer (and the stream)
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

_D = ctypes.c_int       # a layout descriptor (Layout.descriptor())

# C signature of every entry point (all return the launch's cudaError_t as
# int; the trailing _P is the stream, an _I before it the block size where
# the kernel takes the plan's vvl as its block).
SIGNATURES = {
    "rt_site_g5": (_P, _P, _I, _L, _I, _D, _D, _P),
    "rt_site_mul": (_P, _P, _P, _I, _L, _I, _L, _L, _D, _D, _D, _P),
    "rt_site_axpy": (_F, _P, _P, _P, _I, _L, _D, _D, _D, _P),
    "rt_reduce_partials": (_P, _P, _I, _L, _I, _D, _P),
    "rt_reduce_fold": (_P, _P, _P, _L, _I, _I, _P),
    "rt_reduce_partials_batched": (_P, _P, _I, _L, _I, _I, _D, _P),
    "rt_reduce_fold_batched": (_P, _P, _P, _L, _I, _I, _I, _P),
    "rt_reduce_partials_comp": (_P, _P, _I, _L, _I, _D, _P),
    "rt_reduce_fold_comp": (_P, _P, _P, _L, _I, _I, _P),
    "rt_reduce_partials_i32": (_P, _P, _I, _L, _I, _I, _D, _P),
    "rt_reduce_partials_bf16": (_P, _P, _I, _L, _I, _I, _D, _P),
    "rt_reduce_fold_split": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    "rt_cg_update": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, *(_D,) * 6, _I, _P),
    "rt_cg_xpay": (_P, _P, _P, _P, _I, _L, _D, _D, _D, _I, _P),
    "rt_cg_update_masked": (*(_P,) * 10, _L, _I, _L, _L, _L, _L, *(_D,) * 6, _I, _P),
    "rt_cg_xpay_masked": (_P, _P, _P, _P, _P, _I, _L, _I, _L, _L, _D, _D, _D, _I, _P),
    "rt_bf16_round": (_P, _P, _L, _I, _P),
    "rt_bf16_pack": (_P, _P, _L, _I, _P),
    "rt_cg_update_ap16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, *(_D,) * 6, _I, _P),
    "rt_cg_update_policy": (*(_P,) * 9, _L, _I, _I, _I, _I, *(_D,) * 6, _I, _P),
    "rt_cg_update_masked_ap16": (*(_P,) * 10, _L, _I, _L, _L, _L, _L, *(_D,) * 6, _I, _P),
    "rt_dslash": (_P, _P, _P, _I, _I, _I, _I, _D, _D, _D, _I, _P),
    "rt_wilson_normal_t": (_P, _P, _P, _F, _I, _I, _I, _I, _D, _D, _I, _P),
    "rt_wilson_normal_ap": (_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _D, _D, _D, _I, _P),
    "rt_wilson_normal_t_batched": (_P, _P, _P, _F, _I, _I, _I, _I, _I, _D, _D, _I, _P),
    "rt_wilson_normal_ap_batched": (_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _D, _D, _D, _I,
                                    _P),
    "rt_wilson_normal_t_mixed": (_P, _P, _P, _F, _I, _I, _I, _I, _I, _D, _D, _I, _P),
    "rt_wilson_normal_ap_mixed": (_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _D, _D, _D,
                                  _I, _P),
    "rt_wilson_normal_t_tiled": (_P, _P, _P, _F, *(_I,) * 8, _D, _D, _I, _P),
    "rt_wilson_normal_ap_tiled": (_P, _P, _P, _P, _P, _F, *(_I,) * 8, _D, _D, _D, _I, _P),
    "rt_wilson_normal_t_tiled_mixed": (_P, _P, _P, _F, *(_I,) * 8, _D, _D, _I, _P),
    "rt_wilson_normal_ap_tiled_mixed": (_P, _P, _P, _P, _P, _F, *(_I,) * 10, _D, _D, _D, _I, _P),
    "rt_dslash_halo": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "rt_wilson_normal_pre_t": (_P, _P, _P, _F, _I, _I, _I, _I, _I, _P),
    "rt_wilson_normal_pre_ap": (_P, _P, _P, _F, _I, _I, _I, _I, _I, _P),
    "rt_wilson_normal_pre_t_tiled": (_P, _P, _P, _F, *(_I,) * 7, _I, _P),
    "rt_wilson_normal_pre_ap_tiled": (_P, _P, _P, _F, *(_I,) * 7, _I, _P),
    # the box tables' _P is a host array of 13 ints a box (csrc/wilson_halo.cu)
    "rt_wilson_normal_t_boxes": (_P, _P, _P, _F, _I, _I, _I, _I, _P, _I, _I, _P),
    "rt_wilson_normal_ap_boxes": (_P, _P, _P, _F, _I, _I, _I, _I, _P, _I, _I, _P),
    "rt_wilson_normal_ap_boxes_tiled": (_P, _P, _P, _F, _I, _I, _I, _I, _P, _I, _I, _P),
    "rt_lb_propagate_halo": (_P, _P, _I, _I, _I, _I, _I, _P),
    "rt_lb_step_pre": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    "rt_lb_step_box": (_P, _P, _P, _P, *(_I,) * 9, _F, _F, _F, _F, _I, _P),
    "rt_lb_step_halo": (_P, _P, _P, _P, *(_I,) * 12, _F, _F, _F, _F, *(_D,) * 4, _I, _P),
    "rt_lb_collide": (_P, _P, _P, _L, _F, _F, _F, _F, _D, _D, _D, _I, _P),
    "rt_lb_propagate": (_P, _P, _I, _I, _I, _D, _D, _I, _P),
    "rt_lb_step": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _D, _D, _D, _D, _I, _P),
    "rt_lb_step_bf16": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _D, _D, _D, _D, _I, _P),
    "rt_lb_step_tiled": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, *(_D,) * 4, _I,
                         _P),
    "rt_lb_step_tiled_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                              *(_D,) * 4, _I, _P),
    "rt_ludwig_chem_stress": (_P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F, _F,
                              *(_D,) * 5, _I, _P),
    "rt_ludwig_lc_update": (_P, _P, _P, _P, _P, _L, _F, _F, _F, _F, *(_D,) * 5, _I, _P),
    "rt_ludwig_chem_stress_policy": (*(_P,) * 5, _L, *(_F,) * 7, _I, _I, _I, *(_D,) * 5, _I, _P),
    "rt_ludwig_lc_update_policy": (*(_P,) * 5, _L, *(_F,) * 4, _I, _I, _I, *(_D,) * 5, _I, _P),
    "rt_ludwig_lc_chain": (_P, _P, _P, _P, _P, _L, *(_F,) * 8, *(_D,) * 5, _I, _P),
    "rt_ludwig_fed": (_P, _P, _P, _L, _F, _F, _F, _F, _D, _D, _D, _I, _P),
    "rt_rwkv6_state": (*(_P,) * 6, *(_I,) * 6, *(_L,) * 6, _I, _P),
    "rt_rwkv6_output": (*(_P,) * 7, *(_I,) * 6, *(_L,) * 11, _I, _I, _P),
    "rt_flash": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *(_L,) * 12, _I, _I, _F, _P),
    "rt_flash_kvchunk": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *(_L,) * 12, _I, _I, _F, _I,
                         _P),
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA toolkit is needed to build the cuda engine's kernels")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs, sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    srcs, headers = _sources()
    for f in srcs + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run every command at once and wait for all; raise with the command
    line and output of each that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    them into one shared library, once per source hash; return its path."""
    digest = _digest()
    lib = BUILD_DIR / f"librepro_torch_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs, _ = _sources()
    tag = f"{digest}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in srcs]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        _run_all([[_nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(srcs, objs)])
        _run_all([[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, lib)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's argument and result types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    lib.rt_smem_per_block_optin.argtypes = [ctypes.c_int]
    lib.rt_smem_per_block_optin.restype = ctypes.c_int
    lib.rt_reduce_fold_scratch.argtypes = [_L, _I]
    lib.rt_reduce_fold_scratch.restype = ctypes.c_longlong
    lib.rt_reduce_fold_split_scratch.argtypes = [_L, _I, _I]
    lib.rt_reduce_fold_split_scratch.restype = ctypes.c_longlong
    chunk = csrc_define("reduce.cu", "RT_REDUCE_CHUNK")
    if lib.rt_reduce_chunk() != chunk:
        raise RuntimeError(f"{lib._name}: rt_reduce_chunk() is {lib.rt_reduce_chunk()}, "
                           f"reduce.cu defines {chunk}: a stale build")
    return lib


@functools.lru_cache(maxsize=None)
def csrc_define(source: str, name: str) -> int:
    """The integer a ``#define name <int>`` of ``csrc/<source>`` sets: the
    kernels' geometry constants, read by the Python code that must agree
    with them (partial-table sizes, the tree emulation) from the one place
    they are defined."""
    m = re.search(rf"^#define {name} (\d+)\b", (CSRC / source).read_text(), re.M)
    if m is None:
        raise RuntimeError(f"csrc/{source} defines no integer {name}")
    return int(m.group(1))


@functools.lru_cache(maxsize=None)
def smem_per_block_optin(device: torch.device) -> int:
    """The most shared memory one block may opt in to on ``device``
    (cudaDevAttrMaxSharedMemoryPerBlockOptin), in bytes."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    v = library().rt_smem_per_block_optin(index)
    if v < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute on {device} failed: CUDA error {-v}")
    return v


def check_tensor(name: str, t: torch.Tensor, shape, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> None:
    """Raise ValueError unless ``t`` is a contiguous tensor of ``dtype``
    (fp32 unless the operand's slot takes another) and ``shape`` on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}; this operand of the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


# the field dtypes K2 (csrc/reduce.cu) reduces; every other kernel takes fp32
# fields (bf16 ones where a policy instance says so)
REDUCE_DTYPES = (torch.float32, torch.int32, torch.bfloat16)


def reduce_dtype(name: str, t: torch.Tensor) -> torch.dtype:
    """The dtype of a field K2 is to reduce: fp32, int32 or bf16; raise
    ValueError for any other (no field is cast to reach a kernel)."""
    if t.dtype not in REDUCE_DTYPES:
        raise ValueError(f"{name}: dtype {t.dtype}; K2 reduces "
                         f"{', '.join(str(d) for d in REDUCE_DTYPES)} fields")
    return t.dtype


def check_field(name: str, t: torch.Tensor, layout, ncomp: int, nsites: int,
                device: torch.device, dtype: torch.dtype = torch.float32) -> int:
    """:func:`check_tensor` for a field of ``ncomp`` components over
    ``nsites`` sites stored in ``layout`` (shape
    ``layout.physical_shape(ncomp, nsites)``); returns the layout's
    descriptor for the kernel."""
    check_tensor(f"{name} ({layout.name})", t, layout.physical_shape(ncomp, nsites), device,
                 dtype)
    return layout.descriptor()


def check_typed_field(name: str, t: torch.Tensor, layout, ncomp: int, nsites: int,
                      device: torch.device) -> Tuple[int, bool]:
    """:func:`check_field` for an operand of a policy instance, which takes
    fp32 or bf16: (the layout's descriptor, whether ``t`` is bf16)."""
    dt = torch.bfloat16 if t.dtype == torch.bfloat16 else torch.float32
    return check_field(name, t, layout, ncomp, nsites, device, dt), dt == torch.bfloat16


def check_batched_field(name: str, t: torch.Tensor, layout, ncomp: int, nsites: int, batch: int,
                        device: torch.device, dtype: torch.dtype = torch.float32) -> int:
    """:func:`check_field` for ``batch`` such fields stacked on a leading
    axis (a BatchedField's data); returns the layout's descriptor."""
    check_tensor(f"{name} ({layout.name}, batch {batch})", t,
                 (batch,) + layout.physical_shape(ncomp, nsites), device, dtype)
    return layout.descriptor()


class Kernel:
    """One kernel of the library as the port's main path uses it.

    ``launches`` counts the launches of the C entry point ``symbol`` made
    through :meth:`launch` — a plain integer a run reads to show that its
    path went through the kernel."""

    def __init__(self, name: str, symbol: str):
        if symbol not in SIGNATURES:
            raise ValueError(f"unknown kernel entry point {symbol!r}")
        self.name = name
        self.symbol = symbol
        self.launches = 0

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise if the launch failed."""
        lib = library()
        rc = getattr(lib, self.symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: launch of {self.symbol} failed: CUDA error {rc} "
                f"({lib.rt_error_string(rc).decode()})")
        self.launches += 1

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"Kernel({self.name}, {self.symbol}, launches={self.launches})"
