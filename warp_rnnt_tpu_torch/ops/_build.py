"""Build the CUDA sources in `warp_rnnt_tpu_torch/csrc/` on first use.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library with a
plain C interface and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

No PyTorch headers are included, so a source compiles in seconds.  The file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  ptxas's report of each
kernel's registers, shared memory and spills is kept beside the library
(`<name>-<hash>.ptxas.txt`, read by `ptxas_report`).  Outputs go to
`warp_rnnt_tpu_torch/build/` (git-ignored).  Libraries are written under a
temporary name and renamed into place, so processes that build at once do
not see a half-written file.  A failed `nvcc` raises with its stderr; there
is no fallback.

Beside the build, the launch helpers the kernel wrappers share: the raw
current stream, a call on a given device (`on_device`), the route by a
tensor's device (`on_cpu`), the element stride of a lattice plane
(`elem_stride`) and the check of a returned CUDA error code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("lattice", "flat_write", "fused_joint", "packed", "gather",
           "decode_step", "device_loop")
# Built on demand beside SOURCES, never loaded by the package itself: the
# decode step's first kernels, the yardstick its benchmarks time in turns.
YARDSTICKS = ("decode_step_baseline",)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA"
            " kernels of warp_rnnt_tpu_torch cannot be built"
        )
    return found


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha1()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (final_path, tmp_path, Popen) or None when nothing is to be built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return out, tmp, proc


def _finish(name: str, job) -> None:
    out, tmp, proc = job
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{stdout}{stderr}"
        )
    with open(_report_path(out), "w") as f:
        f.write(stderr)
    os.replace(tmp, out)


def _report_path(lib_path: str) -> str:
    return lib_path[:-len(".so")] + ".ptxas.txt"


def ptxas_report(name: str) -> dict:
    """{kernel: {"registers", "smem_bytes", "spill_stores", "spill_loads",
    "stack_bytes"}} from ptxas's report of the current build of
    `csrc/<name>.cu` (built if missing); kernel names as ptxas prints
    them (mangled), each entry function of the library."""
    import re

    build_all((name,))
    with open(_report_path(_lib_path(name))) as f:
        text = f.read()
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                      r" (\d+) bytes spill loads", line)
        if m:
            out[fn].update(stack_bytes=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?"
                      r"(?:, (\d+) bytes smem)?", line)
        if m:
            out[fn].update(registers=int(m.group(1)),
                           smem_bytes=int(m.group(2) or 0))
    return out


def build_all(names=SOURCES) -> None:
    """Compile every source that has no current library, one nvcc per
    source, all started together."""
    jobs = {name: _start(name) for name in names}
    errors = []
    for name, job in jobs.items():
        if job is None:
            continue
        try:
            _finish(name, job)
        except RuntimeError as e:  # wait for every nvcc before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib


# The current stream's handle and the current device, read without
# building Python objects (absent from CPU-only builds, which never launch).
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_current_device = getattr(torch._C, "_cuda_getDevice", None)


def on_cpu(x) -> bool:
    """True for a CPU tensor (a wrapper runs its plain version), False for a
    CUDA tensor (it launches its kernel); any other device raises."""
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"unsupported device {x.device}")


def on_device(dev: int, fn, args):
    """``fn(args)`` with CUDA device ``dev`` current, the device context
    entered only when another device is current (a launch entry taking one
    packed argument block)."""
    if dev == _current_device():
        return fn(args)
    with torch.cuda.device(dev):
        return fn(args)


def elem_stride(x, name=None):
    """The element stride s of an (N, T, U) tensor that holds every s-th
    element of one contiguous run: 1 for a contiguous plane, 2 for one
    channel of a contiguous (N, T, U, 2) tensor (``lat[..., 0]``), which a
    kernel then reads or writes in place.  Any other layout raises, naming
    the tensor ``name``, or gives None where no name is given."""
    for s in (1, 2) if x.dim() == 3 else ():
        want = (s * x.shape[1] * x.shape[2], s * x.shape[2], s)
        if all(n == 1 or st == w
               for n, st, w in zip(x.shape, x.stride(), want)):
            return s
    if name is None:
        return None
    raise ValueError(f"{name} must be contiguous or one channel of a"
                     f" contiguous (N, T, U, 2) tensor, got strides"
                     f" {x.stride()} at shape {tuple(x.shape)}")


def check(lib: ctypes.CDLL, err_fn: str, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = getattr(lib, err_fn)(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
