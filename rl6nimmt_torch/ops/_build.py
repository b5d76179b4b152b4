"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Route: ``nvcc`` by hand into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Each
source compiles in its own ``nvcc`` process, all started together, then one
link step makes ``librl6kernels.so`` under ``rl6nimmt_torch/_build/<hash>/``
(listed in ``.gitignore``).  The hash covers the sources and the flags, so an
edited kernel is rebuilt.  Nothing is built at import time.

Every launcher returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.  :data:`LAUNCHES` counts the kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("step_kernel.cu", "game_kernel.cu", "act_rollout_kernel.cu", "act_insert_kernel.cu",
           "act_ablate_kernel.cu", "probe_ops.cu")
HEADERS = ("game.cuh", "act_play.cuh", "row_major_emit.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# Plain integer launch counters, one per kernel: K1-K5 (the main path), K6's
# three ablation variants and K7's seven probe bodies.
ABLATE_VARIANTS = ("env", "obs", "mm")      # in the order of rl6_act_ablate's variant codes 0-2
PROBES = tuple(f"k{i}" for i in range(1, 8))
LAUNCHES = {"resolve_turn": 0, "deal_games": 0, "play_random_games": 0, "act_rollout": 0,
            "act_insert": 0, **{f"act_ablate_{v}": 0 for v in ABLATE_VARIANTS},
            **{f"probe_{k}": 0 for k in PROBES}}

# Filled by the first build in this process: seconds, and ptxas lines per kernel.
BUILD_INFO: dict = {}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_I64 = ctypes.c_longlong
_F = ctypes.c_float

SIGNATURES = {
    "rl6_resolve_turn": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "rl6_deal_games": [_U64, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    "rl6_play_random_games": [_U64, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP],
    "rl6_act_rollout": [_U64, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP],
    "rl6_act_insert": [_U64, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I64, _I, _I, _F, _I, _I, _VP],
    "rl6_act_ablate": [_I, _U64, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP],
    "rl6_probe_k1": [_VP, _VP, _VP, _I, _I, _VP],
    "rl6_probe_k2": [_VP, _VP, _I, _I, _VP],
    "rl6_probe_k3": [_VP, _VP, _I, _I, _VP],
    "rl6_probe_k4": [_VP, _VP, _I, _VP],
    "rl6_probe_k5": [_VP, _VP, _I, _I, _VP],
    "rl6_probe_k6": [_VP, _VP, _VP, _I, _I, _VP],
    "rl6_probe_k7": [_VP, _VP, _VP, _VP, _I, _I, _VP],
    "rl6_play_games": [],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def _kernel_name(mangled: str) -> str:
    """The last component of a mangled nested name: ``_ZN<len><ns><len><name>E...``
    (the kernels sit in an anonymous namespace) gives ``<name>``."""
    rest, name = mangled[3:] if mangled.startswith("_ZN") else "", mangled
    while (m := re.match(r"\d+", rest)):
        n = int(m.group())
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    return name


def _parse_ptxas(text: str) -> dict:
    """``{kernel: "registers, spills"}`` from ``-Xptxas -v`` output."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = _kernel_name(m.group(1))
            continue
        if current and ("registers" in line or "spill" in line):
            out[current] = (out.get(current, "") + " " + line.split("ptxas info    :")[-1].strip()).strip()
    return out


def build() -> Path:
    """Compile the kernels (if not built yet for these sources) and return the .so path."""
    target = BUILD_ROOT / _digest() / "librl6kernels.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    t0 = time.perf_counter()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    procs = []
    for src in SOURCES:
        obj = tmp / (Path(src).stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs, ptxas = [], {}
    for src, obj, p in procs:
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{stdout}\n{stderr}")
        ptxas.update(_parse_ptxas(stderr + stdout))
        objs.append(str(obj))
    lib = tmp / "librl6kernels.so"
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(lib), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    target.parent.mkdir(parents=True, exist_ok=True)
    os.replace(lib, target)            # atomic: concurrent builds race safely
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, ptxas=ptxas)
    return target


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with cudaError {code}")


def stream_ptr(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
