"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Route: ``nvcc`` by hand into one shared library with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Each
source compiles in its own ``nvcc`` process, all started together, then one
link step makes ``librl6kernels.so`` under ``rl6nimmt_torch/_build/<hash>/``
(listed in ``.gitignore``).  The hash covers the sources and the flags, so an
edited kernel is rebuilt.  Nothing is built at import time.

Launch route: each wrapper holds a :class:`Launcher` per C entry.  Its
first call builds and loads the library and binds the entry; every call then
passes the raw handle of PyTorch's current stream on the tensors' card
(``torch._C._cuda_getCurrentRawStream``, so ``torch.cuda.stream(s)`` is
honoured without building a ``torch.cuda.Stream`` object), raises on the
``cudaGetLastError()`` code the entry returns, and adds one to
:data:`LAUNCHES`, the launch count per wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
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
           "act_ablate_kernel.cu", "probe_ops.cu", "policy_mlp.cu")
HEADERS = ("game.cuh", "random_play.cuh", "act_play.cuh", "row_major_emit.cuh", "feature_major_emit.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# Plain integer launch counters, one per kernel: K1 in its two layouts, K2, K3,
# K4 in its two layouts and K5 (the main path), K6's three ablation variants, K7's seven probe bodies
# and the action-in-input policy's forward.
ABLATE_VARIANTS = ("env", "obs", "mm")      # in the order of rl6_act_ablate's variant codes 0-2
PROBES = tuple(f"k{i}" for i in range(1, 8))
LAUNCHES = {"resolve_turn": 0, "resolve_turn_t": 0, "deal_games": 0, "play_random_games": 0, "act_rollout": 0,
            "act_rollout_fm": 0, "act_insert": 0, **{f"act_ablate_{v}": 0 for v in ABLATE_VARIANTS},
            **{f"probe_{k}": 0 for k in PROBES}, "policy_mlp": 0}

# Filled by the first build() in this process: seconds of nvcc when it compiled,
# and ptxas lines per kernel (kept beside the library in ptxas.json).
BUILD_INFO: dict = {}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_I64 = ctypes.c_longlong
_F = ctypes.c_float

SIGNATURES = {
    "rl6_resolve_turn": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "rl6_resolve_turn_t": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "rl6_resolve_games": [],
    "rl6_resolve_threads": [],
    "rl6_game_games": [],
    "rl6_game_threads": [],
    "rl6_deal_games": [_U64, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    "rl6_play_random_games": [_U64, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP],
    "rl6_act_rollout": [_U64, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                        _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP],
    "rl6_act_rollout_fm": [_U64, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
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
    "rl6_policy_mlp": [_VP, _VP, _I64, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _F, _VP, _VP, _VP, _VP],
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
    (the kernels sit in an anonymous namespace) gives ``<name>``, and a
    template instance ``<name>I<args>E`` gives ``<name><a,b,...>``."""
    rest, name = mangled[3:] if mangled.startswith("_ZN") else "", mangled
    while (m := re.match(r"\d+", rest)):
        n = int(m.group())
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    if (t := re.match(r"I((?:L[a-z]+n?\d+E)+)E", rest)):
        name += "<" + ",".join(re.findall(r"L[a-z]+(n?\d+)E", t.group(1))) + ">"
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
    """Compile the kernels (if not built yet for these sources) and return the .so
    path.  Either way ``BUILD_INFO["ptxas"]`` holds the build's ptxas lines."""
    target = BUILD_ROOT / _digest() / "librl6kernels.so"
    info = target.with_name("ptxas.json")
    if target.exists() and info.exists():
        BUILD_INFO.setdefault("ptxas", json.loads(info.read_text()))
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
    (tmp / "ptxas.json").write_text(json.dumps(ptxas, indent=1, sort_keys=True))
    target.parent.mkdir(parents=True, exist_ok=True)
    os.replace(tmp / "ptxas.json", info)   # atomic, and before the library: concurrent builds race safely
    os.replace(lib, target)
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


def stream_reader():
    """``device_index -> raw cudaStream_t`` of PyTorch's current stream there.

    The handle without a ``torch.cuda.Stream`` object, which
    ``torch.cuda.current_stream(i).cuda_stream`` builds on every call; the
    same function torch's compiled kernels read their stream with."""
    import torch

    return torch._C._cuda_getCurrentRawStream


class Launcher:
    """One C entry of the library, bound on the first call.

    ``launcher(device_index, *args)`` calls the entry with ``args`` and the
    current stream of card ``device_index``, raises ``RuntimeError`` if the
    launch failed, and counts it in ``LAUNCHES[counter]``.
    """

    __slots__ = ("entry", "counter", "fn", "stream")

    def __init__(self, entry: str, counter: str):
        self.entry, self.counter, self.fn, self.stream = entry, counter, None, None

    def __call__(self, device_index: int, *args) -> None:
        if self.fn is None:
            self.fn, self.stream = getattr(library(), self.entry), stream_reader()
        code = self.fn(*args, self.stream(device_index))
        if code:
            raise RuntimeError(f"CUDA launch of {self.counter} failed with cudaError {code}")
        LAUNCHES[self.counter] += 1
