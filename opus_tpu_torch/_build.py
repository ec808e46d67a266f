"""Build and load the package's CUDA kernels (csrc/*.cu).

At first use, nvcc compiles every source under csrc/ into one shared
library with a plain C interface, for sm_90a (Hopper).  The library goes
to _build/, named by a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one loads at once.  It is loaded with
ctypes; callers pass device pointers and the stream as c_void_p, through
`launch`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "csrc"
_OUT = _HERE / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
                       "of opus_tpu_torch cannot be built")


def build() -> pathlib.Path:
    """Compile csrc/*.cu unless a library for these sources exists.

    One nvcc per source, all started together, then one link; the
    compilers' resource report (-Xptxas=-v) is kept beside the library
    as <library>.log."""
    srcs = sorted(_SRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = _OUT / f"libopus_tpu_torch_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    _OUT.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [_OUT / f"{src.stem}.{tag}.o" for src in srcs]
    cmds = [[nvcc, *_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{log}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    for o in objs:
        o.unlink()
    so.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each entry point's argument types (every one returns a cudaError_t as int)
SIGNATURES = {
    "opus_postfilter": [_P, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _I, _I, _I, _I, _I,
                        _I, _P],
    "opus_rot_pass": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "opus_pitch_track": [_P, _LL, _P, _LL, _LL, _I, _I, _I, _P, _P, _P],
    "opus_lpc_synth": [_P, _P, _P, _P, _I, _I, _P],
    "opus_silk_synth": [_P] * 10 + [_I] * 6 + [_P],
    "opus_pvq_search": [_P] * 6 + [_I] * 12 + [_P],
    "opus_band_walk": [_P] * 5 + [_LL] + [_P] * 12 + [_I, _I, _P],
}


def bind(lib: ctypes.CDLL, entries=SIGNATURES) -> ctypes.CDLL:
    """Set the signature of each of `entries` on lib (a build of some or
    all of the sources that defines them)."""
    for name in entries:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = _I, SIGNATURES[name]
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's signature set."""
    return bind(ctypes.CDLL(str(build())))


def launch(entry: str, device: torch.device, args: tuple) -> None:
    """Call the library's `entry` with `args` (device pointers and plain
    values) and the device's current stream; raise if the launch failed."""
    with torch.cuda.device(device):
        rc = getattr(library(), entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
