"""Build the port's plane-A engine: g++ -> a ctypes-loaded shared library.

The CELT engine is one translation unit, celt_frontend.cpp, which
includes celt_tables.h, ec.h and celt_encoder.inc; the four are
byte-identical copies of opus_tpu/native's (tests/test_torch_native.py).
The compiler flags and the probed -march=native / -fopenmp are the
reference's (opus_tpu/native/build.py).  The library goes to
opus_tpu_torch/_build/, named by a hash of the sources and the final
flags, so an edited source rebuilds and an unchanged one loads at once.
It is built for the machine that builds it (-march=native), so the hash
also covers the host CPU's feature flags.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import platform
import subprocess
import tempfile

HERE = pathlib.Path(__file__).parent
OUT = HERE.parent / "_build"
SOURCES = ("celt_frontend.cpp", "celt_tables.h", "ec.h", "celt_encoder.inc")
_FLAGS = (
    # c++20: signed left-shift is defined (two's complement), as the
    # fixed-point planes assume.
    "-std=c++20", "-shared", "-fPIC",
    "-ffp-contract=fast", "-fno-fast-math", "-fno-math-errno",
    "-O3", "-funroll-loops",
)


def _flag_works(cxx: str, flag: str) -> bool:
    with tempfile.TemporaryDirectory() as td:
        src = pathlib.Path(td) / "probe.cpp"
        src.write_text("int main(){return 0;}\n")
        r = subprocess.run(
            [cxx, flag, "-o", str(pathlib.Path(td) / "probe"), str(src)],
            capture_output=True,
        )
        return r.returncode == 0


def _host_cpu() -> str:
    """The CPU's flags line (what -march=native compiles for), so that a
    library built on another machine is never loaded here."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return platform.processor()


def build() -> pathlib.Path:
    """Compile celt_frontend.cpp unless a library for these sources, flags
    and host CPU exists; returns its path."""
    cxx = os.environ.get("CXX", "g++")
    flags = list(_FLAGS) + [f for f in ("-march=native", "-fopenmp") if _flag_works(cxx, f)]
    h = hashlib.sha256(" ".join([cxx, *flags, _host_cpu()]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    so = OUT / f"libceltfe_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    OUT.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *flags, "-o", str(tmp), str(HERE / "celt_frontend.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


if __name__ == "__main__":
    print(build())
