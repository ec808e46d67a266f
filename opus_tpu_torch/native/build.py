"""Build the port's plane-A engine: g++ -> a ctypes-loaded shared library.

Three translation units go into one library, as in the reference
(opus_tpu/native/build.py): the CELT engine celt_frontend.cpp (which
includes celt_tables.h, ec.h and celt_encoder.inc), the SILK engine
silk_frontend.cpp (silk_tables.h, silk_encoder.inc: the SILK decoder and
the voice and hybrid encoders) and the Opus layer opus_frontend.cpp, the
mixed-mode batch decode over both.  All seven files are byte-identical
copies of opus_tpu/native's (tests/test_torch_native.py).
The compiler flags and the probed -march=native / -fopenmp are the
reference's (opus_tpu/native/build.py).  The library goes to
opus_tpu_torch/_build/, named by a hash of the sources and the final
flags, so an edited source rebuilds and an unchanged one loads at once.
It is built for the machine that builds it (-march=native), so the hash
also covers the host CPU's feature flags.

The sanitizer lane builds the reference's instrumented variant
(`build(sanitize="address,undefined")`, or this script with
OPUS_TPU_SANITIZE set, as the reference's build.py reads it): -O1 -g
-fno-omit-frame-pointer -fsanitize=..., without -march=native and
-fopenmp so that the reports are clean, named libopusfe_san_<hash>.so.
The loader (frontend.py) loads it when OPUS_TPU_NATIVE_LIB names it:

    lib=$(OPUS_TPU_SANITIZE=address,undefined python opus_tpu_torch/native/build.py)
    LD_PRELOAD=$(g++ -print-file-name=libasan.so) ASAN_OPTIONS=detect_leaks=0 \
      OPUS_TPU_NATIVE_LIB=$lib python -m pytest tests/test_torch_native_sanitize.py
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
#: The translation units, then the files they include.
UNITS = ("celt_frontend.cpp", "silk_frontend.cpp", "opus_frontend.cpp")
SOURCES = UNITS + ("celt_tables.h", "ec.h", "celt_encoder.inc", "silk_tables.h",
                   "silk_encoder.inc")
_FLAGS = (
    # c++20: signed left-shift is defined (two's complement), as the
    # fixed-point planes assume.
    "-std=c++20", "-shared", "-fPIC",
    "-ffp-contract=fast", "-fno-fast-math", "-fno-math-errno",
)
_OPT = ("-O3", "-funroll-loops")
_SANITIZE_OPT = ("-O1", "-g", "-fno-omit-frame-pointer")


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


def build(sanitize: str = "") -> pathlib.Path:
    """Compile the three units unless a library for these sources, flags
    and host CPU exists; returns its path.  `sanitize`, a list for
    -fsanitize= (e.g. "address,undefined"), builds the instrumented
    variant instead."""
    cxx = os.environ.get("CXX", "g++")
    if sanitize:
        flags = [*_FLAGS, *_SANITIZE_OPT, f"-fsanitize={sanitize}"]
    else:
        flags = [*_FLAGS, *_OPT,
                 *[f for f in ("-march=native", "-fopenmp") if _flag_works(cxx, f)]]
    h = hashlib.sha256(" ".join([cxx, *flags, _host_cpu()]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    so = OUT / f"libopusfe{'_san' if sanitize else ''}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    OUT.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    # One g++ per unit, all started together, then one link.
    objs = [so.with_suffix(f".{os.getpid()}.{u}.o") for u in UNITS]
    cmds = [[cxx, *flags, "-c", "-o", str(o), str(HERE / u)] for u, o in zip(UNITS, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    link = [cxx, *flags, "-o", str(tmp), *map(str, objs)]
    try:
        for cmd, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"g++ failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ link failed ({res.returncode}):\n{' '.join(link)}\n"
                               f"{res.stdout}{res.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


if __name__ == "__main__":
    print(build(os.environ.get("OPUS_TPU_SANITIZE", "").strip()))
