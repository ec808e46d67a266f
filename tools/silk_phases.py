"""Where the SILK synthesis kernel spends its time, on one NVIDIA GPU.

    python3 tools/silk_phases.py [--against OTHER/silk.cu]

Builds copies of opus_tpu_torch/csrc/silk.cu (nvcc, sm_90a, into the
gitignored opus_tpu_torch/_build/silk_phases/): the source as it is, and
the source with a clock64() mark after each phase, read by the first
thread of block 0 (row 0: voiced, at lag chunk + 2).  With --against, a
second silk.cu with the same C entry (an earlier commit's, unpacked with
`git archive`) is built beside it and timed in turns with the source
(other, source, source, other).  On chip_smoke.py's synthetic rows
(`silk_inputs`: 1,024 rows at 8, 12 and 16 kHz, pole pairs at radius 0.995
and 0.999) it prints, beside the card's name, power limit and top SM
clock:

* each copy's device time per launch, from a CUDA graph of 40 launches
  cycling through 16 copies of the inputs (beyond the 50 MB L2), and its
  largest error against the plain version run in float64, of each row's
  peak;
* the cycles between the marks of row 0: copies issued, H pass, wait for
  the copies, LTP, zero-history pass, carry, second filter (from the
  carried history) and write-back.

A mark whose anchor no longer matches the source fails the run.  Needs a
CUDA device and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: (anchor in silk.cu, the mark goes before or after it); mark k is the k-th.
MARKS = [
    ("  if (row >= rows) return;  // the whole warp leaves together\n", "after"),
    ("  if (ly.count > 1) {\n    // H: lane j", "before"),
    ("  copy_wait();\n", "before"),
    ("  // LTP: one chunk a step", "before"),
    ("  // z: each lane its chunk", "before"),
    ("    // The carry:", "before"),
    ("  // Every chunk filtered again", "before"),
    ("  float* out = xq", "before"),
    ("}\n\ntemplate <int ORDER>\nint launch(", "before"),
]
PHASES = ["copies issued", "H pass", "wait for the copies", "LTP", "zero-history pass", "carry",
          "second filter", "write-back"]


def marked(src: str) -> str:
    """The source with a clock64() mark at each anchor of MARKS."""
    for k, (anchor, where) in enumerate(MARKS):
        if src.count(anchor) != 1:
            raise RuntimeError(f"mark {k}: its anchor is not in silk.cu once: {anchor!r}")
        mark = f"  PHASE({k})\n"
        src = src.replace(anchor, anchor + mark if where == "after" else mark + anchor)
    src = src.replace(
        "#include <cuda_runtime.h>\n",
        "#include <cuda_runtime.h>\n__device__ long long g_phase[16];\n"
        "#define PHASE(k) if (blockIdx.x == 0 && threadIdx.x == 0) g_phase[k] = clock64();\n", 1)
    return src + ('\nextern "C" int read_phases(long long* out) {\n'
                  "  return cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n")


def build(srcs: dict) -> dict:
    """name -> the loaded library of each copy, built by parallel nvccs."""
    from opus_tpu_torch import _build

    out = ROOT / "opus_tpu_torch" / "_build" / "silk_phases"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        stem = out / name.replace(" ", "_")
        stem.with_suffix(".cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        lib = ctypes.CDLL(str((out / name.replace(" ", "_")).with_suffix(".so")))
        lib.opus_silk_synth.restype = ctypes.c_int
        lib.opus_silk_synth.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", type=pathlib.Path,
                        help="another silk.cu to time in turns with the source")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("silk_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from opus_tpu_torch.dsp import silk_synthesis as ss

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    src = (ROOT / "opus_tpu_torch" / "csrc" / "silk.cu").read_text()
    srcs = {"source": src, "marked": marked(src)}
    if opts.against:
        srcs["against"] = opts.against.read_text()
    libs = build(srcs)
    order_of_runs = ["against", "source", "source", "against"] if opts.against else ["source"]
    dev = torch.device("cuda")
    for fs_khz, chunk, order in cs.SILK_RATES:
        args, kw = cs.silk_inputs(fs_khz, chunk, order, cs.B, 50 + fs_khz, dev)
        f64, _ = ss._silk_synth_ref(*[a.double() if a.is_floating_point() else a for a in args],
                                    **kw)
        peak = f64.abs().amax(dim=1)
        sets = [[a.clone() for a in args] + [torch.empty_like(args[0]), torch.empty_like(args[7])]
                for _ in range(16)]
        prepared = [ss._kernel_args(*a, **kw) for a in sets]
        times, errs = {}, {}
        for name in order_of_runs:
            times.setdefault(name, []).append(cs.graph_ms(libs[name].opus_silk_synth, prepared))
            torch.cuda.synchronize()
            errs[name] = float(((sets[0][8].double() - f64).abs().amax(dim=1) / peak).max())
        lib = libs["marked"]
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):
            if lib.opus_silk_synth(*prepared[0], stream) != 0:
                raise RuntimeError("the marked copy failed to launch")
        torch.cuda.synchronize()
        marks = (ctypes.c_longlong * 16)()
        if lib.read_phases(marks) != 0:
            raise RuntimeError("reading the marks failed")
        cycles = {p: marks[k + 1] - marks[k] for k, p in enumerate(PHASES)}
        print(f"silk_synth {fs_khz} kHz rows={cs.B} order={order}: device ms/launch (CUDA graph) "
              f"{times}; max err of row peak vs float64 {errs}; row 0 cycles by phase {cycles}, "
              f"total {marks[len(PHASES)] - marks[0]} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
