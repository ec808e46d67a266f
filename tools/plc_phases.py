"""Where the concealment's two scan kernels spend their time, on one NVIDIA GPU.

    python3 tools/plc_phases.py

Builds three copies of opus_tpu_torch/csrc/plc.cu (nvcc, sm_90a, into the
gitignored opus_tpu_torch/_build/plc_phases/): the source as it is; the
source with a clock64() mark after each phase of each kernel, read by the
first thread of block 0 (row 0); and the source with the synthesis's
homogeneous responses H computed in float instead of double.  On random
inputs at the concealment's shapes (pitch_track: 128 rows, the fine search
of 310 lags over length 664 and the coarse one of 155 lags over length 332
at stride 2; lpc_synth: 256 and 2,048 rows of 1,080 samples), it prints
beside the card's name, power limit and SM clock:

* each kernel's device time per launch, from a CUDA graph of 40 launches
  (no host launch cost between them), for the source and for float H;
* the cycles between the marks of row 0: pitch_track's staging, energy
  sum and steps, and lag walk; lpc_synth's copies issued and H pass, the
  wait for the copies, zero-state pass, carry, fix-up and write-back.

A mark that no longer matches the source fails the run.  Needs a CUDA
device and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: (anchor in plc.cu, mark index, the mark goes before or after it)
MARKS = [
    ("  float* dl = num + round4(n_lags);\n", 0, "after"),
    ("#pragma unroll\n  for (int k = kWarp / 2; k > 0; k /= 2) part", 1, "before"),
    ("  if (lane != 0) return;", 2, "before"),
    ("  bp0_out[r] = bp0;", 3, "before"),
    ("  const int lane_q = lane >= L ? 1 : 0, lane_p = lane - lane_q * L;"
     "  // sample `lane`'s place\n", 8, "after"),
    ("  copy_wait();", 9, "before"),
    ("  // z: each lane its chunk", 10, "before"),
    ("    // The carry:", 11, "before"),
    ("    // The fix-up,", 12, "before"),
    ("  __syncwarp();\n  for (int t0 = lane, q = lane_q", 13, "before"),
    ("}\n\n}  // namespace", 14, "before"),
]
PHASES = {"opus_pitch_track": ([0, 1, 2, 3], ["staging", "energy sum and steps", "lag walk"]),
          "opus_lpc_synth": ([8, 9, 10, 11, 12, 13, 14],
                             ["copies issued and H pass", "wait for the copies",
                              "zero-state pass", "carry", "fix-up", "write-back"])}


def sources(src: str) -> dict:
    """name -> the source of each copy."""
    marked = src
    for anchor, k, where in MARKS:
        if marked.count(anchor) != 1:
            raise RuntimeError(f"mark {k}: its anchor is not in plc.cu once: {anchor!r}")
        mark = f"  PHASE({k})\n"
        marked = marked.replace(anchor, anchor + mark if where == "after" else mark + anchor)
    marked = marked.replace(
        "#include <cuda_runtime.h>\n",
        "#include <cuda_runtime.h>\n__device__ long long g_phase[16];\n"
        "#define PHASE(k) if (blockIdx.x == 0 && threadIdx.x == 0) g_phase[k] = clock64();\n", 1)
    marked += ('\nextern "C" int read_phases(long long* out) {\n'
               "  return cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n")
    start = src.find("    const double aj = ")
    end = src.find("  copy_wait();", start)
    if start < 0 or end < 0:
        raise RuntimeError("the H pass is not in plc.cu as expected")
    h_pass = src[start:end].replace("double", "float").replace("fma(", "fmaf(")
    h_float = src[:start] + h_pass + src[end:]
    return {"source": src, "marked": marked, "float H": h_float}


def build(srcs: dict) -> dict:
    """name -> the loaded library of each copy, built by parallel nvccs."""
    from opus_tpu_torch import _build

    out = ROOT / "opus_tpu_torch" / "_build" / "plc_phases"
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
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        lib = ctypes.CDLL(str((out / name.replace(" ", "_")).with_suffix(".so")))
        lib.opus_pitch_track.restype = i
        lib.opus_pitch_track.argtypes = [p, ll, p, ll, ll, i, i, i, p, p, p]
        lib.opus_lpc_synth.restype = i
        lib.opus_lpc_synth.argtypes = [p, p, p, p, i, i, p]
        libs[name] = lib
    return libs


def graph_ms(fn, args, n: int = 40) -> float:
    """Device ms per launch: the best of 5 replays of a CUDA graph of n
    launches of fn on prepared C arguments."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        if fn(*args, stream.cuda_stream) != 0:
            raise RuntimeError("launch failed")
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(n):
                fn(*args, torch.cuda.current_stream().cuda_stream)
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def main() -> int:
    if not torch.cuda.is_available():
        print("plc_phases: no CUDA device", file=sys.stderr)
        return 2
    from opus_tpu_torch.dsp import plc_scan

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    libs = build(sources((ROOT / "opus_tpu_torch" / "csrc" / "plc.cu").read_text()))
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def rand(shape, scale):
        return torch.tensor((rng.standard_normal(shape) * scale).astype(np.float32), device=dev)

    y, xc_fine, xc_coarse = rand((128, 1024), 3e4), rand((128, 310), 1e12), rand((128, 155), 1e12)
    bp = torch.empty(2, 128, dtype=torch.int32, device=dev)
    synth = {rows: [rand((rows, 1080), 1.0), rand((rows, 24), 0.03), rand((rows, 24), 1.0)]
             for rows in (256, 2048)}
    outs = {rows: torch.empty_like(args[0]) for rows, args in synth.items()}
    cases = {
        "pitch_track fine, 128 rows": ("opus_pitch_track", plc_scan._pitch_kernel_args(
            xc_fine, y, 664, 310, bp[0], bp[1])),
        "pitch_track coarse (stride 2), 128 rows": ("opus_pitch_track", plc_scan._pitch_kernel_args(
            xc_coarse, y[:, ::2], 332, 155, bp[0], bp[1])),
        **{f"lpc_synth {rows} rows": ("opus_lpc_synth",
                                      plc_scan._synth_kernel_args(*synth[rows], outs[rows]))
           for rows in (256, 2048)},
    }
    for label, (entry, args) in cases.items():
        times = {name: graph_ms(getattr(libs[name], entry), args) for name in ("source", "float H")}
        lib = libs["marked"]
        for _ in range(3):
            getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        marks = (ctypes.c_longlong * 16)()
        if lib.read_phases(marks) != 0:
            raise RuntimeError("reading the marks failed")
        idx, names = PHASES[entry]
        cycles = {n: marks[b] - marks[a] for n, a, b in zip(names, idx, idx[1:])}
        print(f"{label}: device ms/launch {times['source']} (float H: {times['float H']}); "
              f"row 0 cycles by phase {cycles} ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
