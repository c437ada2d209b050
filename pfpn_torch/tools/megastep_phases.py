"""Where a megastep block spends its time, phase by phase, on the card.

    python -m pfpn_torch.tools.megastep_phases [--batch 8 8192] [--threads 128]

Builds an instrumented copy of ``csrc/megastep.cu`` into ``build/`` in which
thread 0 of block 0 records ``clock64()`` after every ``BL_SYNC()`` barrier,
runs one control step of the default variant from reset states, and prints
the SM cycles between consecutive barriers summed by the stage of the
source they close (the ``// ====`` section of ``megastep.cu`` the barrier
is in; ``gj_sweep_pair`` for the Gauss-Jordan sweeps of
``block_linalg.cuh``), with the share of the block's time and the card's
name and power limit, as one JSON line per batch size. The recording adds
a few shared-memory and global stores per barrier to thread 0's work. At
B = 8192 block 0 shares its SM with other blocks, so its phases include
their contention.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess

SLOTS = 16384   # barriers recorded per launch

_DECL = r"""#include <cuda_runtime.h>
__device__ long long ms_prof_clk[%d];
__device__ int ms_prof_line[%d];
__device__ int ms_prof_n;
__device__ __forceinline__ int& ms_prof_k() { __shared__ int k; return k; }
""" % (SLOTS, SLOTS)

_SYNC = (r"#define BL_SYNC() do { __syncthreads(); if (blockIdx.x == 0 && "
         r"threadIdx.x == 0) { int k_ = ms_prof_k(); if (k_ < %d) { "
         r"ms_prof_clk[k_] = clock64(); ms_prof_line[k_] = __LINE__ + MS_LINE_BASE; "
         r"ms_prof_n = k_ + 1; } ms_prof_k() = k_ + 1; } } while (0)" % SLOTS)

_READ = r"""
extern "C" int ms_prof_read(long long* clk, int* line) {
  int n = 0;
  cudaMemcpyFromSymbol(&n, ms_prof_n, sizeof(int));
  if (n > %d) n = %d;
  cudaMemcpyFromSymbol(clk, ms_prof_clk, sizeof(long long) * n);
  cudaMemcpyFromSymbol(line, ms_prof_line, sizeof(int) * n);
  return n;
}
""" % (SLOTS, SLOTS)

HEADER_LINES = 100000   # lines of block_linalg.cuh are reported from here


def _instrument(csrc: str, out_dir: str):
    """Write the instrumented megastep.cu and block_linalg.cuh into out_dir;
    returns (path of the .cu, stage label of each source line)."""
    src = open(os.path.join(csrc, "megastep.cu")).read()
    hdr = open(os.path.join(csrc, "block_linalg.cuh")).read()
    # stage labels from the megastep source's "// ====" section comments
    labels, stage = {}, "setup"
    for no, line in enumerate(src.splitlines(), 1):
        m = re.match(r"\s*// =+ (.*?) =+\s*$", line)
        if m:
            stage = m.group(1)
        labels[no] = stage
    for no, line in enumerate(hdr.splitlines(), 1):
        labels[HEADER_LINES + no] = "gj_sweep_pair (block_linalg.cuh)"
    # the line numbers must survive the edits: each edit keeps its line count
    plain = "#if defined(__CUDA_ARCH__)\n#define BL_SYNC() __syncthreads()\n"
    if plain not in src or '#include "block_linalg.cuh"' not in src:
        raise RuntimeError("megastep.cu no longer has the lines this tool instruments")
    src = src.replace(plain, "#if defined(__CUDA_ARCH__)\n#define MS_LINE_BASE 0\n", 1)
    src = src.replace('#include "block_linalg.cuh"',
                      '#include "block_linalg_phases.cuh"', 1)
    init = "  __syncthreads();\n  const size_t env = blockIdx.x;"
    if init not in src:
        raise RuntimeError("megastep.cu no longer has the kernel prologue this tool instruments")
    src = src.replace(init, "  if (threadIdx.x == 0) ms_prof_k() = 0;\n" + init, 1)
    # the header: its own BL_SYNC() lines, reported past HEADER_LINES
    hdr = hdr.replace("#pragma once", "#pragma once\n#undef MS_LINE_BASE\n#define MS_LINE_BASE %d"
                      % (HEADER_LINES - 2), 1)
    hdr += "\n#undef MS_LINE_BASE\n#define MS_LINE_BASE 0\n"
    prelude = _DECL + "#ifdef __CUDA_ARCH__\n" + _SYNC + "\n#endif\n"
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "block_linalg_phases.cuh"), "w") as fh:
        fh.write(hdr)
    cu = os.path.join(out_dir, "megastep_phases.cu")
    with open(cu, "w") as fh:
        fh.write(prelude + "#line 1\n" + src + _READ)
    return cu, labels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 8192])
    ap.add_argument("--threads", type=int, default=0, help="0: the source's default")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("megastep_phases: no CUDA card")
    from ..envs.deepmimic import make
    from ..ops import _build
    from ..ops import megastep as ms

    out_dir = os.path.join(_build.BUILD_DIR, "megastep_phases")
    cu, labels = _instrument(_build.CSRC, out_dir)
    lib_path = os.path.join(out_dir, "libpfpn_megastep_phases.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, cu, "-o", lib_path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"megastep_phases: nvcc failed\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    ms._declare(lib, False)
    lib.ms_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ms_prof_read.restype = ctypes.c_int
    ms.LIBRARY._libs[False] = lib          # the wrapper launches the instrumented build
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    env = make("DeepMimicWalk-v0", device=dev)
    mega, meta = env.engine.mega, env.engine.meta
    threads = args.threads or lib.pfpn_megastep_default_threads()
    clk = (ctypes.c_longlong * SLOTS)()
    line = (ctypes.c_int * SLOTS)()
    for B in args.batch:
        g = torch.Generator(device=dev).manual_seed(5)
        st = ms.pack_state(meta, env.reset_batch(B, g)[0].sim).contiguous()
        ts = torch.zeros(B, meta.n_sph, 4, device=dev)
        ts[..., 3] = 1.0
        ts = ts.reshape(B, -1)
        tr = torch.zeros(B, meta.n_rev, device=dev)
        mega.kernel(st, ts, tr, threads=threads)      # warm-up
        torch.cuda.synchronize()
        mega.kernel(st, ts, tr, threads=threads)
        torch.cuda.synchronize()
        n = lib.ms_prof_read(clk, line)
        cycles, count = collections.Counter(), collections.Counter()
        for k in range(1, n):
            stage = labels.get(line[k], "?")
            cycles[stage] += clk[k] - clk[k - 1]
            count[stage] += 1
        total = clk[n - 1] - clk[0]
        stages = [{"stage": s, "barriers": count[s], "cycles": c, "share": c / total}
                  for s, c in cycles.most_common()]
        print(json.dumps({"card": card, "batch": B, "threads": threads, "barriers": n,
                          "cycles": total, "cycles_per_substep": total / meta.frame_skip,
                          "stages": stages}))


if __name__ == "__main__":
    main()
