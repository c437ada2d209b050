"""Run one cell of the port's benchmark once; see ``portbench/bench.py``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Kernel and compiler caches go to fixed
directories inside the checkout (``build/``), so only the first run of a
cell in a checkout builds.
"""

import os
import sys
import time


def process_start() -> float:
    """Wall-clock time this process started, from /proc (10 ms ticks);
    the time now where /proc cannot say."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(BUILD, "cuda_cache")
os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.bench import main

    sys.exit(main(sys.argv[1:], T_START))
