"""The harness on the CPU: imports, metric arithmetic, refusal, finding by name.

Runs go through ``bench.run_cell`` with ``device="cpu"`` at tiny sizes (the
port's kernels run their plain versions there); the CLI itself refuses to
run without a card.
"""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import stats, trace
from portbench.metrics import idle_share, launches_per_step, megastep_ms, megastep_roofline, mfu
from portbench.metrics import policy_device_ms, rollout_ms_per_step, update_ms

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ACT = "dppo_pfpn35_walk.act_b8192"
TINY_ACT = {"num_envs": 6, "warmup_steps": 1, "check_steps": 1, "check_step_range": 1,
            "check_rows": 4, "trace_steps": 1}


def _python(code: str, cwd: str = ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_no_jax_loaded_and_reference_imports_nothing_of_the_port():
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
from portbench import bench
tr = json.load(open({ROOT!r} + "/portbench/traffic/act_b8192.json"))
tr.update({TINY_ACT!r})
res = bench.run_cell({ACT!r}, 2**31 + 3, 0.1, False, device="cpu", traffic=tr)
print(json.dumps({{"bad": bench.forbidden_modules(), "correct": res["correct"]}}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "correct": True}

    mods = [os.path.splitext(os.path.basename(p))[0]
            for p in glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py"))]
    code = ("import sys; sys.path.insert(0, %r)\n" % ROOT
            + "".join(f"import portbench.reference.{m}\n" for m in mods)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('pfpn_torch', 'pfpn_tpu', 'jax', 'jaxlib', 'flax', 'optax', 'orbax')))")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                assert not any(n.split(".")[0] in ("pfpn_torch", "pfpn_tpu", "jax")
                               for n in names), (path, names)


def test_metric_arithmetic_on_synthetic_events():
    # two steps: kernels [0, 10] and [5, 20] overlap, [30, 40] alone, a copy
    # [50, 60]; host events out to 100 us
    t = trace.synthetic(
        [("void megastep_kernel<false>(x)", 0.0, 10.0), ("gemm", 5.0, 20.0),
         ("void megastep_kernel<false>(x)", 30.0, 40.0), ("Memcpy HtoD", 50.0, 60.0)],
        host_ops=[("aten::stack", 0.0, 100.0), ("cudaLaunchKernel", 21.0, 29.0)],
        regions={"portbench.act": 30.0}, steps=2)
    assert t.window_us == 100.0
    assert t.busy_us == 20.0 + 10.0 + 10.0          # the union, not the sum 45
    assert stats.covered([(0, 10), (5, 20)]) == 20
    assert len(t.kernels) == 3
    gaps = t.breakdown()["idle_gaps"]
    assert gaps[0] == ["aten::stack", 40e-6] and ["cudaLaunchKernel", 10e-6] in gaps

    class Ctx:
        trace = t
        spans = {"rollout": [100.0, 140.0], "update": [10.0, 30.0]}
        window = {"seconds": 2.0, "flops": 67e12, "unroll": 4, "steps": 3}
        counts = {"megastep_flops_per_launch": 67e9 * 0.01 / 1e3,   # 0.01 ms at peak
                  "megastep_bytes_per_launch": 1.0}
        peaks = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}

    assert idle_share.read(Ctx) == pytest.approx(60.0)
    assert launches_per_step.read(Ctx) == 1.5
    assert megastep_ms.read(Ctx) == pytest.approx(0.010)
    assert megastep_roofline.read(Ctx) == pytest.approx(0.1)      # 0.01 us of 10 us
    assert mfu.read(Ctx) == pytest.approx(50.0)
    assert policy_device_ms.read(Ctx) == pytest.approx(0.015)
    assert rollout_ms_per_step.read(Ctx) == pytest.approx(30.0)
    assert update_ms.read(Ctx) == pytest.approx(20.0)

    Ctx.trace = None
    Ctx.spans = {}
    for r in (idle_share, launches_per_step, megastep_ms, megastep_roofline,
              policy_device_ms, rollout_ms_per_step, update_ms):
        assert r.read(Ctx) is None                     # nothing to read: no number

    ends = [10.0, 20.0, 35.0, 45.0]
    assert stats.intervals(ends) == [10.0, 10.0, 15.0, 10.0]
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


def test_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", ACT, "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A copy of the benchmark with a new traffic mix, a new per-layer
    metric, a new limits file and their entries in BENCHMARK.json, and no
    file of the benchmark edited, runs the new cell and reads the metric."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("pfpn_torch", "pfpn_tpu", "results"):
        os.symlink(os.path.join(ROOT, name), tmp_path / name)
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = "dppo_pfpn35_walk.act_b6"
    spec["workloads"].append({"name": cell, "config": "dppo_pfpn35_walk", "traffic": "act_b6",
                              "chips": 1, "why": "six envs"})
    spec["per_layer"].append({"name": "steps_in_window.act", "unit": "steps",
                              "better": "higher", "source": "host_clock", "layer": "harness",
                              "moves": "env_steps_per_s", "workloads": [cell]})
    for m in spec["end_to_end"]:
        if "workloads" in m and ACT in m["workloads"]:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "portbench" / "traffic" / "act_b6.json").write_text(
        json.dumps(dict(TINY_ACT, loop="act")))
    shutil.copy(os.path.join(ROOT, "portbench", "limits", f"{ACT}.json"),
                tmp_path / "portbench" / "limits" / f"{cell}.json")
    (tmp_path / "portbench" / "metrics" / "steps_in_window.act.py").write_text(
        "def read(ctx):\n    return float(ctx.window['steps'])\n")
    code = f"""
import json, sys
sys.path.insert(0, {str(tmp_path)!r})
from portbench import bench
res = bench.run_cell({cell!r}, 7, 0.1, True, device="cpu")
print(json.dumps(res["metrics"]))
"""
    out = _python(code, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["steps_in_window.act"]["value"] >= 1
    assert metrics["steps_in_window.act"]["unit"] == "steps"
