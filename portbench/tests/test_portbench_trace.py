"""``trace.from_profiler`` against the profiler's own event list, on a card.

``from_profiler`` reads the profiler's raw events (``kineto_results``) and
assigns kernels to ``record_function`` regions itself, because building
``prof.events()`` takes minutes for a traced training round. These tests
trace a short stretch of each loop as a run traces it and hold what the
reader finds equal to what ``prof.events()`` gives on the same profile: the
device events with their names and times, the busy time, the window and
each region's device time. They skip without a card: the device events
exist only there.
"""

import json
import os

import pytest

from portbench import bench, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _traffic(name, **kw):
    with open(os.path.join(ROOT, "portbench", "traffic", f"{name}.json")) as fh:
        return dict(json.load(fh), **kw)


def _from_events(prof, steps):
    """The :class:`trace.Trace` that ``prof.events()`` gives: each event
    as listed there, a region's device time its ``device_time_total``."""
    from torch.autograd import DeviceType

    device_ops, host_ops, regions = [], [], {}
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(trace.REGION_PREFIX) or getattr(e, "is_user_annotation",
                                                                 False):
                continue
            device_ops.append(span)
        else:
            host_ops.append(span)
            if e.name.startswith(trace.REGION_PREFIX):
                regions[e.name] = regions.get(e.name, 0.0) + float(e.device_time_total)
    return trace.Trace(device_ops, host_ops, regions, steps)


@pytest.mark.card
@pytest.mark.parametrize("cell,traffic", [
    ("dppo_pfpn35_walk.act_b8192", _traffic("act_b8192", num_envs=1024, check_step_range=8,
                                            trace_steps=4)),
    ("a3c_pfpn35_walk.train_b8192", _traffic("train_b8192", env_multiplier=16,
                                             unroll_length=8)),
    ("dppo_pfpn35_walk.train_b8", _traffic("train_b8", unroll_length=32, minibatch_size=64))])
def test_reader_matches_profiler_events(cuda_card, cell, traffic, monkeypatch):
    seen = []
    read = trace.from_profiler

    def spy(prof, steps):
        got = read(prof, steps)
        seen.append((prof, steps, got))
        return got
    monkeypatch.setattr(trace, "from_profiler", spy)
    bench.run_cell(cell, 2**31 + 41, 1.0, True, device=cuda_card, traffic=traffic)
    (prof, steps, got), = seen
    want = _from_events(prof, steps)

    assert len(got.device_ops) == len(want.device_ops) > 0
    for g, w in zip(sorted(got.device_ops, key=lambda e: e[1:]),
                    sorted(want.device_ops, key=lambda e: e[1:])):
        assert g[0] == w[0] and abs(g[1] - w[1]) <= 1e-3 and abs(g[2] - w[2]) <= 1e-3, (g, w)
    assert len(got.kernels) == len(want.kernels)
    assert got.busy_us == pytest.approx(want.busy_us, rel=1e-9, abs=1e-2)
    assert got.window_us == pytest.approx(want.window_us, rel=1e-9, abs=1e-2)
    assert set(got.regions) == set(want.regions)
    for name, us in want.regions.items():
        assert got.regions[name] == pytest.approx(us, rel=1e-9, abs=1e-2), name
    if cell.endswith("act_b8192"):
        assert want.regions["portbench.act"] > 0
