"""``correct`` comes out false when the timed path is broken underneath.

Each case drives a whole run of a cell through ``bench.run_cell`` on the
CPU at a tiny size (the harness's look for a card is what it skips), with
the limits of ``limits/<cell>.json``, and breaks the port after it is built
through the ``built`` hook: a step that returns its state unchanged, half of
the batch left out with the mean taken over the rest (training), and an
answer altered where it is produced (each reward 1e-3 off). The cells run on
one chip, so there is no exchange between chips to leave out. A sound run
of the same size comes out correct. The control, the reference computed
with TF32 on in the port's place, exists only on a card: its test is
marked ``card``.
"""

import json
import os

import pytest
import torch

from portbench import bench, judge

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ACT = "dppo_pfpn35_walk.act_b8192"
TRAIN = "a3c_pfpn35_walk.train_b8192"


def _traffic(name, **kw):
    with open(os.path.join(ROOT, "portbench", "traffic", f"{name}.json")) as fh:
        return dict(json.load(fh), **kw)


TINY_ACT = _traffic("act_b8192", num_envs=8, warmup_steps=1, check_steps=1,
                    check_step_range=1, check_rows=8)
TINY_TRAIN = _traffic("train_b8192", env_multiplier=1, unroll_length=2, check_rows=6)


def _state_unchanged(env):
    step = env.step

    def broken(state, action):
        return step(state, action)._replace(state=state)
    env.step = broken


def _reward_altered(env):
    step = env.step

    def broken(state, action):
        res = step(state, action)
        return res._replace(reward=res.reward + 1e-3)
    env.step = broken


def _act_fault(fault):
    return {"sound": lambda env, net: None,
            "state_unchanged": lambda env, net: _state_unchanged(env),
            "altered_reward": lambda env, net: _reward_altered(env)}[fault]


@pytest.mark.parametrize("fault", ["sound", "state_unchanged", "altered_reward"])
def test_act_cell_catches_a_broken_step(fault):
    res = bench.run_cell(ACT, 2**31 + 11, 0.5, False, device="cpu", traffic=TINY_ACT,
                         hooks={"built": _act_fault(fault)})
    failed = sorted(k for k, c in res["checks"].items() if not c["value"] <= c["limit"])
    assert res["correct"] == (fault == "sound"), failed


def _half_batch(algo):
    loss = algo._loss

    def broken(batch, vnorm=None):
        n = batch["advantage"].shape[0] // 2
        return loss({k: v[:n] for k, v in batch.items()}, vnorm)
    algo._loss = broken


def _no_step(algo):
    algo.opt.step = lambda: None


@pytest.mark.parametrize("fault", ["sound", "state_unchanged", "half_batch", "altered_reward"])
def test_train_cell_catches_a_broken_update(fault):
    hook = {"sound": lambda algo: None,
            "state_unchanged": _no_step,
            "half_batch": _half_batch,
            "altered_reward": lambda algo: _reward_altered(algo.env)}[fault]
    res = bench.run_cell(TRAIN, 2**31 + 13, 0.1, False, device="cpu", traffic=TINY_TRAIN,
                         hooks={"built": hook})
    failed = sorted(k for k, c in res["checks"].items() if not c["value"] <= c["limit"])
    assert res["correct"] == (fault == "sound"), failed


@pytest.mark.card
@pytest.mark.parametrize("cell,traffic", [
    (ACT, _traffic("act_b8192", num_envs=1024, check_step_range=8)),
    (TRAIN, _traffic("train_b8192", env_multiplier=16))])
def test_control_in_lower_precision_fails(cuda_card, cell, traffic):
    """The reference with TF32 on, in the port's place, fails a limit; the
    port itself passes (a card: TF32 exists only there)."""
    res = bench.run_cell(cell, 2**31 + 17, 2.0, False, device=cuda_card, traffic=traffic,
                         with_control=True)
    assert res["correct"]
    ok, _ = judge.verdict(res["control"], bench.Cell(cell).limits)
    assert not ok
    assert torch.backends.cuda.matmul.allow_tf32 is False
