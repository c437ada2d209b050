"""SAC's gradient step replayed as a CUDA graph (``algos/sac.py``,
``_UpdateGraph``), and the optimizer state it holds.

On the CPU: SAC's step stays eager there, Adam's step counts stay on the
host for every algorithm, and ``ClippedAdam.load_state_dict`` copies a
checkpoint's moments and step counts into the tensors the optimizer
already holds (a captured graph keeps their storage), as
``set_capturable`` moves the step counts between host and device.

On the card (marked ``card``, skipped without one): SAC's Adam is
capturable and DDPG's is not; rounds of graphed gradient steps are bit-equal
to rounds of eager ones (the same capturable Adam, the graph's gate shut)
through a PFPN resample and through a checkpoint restored into the algorithm
whose graph is already captured, and the graph is captured once.

    python -m pytest tests/test_torch_sac_graph.py -q
"""

import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from pfpn_torch.algos.ppo import ClippedAdam  # noqa: E402
from pfpn_torch.algos.sac import SAC, SACConfig  # noqa: E402
from pfpn_torch.envs.deepmimic import _leaves  # noqa: E402
from pfpn_torch.harness import settings  # noqa: E402
from pfpn_torch.harness.build import build_env, build_net  # noqa: E402
from pfpn_torch.harness.checkpoint import CheckpointManager  # noqa: E402

# rounds of 8 env steps at 4 envs, 2 gradient steps of batch 16 after each
# once the ring holds a batch: 10 steps in the first round (the gate opens
# after its fourth env step), 16 in each later one; PFPN resamples at the
# 20th, inside the second round
ENVS, STEPS, BATCH, UPDATES, RESAMPLE = 4, 8, 16, 2, 20


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and capturable Adam exist only there")
    return torch.device("cuda")


def _sac(device, algo="sac") -> SAC:
    """SAC (or DDPG) on the Walk env with a small squashed PFPN network
    that resamples every RESAMPLE gradient steps."""
    rc = settings.build(f"deepmimic_{algo}_pfpn", particles=4, env_multiplier=ENVS)
    rc = dataclasses.replace(
        rc, head=dataclasses.replace(rc.head, resample_interval=RESAMPLE),
        network=dataclasses.replace(rc.network, actor_shape=(32,), critic_shape=(32, 32)))
    env = build_env(rc, device)
    net = build_net(rc, env).to(env.device)
    return SAC(env, net, SACConfig(algo=algo, num_envs=ENVS, batch_size=BATCH,
                                   steps_per_round=STEPS, updates_per_step=UPDATES,
                                   buffer_capacity=256))


def _snapshot(algo: SAC, state, out) -> dict:
    """Every tensor a round leaves: parameters and normalizer, targets,
    Adam's moments and step counts, PFPN's statistics, the ring, the envs,
    the generator and the round's metrics."""
    snap = {f"net.{k}": v for k, v in algo.net.state_dict().items()}
    snap.update({f"target.{k}": v for k, v in algo.target.state_dict().items()})
    for i, p in enumerate(algo.params):
        snap.update({f"adam.{i}.{k}": v for k, v in algo.opt.adam.state[p].items()})
    snap.update({f"stats.{k}": torch.as_tensor(v) for k, v in state.head_stats.items()})
    snap["ring"] = state.buffer.data[:state.buffer.size]
    snap["obs"] = state.obs
    snap.update({f"env.{i}": v for i, v in enumerate(_leaves(state.env_state))})
    snap["generator"] = state.generator.get_state()
    snap.update({f"out.{k}": torch.as_tensor(v) for k, v in out.items()
                 if isinstance(v, (torch.Tensor, int, float))})
    return {k: v.detach().clone() for k, v in snap.items()}


def _assert_equal(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        assert got[k].shape == v.shape and torch.equal(got[k].cpu(), v.cpu()), (what, k)


# -- CPU ----------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["sac", "ddpg"])
def test_step_stays_eager_off_the_card(algo):
    sac = _sac("cpu", algo)
    assert not sac.opt.capturable
    assert all(not g["capturable"] for g in sac.opt.adam.param_groups)
    state = sac.init_state(torch.Generator().manual_seed(1))
    state, out = sac.train_round(state)
    assert out["global_step"] == 10 and sac._graph is None
    assert all(s["step"].device.type == "cpu" for s in sac.opt.adam.state.values())


def test_restore_keeps_the_optimizer_tensors():
    """A checkpoint's Adam state lands in the tensors the optimizer holds:
    the same objects, the checkpoint's values; ``set_capturable`` keeps
    the values and moves only the step counts."""
    gen = torch.Generator().manual_seed(2)
    params = [torch.nn.Parameter(torch.randn(3, 4, generator=gen)),
              torch.nn.Parameter(torch.randn(5, generator=gen))]
    opt = ClippedAdam([params[:1], params[1:]], [1e-2, 1e-3], 1.0)

    def step():
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()

    step()
    step()
    saved = copy.deepcopy(opt.state_dict())
    held = {id(p): dict(opt.adam.state[p]) for p in params}
    step()
    opt.load_state_dict(saved)
    for i, p in enumerate(params):
        s = opt.adam.state[p]
        for k, v in held[id(p)].items():
            assert s[k] is v, k
            assert torch.equal(s[k], saved["state"][i][k]), k
    opt.set_capturable(True)
    assert opt.capturable and all(g["capturable"] for g in opt.adam.param_groups)
    opt.set_capturable(False)
    assert all(not g["capturable"] for g in opt.adam.param_groups)
    for i, p in enumerate(params):
        s = opt.adam.state[p]
        assert s["step"].device.type == "cpu" and float(s["step"]) == 2.0
        assert torch.equal(s["exp_avg"], saved["state"][i]["exp_avg"])
    step()                  # the eager step runs on from the restored counts
    assert all(float(opt.adam.state[p]["step"]) == 3.0 for p in params)


# -- card ---------------------------------------------------------------------

@pytest.mark.card
def test_capturable_only_where_the_graph_can_run(cuda_card):
    sac, ddpg = _sac(cuda_card, "sac"), _sac(cuda_card, "ddpg")
    assert sac.opt.capturable and all(g["capturable"] for g in sac.opt.adam.param_groups)
    assert not ddpg.opt.capturable
    assert all(not g["capturable"] for g in ddpg.opt.adam.param_groups)
    state = ddpg.init_state(torch.Generator(device=cuda_card).manual_seed(3))
    ddpg.train_round(state)
    assert ddpg._graph is None
    assert all(s["step"].device.type == "cpu" for s in ddpg.opt.adam.state.values())


@pytest.mark.card
def test_graphed_rounds_equal_eager_ones_through_a_resample_and_a_restore(cuda_card,
                                                                         tmp_path):
    """Round 1, then round 2 (PFPN resamples inside it), on a graphed SAC
    and on an eager one from the same start; then the graphed SAC restores
    the checkpoint it wrote after round 1 (its ring from a copy: the ring is
    not checkpointed) and runs round 2 again. Every tensor is bit-equal to
    the eager side's after each round."""
    dev = cuda_card
    graphed, eager = _sac(dev), _sac(dev)
    eager.opt.capturable = False    # shuts the graph's gate; Adam's groups stay capturable
    states = {name: algo.init_state(torch.Generator(device=dev).manual_seed(4))
              for name, algo in (("graphed", graphed), ("eager", eager))}

    snaps = {}
    for name, algo in (("graphed", graphed), ("eager", eager)):
        states[name], out = algo.train_round(states[name])
        snaps[name] = _snapshot(algo, states[name], out)
    _assert_equal(snaps["graphed"], snaps["eager"], "round 1")
    assert int(states["graphed"].head_stats["train_flag"]) == 10
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(10, states["graphed"])
    ring = copy.deepcopy(states["graphed"].buffer)

    for name, algo in (("graphed", graphed), ("eager", eager)):
        states[name], out = algo.train_round(states[name])
        snaps[name] = _snapshot(algo, states[name], out)
    _assert_equal(snaps["graphed"], snaps["eager"], "round 2")
    assert out["global_step"] == 26
    # the resample ran at the 20th step: its counter started again
    assert int(states["graphed"].head_stats["train_flag"]) == 26 - RESAMPLE

    graph = graphed._graph
    state = ckpt.restore_latest(states["graphed"].replace(buffer=ring))
    state, out = graphed.train_round(state)
    _assert_equal(_snapshot(graphed, state, out), snaps["eager"], "round 2 after the restore")
    assert graphed._graph is graph and graph.graph is not None
    assert eager._graph is None
