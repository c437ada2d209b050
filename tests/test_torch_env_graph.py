"""``DeepMimicEnv.step_autoreset`` with its plain PyTorch after the megastep
replayed as a CUDA graph (``envs/deepmimic.py``, ``_StepGraph``).

On the CPU: the step stays eager wherever it runs off the card (the counters
show eager steps only), the cached constants equal the per-call tensors they
replaced, and the graph's parts run eagerly (the eager prefix, the megastep
into static buffers, the body, the fresh copy of each output) give the eager
step's results bit for bit, through resets, with outputs that share no
memory with the static buffers or each other, and the caller's tensors
untouched.

On the card (marked ``card``, skipped without one): the graphed step is
bit-equal to the eager step over ten steps with resets at B = 8 and B =
1024 in both megastep variants, the generator's next draw agrees, outputs
kept from one step survive the next, and the counters read one capture per
key and a replay for every later step.

    python -m pytest tests/test_torch_env_graph.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from pfpn_torch.envs.deepmimic import (  # noqa: E402
    UP, _IDENTITY_QUAT, _UP_VEC, _StepGraph, _leaves, make)
from pfpn_torch.math import quaternion as quat  # noqa: E402
from pfpn_torch.mocap.motion import apply_base_offset, sample_pose  # noqa: E402
from pfpn_torch.sim.dynamics import const  # noqa: E402


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the megastep kernel exist only there")
    return torch.device("cuda")


def _walk(device, links=False, **kw):
    env = make("DeepMimicWalk-v0", device=device, **kw)
    if links:
        env.engine.megastep_links = True
    return env


def _start(env, batch, generator, truncate_from=1):
    """Reset ``batch`` envs, with init times that make env i reach the time
    limit at step ``truncate_from + i`` (so the steps hold resets)."""
    state, obs = env.reset_batch(batch, generator)
    k = torch.arange(batch, device=state.elapsed_time.device) + truncate_from
    init = state.elapsed_time - env.overtime + k / env.fps - 1e-3
    return state.replace(init_time=init), obs


def _actions(env, batch, generator, device):
    return 0.2 * (2.0 * torch.rand(batch, env.action_size, generator=generator,
                                   device=device) - 1.0)


def _snapshot(tree):
    return [t.clone() for t in _leaves(tree)]


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


# -- CPU ----------------------------------------------------------------------

@pytest.mark.parametrize("path", ["megastep", "megastep_off", "torque"])
def test_step_autoreset_stays_eager_off_the_card(path):
    kw = {"control_mode": "torque"} if path == "torque" else {}
    env = _walk("cpu", frame_skip=2, **kw)
    if path == "megastep_off":
        env.engine.mega = None
    g = torch.Generator().manual_seed(1)
    state, _ = env.reset_batch(2, g)
    for _ in range(3):
        a = _actions(env, 2, g, "cpu")
        state = env.step_autoreset(state, a, g)[0]
    assert (env.eager_steps, env.graph_captures, env.graph_replays) == (3, 0, 0)
    assert env._graphs == {}
    assert all(torch.isfinite(t).all() for t in _leaves(state))


def test_cached_constants_equal_per_call_tensors():
    g = torch.Generator().manual_seed(5)
    q = torch.randn(64, 4, generator=g)
    q = q / q.norm(dim=-1, keepdim=True)
    ident = torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, -1.0],
                          [1e-10, 0.0, 0.0, 1.0]])
    for x in (ident, q, q.double()):
        # the former body, with its per-call unit_x
        y = torch.where(x[..., 3:4] < 0, -x, x)
        s = torch.linalg.vector_norm(y[..., :3], dim=-1)
        unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype)
        axis_old = torch.where((s > 1e-8)[..., None],
                               y[..., :3] / torch.clamp(s, min=1e-8)[..., None], unit_x)
        angle_old = 2.0 * torch.atan2(s, torch.clamp(y[..., 3], -1.0, 1.0))
        axis, angle = quat.quat_to_axis_angle(x)
        assert axis.dtype == x.dtype
        assert torch.equal(axis, axis_old) and torch.equal(angle, angle_old)
    assert torch.equal(quat.quat_to_axis_angle(ident)[0][:2],
                       torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]))

    # the env's cached up vector and identity quaternion against the former
    # per-call tensors, and the functions that take them
    up_vec = torch.zeros(3)
    up_vec[UP] = 1.0
    assert torch.equal(const(_UP_VEC, q), up_vec)
    assert torch.equal(const(_IDENTITY_QUAT, q), torch.tensor([0.0, 0.0, 0.0, 1.0]))
    env = _walk("cpu")
    heading = quat.yaw_about_up(q, UP)
    assert torch.equal(env._heading_rot(q), quat.quat_to_matrix(
        quat.quat_from_axis_angle(up_vec, -heading)))
    state, _ = env.reset_batch(4, g)
    pose = sample_pose(env.motion, state.elapsed_time)
    off = torch.randn(4, 3, generator=g)
    want = apply_base_offset(pose, off, torch.tensor([0.0, 0.0, 0.0, 1.0]))
    got = apply_base_offset(pose, off, const(_IDENTITY_QUAT, off))
    assert all(torch.equal(a, b) for a, b in zip(want, got))


@pytest.mark.parametrize("links", [False, True], ids=["default", "emit_links"])
def test_graph_parts_run_eagerly_equal_the_eager_step(links):
    """The graph's parts, run eagerly on the CPU, against the eager step:
    bit-equal through resets, fresh outputs, the caller's tensors kept."""
    env = _walk("cpu", links=links, frame_skip=5)
    B, steps = 4, 4
    g_eager, g_parts = (torch.Generator().manual_seed(7) for _ in range(2))
    s_eager, _ = _start(env, B, g_eager)
    s_parts, _ = _start(env, B, g_parts)
    parts = _StepGraph(env, B, g_parts, torch.device("cpu"))
    g_act = torch.Generator().manual_seed(8)
    kept, dones = [], 0
    for _ in range(steps):
        a = _actions(env, B, g_act, "cpu")
        before = _snapshot((s_parts, a))
        want = env._step_autoreset_eager(s_eager, a, g_eager)
        parts.feed(s_parts, a)
        parts.body()
        got = parts.fresh()
        assert _equal(want, got)
        assert all(torch.equal(x, y) for x, y in zip(before, _leaves((s_parts, a))))
        static = {x.untyped_storage().data_ptr() for x in parts.outputs + list(parts.kernel_out)
                  if x is not None} | {parts.clock.untyped_storage().data_ptr()}
        got_ptrs = [t.untyped_storage().data_ptr() for t in _leaves(got)]
        assert not static & set(got_ptrs) and len(set(got_ptrs)) == len(got_ptrs)
        kept.append((got, _snapshot(got)))
        dones += int(want[2].done.sum())
        s_eager, s_parts = want[0], got[0]
    assert dones >= 3
    assert all(torch.equal(x, y) for out, snap in kept for x, y in zip(_leaves(out), snap))
    assert torch.equal(torch.rand(3, generator=g_eager), torch.rand(3, generator=g_parts))


# -- the card ------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("batch", [8, 1024])
@pytest.mark.parametrize("links", [False, True], ids=["default", "emit_links"])
def test_graphed_step_autoreset_bit_equal_to_eager(cuda_card, batch, links):
    dev = cuda_card
    env = _walk(dev, links=links)
    steps = 10
    g_graph, g_eager = (torch.Generator(device=dev).manual_seed(11) for _ in range(2))
    s_graph, _ = _start(env, batch, g_graph, truncate_from=2)
    s_eager, _ = _start(env, batch, g_eager, truncate_from=2)
    g_act = torch.Generator(device=dev).manual_seed(12)
    kept, dones = [], 0
    for k in range(steps):
        a = _actions(env, batch, g_act, dev)
        before = _snapshot((s_graph, a))
        got = env.step_autoreset(s_graph, a, g_graph)
        want = env._step_autoreset_eager(s_eager, a, g_eager)
        assert _equal(want, got), f"step {k}"
        assert all(torch.equal(x, y) for x, y in zip(before, _leaves((s_graph, a))))
        kept.append((got, _snapshot(got)))
        dones += int(want[2].done.sum())
        s_graph, s_eager = got[0], want[0]
    assert dones >= min(batch, steps - 2)
    assert torch.equal(torch.rand(5, generator=g_graph, device=dev),
                       torch.rand(5, generator=g_eager, device=dev))
    assert all(torch.equal(x, y) for out, snap in kept for x, y in zip(_leaves(out), snap))
    assert (env.eager_steps, env.graph_captures, env.graph_replays) == (1, 1, steps - 1)
    mega = env.engine.mega
    assert (mega.launches_links if links else mega.launches) == 2 * steps


@pytest.mark.card
def test_graphed_step_with_the_default_generator(cuda_card):
    """generator=None: the device's default generator, registered by the
    capture itself; a replay draws what the eager step draws."""
    dev = cuda_card
    env = _walk(dev)
    batch, steps = 8, 5
    g = torch.Generator(device=dev).manual_seed(13)
    s0, _ = _start(env, batch, g)
    acts = [_actions(env, batch, g, dev) for _ in range(steps)]
    runs = {}
    for side in ("graph", "eager"):
        torch.cuda.manual_seed(14)
        s, outs = s0, []
        for a in acts:
            out = (env.step_autoreset(s, a) if side == "graph"
                   else env._step_autoreset_eager(s, a))
            outs.append(out)
            s = out[0]
        runs[side] = (outs, torch.rand(3, device=dev))
    assert all(_equal(a, b) for a, b in zip(runs["graph"][0], runs["eager"][0]))
    assert torch.equal(runs["graph"][1], runs["eager"][1])
    assert (env.eager_steps, env.graph_captures, env.graph_replays) == (1, 1, steps - 1)


@pytest.mark.card
@pytest.mark.parametrize("path", ["megastep_off", "torque", "requires_grad"])
def test_step_autoreset_stays_eager_on_the_card(cuda_card, path):
    dev = cuda_card
    kw = {"control_mode": "torque"} if path == "torque" else {}
    env = _walk(dev, frame_skip=2, **kw)
    if path == "megastep_off":
        env.engine.mega = None
    g = torch.Generator(device=dev).manual_seed(15)
    state, _ = env.reset_batch(8, g)
    for _ in range(3):
        a = _actions(env, 8, g, dev).requires_grad_(path == "requires_grad")
        state = env.step_autoreset(state, a, g)[0]
    assert (env.eager_steps, env.graph_captures, env.graph_replays) == (3, 0, 0)
    assert env._graphs == {}
