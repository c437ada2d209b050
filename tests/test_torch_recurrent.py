"""PyTorch port: the LSTM trunk and recurrent PPO against JAX.

* ``lstm_cell`` and ``lstm_sequence`` (with and without a reset mask) at
  obs 197 -> hidden 128, and ``apply_conv`` at strides 1 and 2 with
  ``SAME`` and ``VALID`` padding (a 10 x 11 image, kernels of 3 and 4, so
  that XLA's ``SAME`` pads one more at the end at both strides), against
  JAX (1e-5 of max(1, |value|));
* ``RecurrentActorCritic`` at full width (LSTM 128, trunks 1024 / 512,
  PFPN-35 on 36 dims): ``act``'s log-prob, value and carry,
  ``value_step``, ``act_deterministic`` and ``sequence_outputs`` (reset
  masks, entropy) against JAX (1e-5 of max(1, |value|): the log-probs
  reach ~60), and ``load_jax_params`` / ``export_jax_params`` both ways,
  exactly;
* one ``RecurrentPPO.update`` against JAX at full width with every env
  stream in one minibatch: the loss (rtol 1e-5), every parameter's
  gradient (5e-5 of the tensor's largest entry), the parameters after it
  against JAX's clip + Adam of the port's gradients (1e-6), the normalizer
  (1e-6 relative), the counters and head statistics;
* the port's own rollout on Walk (4 envs, 16 steps, a small net): the
  update's recomputation from the stored first carry reproduces the
  rollout's log-probs and values (1e-5, as ``tests/test_algos.py:475-496``
  holds JAX's), ``build_algo`` with ``lstm`` (as
  ``tests/test_algos.py:768-787``), evaluation with the carry, and a
  checkpoint that restores the carry.

``-s`` prints every error. Four tests, so that pytest-xdist's loadfile
schedule does not start this file before ``tests/test_megastep.py``.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.algos.ppo import PPOConfig as TPPOConfig, PPOState  # noqa: E402
from pfpn_torch.algos.recurrent import RecurrentPPO as TRecurrentPPO  # noqa: E402
from pfpn_torch.harness import settings  # noqa: E402
from pfpn_torch.harness.build import build_algo  # noqa: E402
from pfpn_torch.harness.checkpoint import CheckpointManager  # noqa: E402
from pfpn_torch.networks import heads as t_heads  # noqa: E402
from pfpn_torch.networks import recurrent as t_rec  # noqa: E402
from pfpn_torch.networks.actor_critic import export_jax_params, load_jax_params  # noqa: E402
from pfpn_torch.networks.recurrent_ac import (  # noqa: E402
    RecurrentACConfig as TRecurrentACConfig, RecurrentActorCritic as TRecurrentActorCritic,
)
from pfpn_tpu.algos.gae import gae as j_gae  # noqa: E402
from pfpn_tpu.algos.ppo import PPOConfig, PPOState as JPPOState  # noqa: E402
from pfpn_tpu.algos.recurrent import RecurrentPPO  # noqa: E402
from pfpn_tpu.networks import ParticleHead, RecurrentACConfig, RecurrentActorCritic  # noqa: E402
from pfpn_tpu.networks import heads as j_heads  # noqa: E402
from pfpn_tpu.networks import recurrent as j_rec  # noqa: E402
from pfpn_tpu.networks import value_norm as vnorm_mod  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "results", "policies",
                   "DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz")
# a gate is a sum of 325 products of ~0.3 and ~1: the two packages' fp32
# matmuls round it differently by ~1e-6 in a step (reading 8.7e-7), which the
# recurrence carries through 12 steps (2.0e-6)
CELL_TOL = 1e-5
NET_TOL = 1e-5
LOSS_RTOL = 1e-5      # tests/test_torch_train.py's bounds
GRAD_TOL = 5e-5
OPT_TOL = 1e-6
NORM_TOL = 1e-6
RECOMPUTE_TOL = 1e-5  # tests/test_algos.py:494-496
HIDDEN = 128


def _unflatten(flat):
    """tools/export_policy.py:38-54 (params arrays -> nested pytree)."""
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [listify(node[f"#{i}"]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def _flatten(tree, prefix="params"):
    out = {}
    items = tree.items() if isinstance(tree, dict) else ((f"#{i}", v) for i, v in enumerate(tree))
    for k, v in items:
        key = f"{prefix}/{k}"
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def _hold(tag, got, want, tol):
    err = _rel_err(got, want)
    print(f"\n{tag}: {err:.2e} of max(1, |value|)", end="")
    assert err <= tol, tag


def _carry(rng, b, scale=0.5):
    c, h = (scale * rng.standard_normal((2, b, HIDDEN))).astype(np.float32)
    return j_rec.LSTMState(c=jnp.asarray(c), h=jnp.asarray(h)), t_rec.LSTMState(
        c=torch.tensor(c), h=torch.tensor(h))


def test_lstm_and_conv_match_jax():
    rng = np.random.default_rng(21)
    params = j_rec.init_lstm(jax.random.PRNGKey(1), 197, HIDDEN)
    # weights of ~0.3 so that the gates saturate in places
    params = jax.tree.map(lambda p: 30.0 * p, params)
    params["b"] = jnp.asarray(0.5 * rng.standard_normal(4 * HIDDEN), jnp.float32)
    lstm = t_rec.LSTM(197, HIDDEN)
    lstm.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in params.items()})
    carry_j, carry_t = _carry(rng, 8)
    x = rng.standard_normal((12, 8, 197)).astype(np.float32)
    with torch.no_grad():
        new_t, h_t = t_rec.lstm_cell(lstm, carry_t, torch.tensor(x[0]))
        new_j, h_j = j_rec.lstm_cell(params, carry_j, jnp.asarray(x[0]))
        _hold("lstm_cell c", new_t.c, new_j.c, CELL_TOL)
        _hold("lstm_cell h", h_t, h_j, CELL_TOL)
        mask = (rng.random((12, 8)) > 0.2).astype(np.float32)
        for m in (None, mask):
            end_t, hs_t = t_rec.lstm_sequence(lstm, carry_t, torch.tensor(x),
                                              None if m is None else torch.tensor(m))
            end_j, hs_j = jax.jit(j_rec.lstm_sequence)(params, carry_j, jnp.asarray(x),
                                                       None if m is None else jnp.asarray(m))
            tag = "no mask" if m is None else "reset mask"
            _hold(f"lstm_sequence hs ({tag})", hs_t, hs_j, CELL_TOL)
            _hold(f"lstm_sequence final c ({tag})", end_t.c, end_j.c, CELL_TOL)
        assert float((hs_t[torch.tensor(mask) == 0]).abs().max()) == 0.0
        zero = t_rec.lstm_zero_state(HIDDEN, (3,))
        assert zero.c.shape == (3, HIDDEN) and float(zero.h.abs().max()) == 0.0

    # NHWC convolutions, HWIO weights: an even height, an odd width and an
    # even kernel, so that SAME pads asymmetrically at both strides
    img = rng.standard_normal((2, 10, 11, 3)).astype(np.float32)
    for ksize in (3, 4):
        cparams = j_rec.init_conv(jax.random.PRNGKey(ksize), 3, 5, ksize)
        cparams = {"w": 50.0 * cparams["w"],
                   "b": jnp.asarray(rng.standard_normal(5), jnp.float32)}
        conv = t_rec.Conv(3, 5, ksize)
        conv.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in cparams.items()})
        for stride in (1, 2):
            for padding in ("SAME", "VALID"):
                with torch.no_grad():
                    got = t_rec.apply_conv(conv, torch.tensor(img), stride, padding)
                want = j_rec.apply_conv(cparams, jnp.asarray(img), stride, padding)
                assert got.shape == want.shape, (ksize, stride, padding, got.shape)
                _hold(f"apply_conv k{ksize} s{stride} {padding} {tuple(got.shape)}", got,
                      want, CELL_TOL)
    g = torch.Generator().manual_seed(0)
    assert t_rec.init_lstm(197, 16, g).wi.shape == (197, 64)
    assert t_rec.init_conv(3, 5, 4, g).w.shape == (4, 4, 3, 5)


def _nets():
    """Both packages' recurrent networks at full width from JAX's init."""
    head_j = ParticleHead(action_dim=36, particles=35, resample=-1, resample_interval=368)
    net_j = RecurrentActorCritic(RecurrentACConfig(obs_dim=197, head=head_j,
                                                   lstm_hidden=HIDDEN, normalize_advantage=True))
    params = net_j.init(jax.random.PRNGKey(3))
    with np.load(NPZ) as z:
        norm = net_j.init_norm()._replace(mean=jnp.asarray(z["norm/mean"], jnp.float32),
                                          std=jnp.asarray(z["norm/std"], jnp.float32))
    # a trunk that carries state: LSTM weights of ~0.1, not the init's 0.01
    params["lstm"] = {k: 10.0 * v for k, v in params["lstm"].items()}
    head_t = t_heads.ParticleHead(action_dim=36, particles=35, resample=-1,
                                  resample_interval=368)
    net_t = TRecurrentActorCritic(TRecurrentACConfig(obs_dim=197, head=head_t,
                                                     lstm_hidden=HIDDEN, normalize_advantage=True))
    flat = _flatten(params)
    flat.update({f"norm/{k}": np.asarray(v) for k, v in norm._asdict().items()})
    net_t.load_state_dict(load_jax_params(flat), strict=True)
    return net_j, net_t, params, norm, flat


def _obs(rng, norm, shape):
    return (np.asarray(norm.mean) + np.asarray(norm.std)
            * rng.standard_normal(shape + (197,))).astype(np.float32)


def test_recurrent_net_matches_jax_full_width():
    net_j, net_t, params, norm, flat = _nets()
    back = export_jax_params(net_t)
    assert set(back) == set(flat) and {"params/lstm/wi", "params/lstm/wh", "params/lstm/b"} <= set(
        back)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    rng = np.random.default_rng(23)
    B, T = 8, 10
    carry_j, carry_t = _carry(rng, B)
    obs = _obs(rng, norm, (B,))
    with torch.no_grad():
        a, lp, v, aux, c1 = net_t.act(torch.tensor(obs), torch.Generator().manual_seed(1),
                                      carry_t)
        v_s, c_s = net_t.value_step(torch.tensor(obs), carry_t)
        a_d, c_d = net_t.act_deterministic(torch.tensor(obs), carry_t)
    # JAX's log-prob and value of the port's draw: its sequence path over one step
    lp_j, v_j, _ = net_j.sequence_outputs(params, norm, jnp.asarray(obs)[None],
                                          jnp.asarray(a.numpy())[None], carry_j,
                                          jnp.zeros((1, B), bool))
    vs_j, cs_j = net_j.value_step(params, norm, jnp.asarray(obs), carry_j)
    ad_j, cd_j = net_j.act_deterministic(params, norm, jnp.asarray(obs), carry_j)
    _hold("act log_prob", lp, lp_j[0], NET_TOL)
    _hold("act value", v, v_j[0], NET_TOL)
    _hold("value_step value", v_s, vs_j, NET_TOL)
    for tag, (ct, cj) in {"act": (c1, cs_j), "value_step": (c_s, cs_j),
                          "act_deterministic": (c_d, cd_j)}.items():
        _hold(f"{tag} carry c", ct.c, cj.c, NET_TOL)
        _hold(f"{tag} carry h", ct.h, cj.h, NET_TOL)
    _hold("act_deterministic", a_d, ad_j, NET_TOL)
    assert aux["probs"].shape == (B, 36, 35)

    obs_seq = _obs(rng, norm, (T, B))
    action = (0.3 * rng.standard_normal((T, B, 36))).astype(np.float32)
    reset = rng.random((T, B)) < 0.15
    reset[0] = False
    with torch.no_grad():
        lp_t, v_t, ent_t = net_t.sequence_outputs(torch.tensor(obs_seq), torch.tensor(action),
                                                  carry_t, torch.tensor(reset), want_entropy=True)
        hs_t, end_t = net_t.sequence_features(torch.tensor(obs_seq), carry_t, torch.tensor(reset))
    lp_j, v_j, ent_j = jax.jit(net_j.sequence_outputs, static_argnums=6)(
        params, norm, jnp.asarray(obs_seq), jnp.asarray(action), carry_j, jnp.asarray(reset), True)
    _hold("sequence_outputs log_prob", lp_t, lp_j, NET_TOL)
    _hold("sequence_outputs value", v_t, v_j, NET_TOL)
    _hold("sequence_outputs entropy", ent_t, ent_j, NET_TOL)
    hs_j, end_j = net_j.sequence_features(params, norm, jnp.asarray(obs_seq), carry_j,
                                          jnp.asarray(reset))
    _hold("sequence_features h", hs_t, hs_j, NET_TOL)
    _hold("sequence_features final c", end_t.c, end_j.c, NET_TOL)
    assert float(np.abs(np.asarray(lp_j)).max()) > 10


def test_recurrent_ppo_update_matches_jax_full_width():
    T, B = 16, 4
    net_j, net_t, params, norm, _ = _nets()
    cfg = dict(num_envs=B, unroll_length=T, minibatch_size=T * B)
    ppo_j = RecurrentPPO(None, net_j, PPOConfig(**cfg))
    ppo_t = TRecurrentPPO(None, net_t, TPPOConfig(**cfg))
    assert ppo_j.seq_batch == ppo_t.seq_batch == B

    # a fixed trajectory: actions near the policy's mode along the sequence,
    # behaviour log-probs off the current ones, terminals and truncations
    rng = np.random.default_rng(27)
    carry_j, carry_t = _carry(rng, B, scale=0.3)
    obs = _obs(rng, norm, (T, B))
    term = rng.random((T, B)) < 0.05
    done = term | (rng.random((T, B)) < 0.05)
    reset = np.concatenate([np.zeros((1, B), bool), done[:-1]], 0)
    hs, _ = net_j.sequence_features(params, norm, jnp.asarray(obs), carry_j, jnp.asarray(reset))
    mode = np.asarray(j_heads.deterministic_action(net_j.cfg.head, params["head"],
                                                   net_j._actor_feat(params, hs)))
    action = (mode + 0.05 * rng.standard_normal(mode.shape)).astype(np.float32)
    lp, value, _ = net_j.sequence_outputs(params, norm, jnp.asarray(obs), jnp.asarray(action),
                                          carry_j, jnp.asarray(reset))
    lp, value = np.asarray(lp), np.asarray(value)
    traj = {
        "obs": obs, "action": action,
        "log_prob": (lp + 0.3 * rng.standard_normal(lp.shape)).astype(np.float32),
        "value": (value + 0.1 * rng.standard_normal(value.shape)).astype(np.float32),
        "reward": rng.random((T, B)).astype(np.float32),
        "next_value": (value + 0.1 * rng.standard_normal(value.shape)).astype(np.float32),
        "terminated": term, "done": done,
    }
    traj_j = {k: jnp.asarray(v) for k, v in traj.items()}
    adv = j_gae(*(traj_j[k] for k in ("reward", "value", "next_value", "terminated", "done")),
                0.95, 0.95)
    batch_j = {k: traj_j[k] for k in ("obs", "action", "log_prob", "value")}
    batch_j.update(advantage=adv, reset_before=jnp.asarray(reset))
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(ppo_j._loss_seq, has_aux=True))(
        params, norm, batch_j, carry_j)
    state_j = JPPOState(
        params=params, opt_state=ppo_j.tx.init(params), norm=norm,
        head_stats=net_j.init_stats(), env_state=None, obs=None, key=jax.random.PRNGKey(0),
        global_step=jnp.zeros((), jnp.int32), total_samples=jnp.zeros((), jnp.int32),
        ep_return=jnp.zeros(B), last_ep_return=jnp.zeros(B), vnorm=vnorm_mod.init(),
        carry=carry_j)
    state_j, metrics_j = jax.jit(ppo_j.update)(state_j, {**traj_j, "carry0": carry_j})

    loss_t, _ = ppo_t._loss_seq({k: torch.tensor(np.asarray(v)) for k, v in batch_j.items()},
                                carry_t)
    loss_t.backward()
    print(f"\nrecurrent PPO: loss port {float(loss_t.detach()):.7g}, JAX {float(loss_j):.7g}")
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=LOSS_RTOL)
    named = dict(net_t.named_parameters())
    worst = ("", 0.0)
    for name, g in load_jax_params(_flatten(grads_j)).items():
        rel = float((named[name].grad - g).abs().max()) / float(g.abs().max())
        worst = max(worst, (name, rel), key=lambda x: x[1])
        assert float(g.abs().max()) > 0 and rel <= GRAD_TOL, (name, rel)
    print(f"recurrent PPO: gradients max abs err / max |grad| {worst[1]:.2e} ({worst[0]})")

    step_grads = {}
    opt_step = ppo_t.opt.step

    def capturing_step():
        step_grads.update({k: p.grad.detach().clone() for k, p in named.items()})
        opt_step()

    ppo_t.opt.step = capturing_step
    state_t = PPOState(net=net_t, opt=ppo_t.opt, head_stats=net_t.init_stats(), env_state=None,
                       obs=None, generator=torch.Generator().manual_seed(0), carry=carry_t)
    traj_t = {k: torch.tensor(v) for k, v in traj.items()}
    state_t, metrics_t = ppo_t.update(state_t, {**traj_t, "carry0": carry_t})
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        got, want = float(metrics_t[k]), float(np.asarray(metrics_j[k]))
        print(f"recurrent PPO: metric {k} port {got:.7g}, JAX {want:.7g}")
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=1e-6)
    own = {}
    for key, v in _flatten(params).items():
        (name, _), = load_jax_params({key: v}).items()
        g = step_grads[name].numpy()
        own[key[len("params/"):]] = jnp.asarray(g.T if key.endswith("/w") else g)
    updates, _ = jax.jit(ppo_j.tx.update)(_unflatten(own), ppo_j.tx.init(params), params)
    want = load_jax_params(_flatten(jax.tree.map(lambda p, u: p + u, params, updates)))
    err = max(float((named[k].detach() - v).abs().max()) for k, v in want.items())
    err_j = max(float((named[k].detach() - v).abs().max())
                for k, v in load_jax_params(_flatten(state_j.params)).items())
    print(f"recurrent PPO: post-update parameters vs JAX's clip + Adam of the port's gradients "
          f"{err:.2e} (vs JAX's own update {err_j:.2e})")
    assert err <= OPT_TOL
    for k in ("mean", "std"):
        want_n = np.asarray(getattr(state_j.norm, k))
        err_n = float(np.abs(getattr(net_t.norm, k).numpy() - want_n).max())
        print(f"recurrent PPO: normalizer {k} {err_n:.2e}")
        assert err_n <= NORM_TOL * max(1.0, float(np.abs(want_n).max()))
    assert state_t.global_step == int(state_j.global_step) == 1
    assert state_t.head_stats["train_flag"] == int(state_j.head_stats["train_flag"]) == 1
    for k in ("max_active", "sum_active"):
        np.testing.assert_array_equal(state_t.head_stats[k].numpy(),
                                      np.asarray(state_j.head_stats[k]))


def test_rollout_recompute_build_and_checkpoint_on_walk(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = settings.build("deepmimic_dppo_pfpn", particles=8)
    cfg = dataclasses.replace(
        cfg, workers=4, worker=dataclasses.replace(cfg.worker, unroll_length=16, batch_size=16),
        network=dataclasses.replace(cfg.network, lstm=16, actor_shape=(32,),
                                    critic_shape=(32,)))
    algo = build_algo(cfg, "cpu")
    assert isinstance(algo, TRecurrentPPO) and isinstance(algo.net, TRecurrentActorCritic)
    assert algo.net.cfg.lstm_hidden == 16 and algo.seq_batch == 4
    state = algo.init_state(torch.Generator().manual_seed(0))
    assert state.carry.h.shape == (4, 16) and float(state.carry.h.abs().max()) == 0.0
    # one round, so that the carries are mid-episode, then a rollout
    state, metrics = algo.train_round(state)
    assert (state.global_step, state.total_samples) == (1, 64)
    state2, traj = algo.rollout(state)
    assert traj["carry0"] is state.carry and float(state.carry.h.abs().max()) > 0
    done = traj["done"]
    print(f"\nrollout: {int(done.sum())} episode ends in 16 steps of 4 envs")
    assert bool(done[:-1].any())
    reset = torch.cat([torch.zeros_like(done[:1]), done[:-1]], 0)
    with torch.no_grad():
        lp, v, _ = algo.net.sequence_outputs(traj["obs"], traj["action"], traj["carry0"], reset)
    err_lp = float((lp - traj["log_prob"]).abs().max())
    err_v = float((v - traj["value"]).abs().max())
    print(f"recompute from carry0: log_prob {err_lp:.2e}, value {err_v:.2e}")
    torch.testing.assert_close(lp, traj["log_prob"], rtol=RECOMPUTE_TOL, atol=RECOMPUTE_TOL)
    torch.testing.assert_close(v, traj["value"], rtol=RECOMPUTE_TOL, atol=RECOMPUTE_TOL)
    out = algo.evaluate(num_episodes=2, max_steps=5, generator=torch.Generator().manual_seed(1))
    assert out["frames"].tolist() == [5, 5] and bool(torch.isfinite(out["reward"]).all())

    # a checkpoint restores the carry with everything else
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(state2.global_step, state2)
    fresh = build_algo(cfg, "cpu")
    restored = ckpt.restore_latest(fresh.init_state(torch.Generator().manual_seed(9)))
    assert type(restored.carry) is t_rec.LSTMState
    for a, b in zip(restored.carry, state2.carry):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for (k, a), b in zip(algo.net.state_dict().items(), fresh.net.state_dict().values()):
        assert torch.equal(a, b), k
