"""PyTorch port: A2C (the A3C presets) and V-trace (the IMPALA presets)
against JAX.

* one ``A2C.update`` at full width (the shipped Walk DPPO + PFPN-35
  policy's parameters: trunks 197 -> 1024 -> 512, head 512 -> 36 x 35) at
  the A3C preset (entropy 2.5e-4, clip 0.5): 32 steps x 16 envs, one
  minibatch, so the shuffle cannot matter;
* a whole ``VTrace.update`` at full width: 16 steps x 8 envs in groups of
  4, so two gradient steps, with behaviour log-probs far enough off that
  rho clips, terminals and truncations; with the particle head, and with
  the Gaussian head, whose two Adam groups have different learning rates
  (5e-6 and 1e-4);
* the six presets and what ``build_algo`` makes of them equal to the JAX
  package's, and one tiny CPU round through ``cli.main`` of
  ``deepmimic_a3c_pfpn`` and ``deepmimic_impala_pfpn`` that checkpoints and
  resumes.

Each gradient step is held against JAX at the port's own parameters and
normalizer before it: the loss (rtol 1e-5), every parameter's gradient
(5e-5 of the tensor's largest entry), and the parameters after it against
JAX's clip + Adam applied to the port's gradients, its optimizer state
carried from step to step (1e-6). After the update: the normalizer against
JAX's own update (1e-6 relative; the moving average is order-dependent, so
this also holds the grouping), the metrics (the mean over the steps of
JAX's losses), the step counter and the head statistics. ``-s`` prints
every error, and the parameters' gap to JAX's own update.

Four tests, so that pytest-xdist's loadfile schedule does not start this
file before ``tests/test_megastep.py``.
"""

import dataclasses
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pfpn_torch.algos.a2c import A2C as TA2C  # noqa: E402
from pfpn_torch.algos.ppo import PPOConfig as TPPOConfig, PPOState  # noqa: E402
from pfpn_torch.algos.vtrace import VTrace as TVTrace, VTraceConfig as TVTraceConfig  # noqa: E402
from pfpn_torch.harness import build as t_build_mod, cli, settings  # noqa: E402
from pfpn_torch.harness.checkpoint import CheckpointManager  # noqa: E402
from pfpn_torch.networks.actor_critic import load_jax_params  # noqa: E402
from pfpn_tpu.algos.a2c import A2C  # noqa: E402
from pfpn_tpu.algos.gae import gae as j_gae  # noqa: E402
from pfpn_tpu.algos.ppo import PPOConfig, PPOState as JPPOState  # noqa: E402
from pfpn_tpu.algos.vtrace import VTrace, VTraceConfig  # noqa: E402
from pfpn_tpu.harness.settings import build as j_build  # noqa: E402
from pfpn_tpu.networks import value_norm as vnorm_mod  # noqa: E402

# pfpn_tpu.harness exports a function of the module's name
j_build_mod = importlib.import_module("pfpn_tpu.harness.build")

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "results", "policies",
                   "DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz")
LOSS_RTOL = 1e-5      # tests/test_torch_train.py's bounds
LOSS_ATOL = 1e-6
GRAD_TOL = 5e-5
OPT_TOL = 1e-6
NORM_TOL = 1e-6
PRESETS = [f"deepmimic_{a}_{k}" for a in ("a3c", "impala") for k in ("pfpn", "gauss", "dis")]


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


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _net_cfg(cfg) -> dict:
    """A network's configuration, without the head's action bounds where
    only a squashed head reads them (the port passes them to those only)."""
    d = dataclasses.asdict(cfg)
    if not d["head"].get("squash"):
        d["head"] = {k: v for k, v in d["head"].items() if k not in ("action_low", "action_high")}
    return d


class StubEnv:
    """What build_head and build_net read of an env: its sizes and bounds."""

    observation_size, action_size = 197, 36
    action_low, action_high = -np.ones(36, np.float32), np.ones(36, np.float32)
    device = torch.device("cpu")


class StepRecorder:
    """Wraps a port optimizer's ``step``: the parameters, gradients and
    normalizer before each step and the parameters after it."""

    def __init__(self, net, opt):
        self.net, self.named, self.steps = net, dict(net.named_parameters()), []
        step = opt.step

        def recording_step():
            rec = {"pre": {k: p.detach().clone() for k, p in self.named.items()},
                   "grad": {k: p.grad.detach().clone() for k, p in self.named.items()},
                   "norm": {k: getattr(net.norm, k).clone() for k in ("mean", "std")}}
            step()
            rec["post"] = {k: p.detach().clone() for k, p in self.named.items()}
            self.steps.append(rec)

        opt.step = recording_step


def record_losses(algo, name):
    """Wraps ``algo``'s loss method ``name``: a list of the losses it gave."""
    losses, loss = [], getattr(algo, name)

    def recording(*args, **kwargs):
        out = loss(*args, **kwargs)
        losses.append(float(out[0].detach()))
        return out

    setattr(algo, name, recording)
    return losses


def hold_steps(tag, steps, losses_t, params0, norm0, loss_grad_j, batches, tx):
    """Hold each recorded port step against JAX at the port's own
    parameters: loss, gradients, and the parameters after JAX's clip +
    Adam of the port's gradients (its state carried). Returns JAX's
    losses."""
    keymap = {k[len("params/"):]: next(iter(load_jax_params({k: v})))
              for k, v in _flatten(params0).items()}

    def to_jax(named):
        return _unflatten({k: jnp.asarray(named[n].numpy().T if k.endswith("/w")
                                          else named[n].numpy())
                           for k, n in keymap.items()})

    opt_state, losses_j, tx_update = tx.init(params0), [], jax.jit(tx.update)
    for i, (rec, batch) in enumerate(zip(steps, batches)):
        params = to_jax(rec["pre"])
        norm = norm0._replace(**{k: jnp.asarray(v.numpy()) for k, v in rec["norm"].items()})
        (loss_j, _), grads_j = loss_grad_j(params, norm, batch)
        losses_j.append(float(loss_j))
        print(f"\n{tag} step {i}: loss port {losses_t[i]:.7g}, JAX {float(loss_j):.7g}")
        np.testing.assert_allclose(losses_t[i], float(loss_j), rtol=LOSS_RTOL)
        worst = ("", 0.0)
        for name, g in load_jax_params(_flatten(grads_j)).items():
            rel = _max_err(rec["grad"][name].numpy(), g.numpy()) / float(g.abs().max())
            worst = max(worst, (name, rel), key=lambda x: x[1])
            assert float(g.abs().max()) > 0 and rel <= GRAD_TOL, (i, name, rel)
        updates, opt_state = tx_update(to_jax(rec["grad"]), opt_state, params)
        want = load_jax_params(_flatten(jax.tree.map(lambda p, u: p + u, params, updates)))
        err = max(_max_err(rec["post"][k].numpy(), v.numpy()) for k, v in want.items())
        print(f"{tag} step {i}: gradients max abs err / max |grad| {worst[1]:.2e} ({worst[0]}); "
              f"parameters after it vs JAX's clip + Adam of the port's gradients {err:.2e}")
        assert err <= OPT_TOL, (i, err)
    return losses_j


def hold_after(tag, state_t, net_t, metrics_t, state_j, metrics_j, losses_j, n_steps):
    for k in ("mean", "std"):
        want = np.asarray(getattr(state_j.norm, k))
        err = _max_err(getattr(net_t.norm, k).numpy(), want)
        print(f"{tag}: normalizer {k} vs JAX's update {err:.2e}")
        assert err <= NORM_TOL * max(1.0, float(np.abs(want).max())), k
    got, want = float(metrics_t["loss"]), float(np.mean(losses_j))
    print(f"{tag}: metric loss port {got:.7g}, JAX's losses at the port's steps {want:.7g}, "
          f"JAX's own update {float(metrics_j['loss']):.7g}")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for k in ("policy_loss", "value_loss", "entropy"):
        print(f"{tag}: metric {k} port {float(metrics_t[k]):.7g}, JAX {float(metrics_j[k]):.7g}")
        assert np.isfinite(float(metrics_t[k]))
    own = max(_max_err(p.detach().numpy(), load_jax_params(_flatten(state_j.params))[k].numpy())
              for k, p in net_t.named_parameters())
    print(f"{tag}: parameters vs JAX's own update {own:.2e}")
    assert state_t.global_step == int(state_j.global_step) == n_steps
    if state_t.head_stats:
        assert state_t.head_stats["train_flag"] == int(state_j.head_stats["train_flag"]) == n_steps
        for k in ("max_active", "sum_active"):
            np.testing.assert_array_equal(state_t.head_stats[k].numpy(),
                                          np.asarray(state_j.head_stats[k]))


def _nets(setting):
    """The JAX and port networks of a preset, from the same parameters: the
    shipped npz's for the particle head, a JAX init for the others."""
    cfg_j, cfg_t = j_build(setting, particles=35), settings.build(setting, particles=35)
    env = StubEnv()
    net_j = j_build_mod.build_net(cfg_j, env)
    net_t = t_build_mod.build_net(cfg_t, env)
    if cfg_j.head.kind == "particle":
        with np.load(NPZ) as z:
            flat = {k: z[k].astype(np.float32) for k in z.files}
        params = _unflatten({k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()
                             if k.startswith("params/")})
        norm = net_j.init_norm()._replace(mean=jnp.asarray(flat["norm/mean"]),
                                          std=jnp.asarray(flat["norm/std"]))
    else:
        params = net_j.init(jax.random.PRNGKey(7))
        with np.load(NPZ) as z:
            norm = net_j.init_norm()._replace(mean=jnp.asarray(z["norm/mean"], jnp.float32),
                                              std=jnp.asarray(z["norm/std"], jnp.float32))
    flat = _flatten(params)
    flat.update({f"norm/{k}": np.asarray(v) for k, v in norm._asdict().items()})
    net_t.load_state_dict(load_jax_params(flat), strict=True)
    return cfg_j, net_j, net_t, params, norm


def _trajectory(net_j, params, norm, T, B, seed, lp_noise):
    """Observations around the normalizer's statistics, actions near the
    policy's mode, behaviour log-probs ``lp_noise`` off the current ones,
    terminals and truncations."""
    rng = np.random.default_rng(seed)
    mean, std = np.asarray(norm.mean), np.asarray(norm.std)
    obs = (mean + std * rng.standard_normal((T, B, 197))).astype(np.float32)
    mode = np.asarray(jax.jit(net_j.act_deterministic)(params, norm, jnp.asarray(obs)))
    action = (mode + 0.05 * rng.standard_normal(mode.shape)).astype(np.float32)
    lp = np.asarray(jax.jit(net_j.log_prob)(params, norm, jnp.asarray(obs), jnp.asarray(action)))
    value = np.asarray(jax.jit(net_j.value)(params, norm, jnp.asarray(obs)))
    term = rng.random((T, B)) < 0.05
    return {
        "obs": obs, "action": action,
        "log_prob": (lp + lp_noise * rng.standard_normal(lp.shape)).astype(np.float32),
        "value": (value + 0.1 * rng.standard_normal(value.shape)).astype(np.float32),
        "reward": rng.random((T, B)).astype(np.float32),
        "next_value": (value + 0.1 * rng.standard_normal(value.shape)).astype(np.float32),
        "terminated": term, "done": term | (rng.random((T, B)) < 0.05),
    }


def _jax_state(algo_j, net_j, params, norm, B):
    return JPPOState(
        params=params, opt_state=algo_j.tx.init(params), norm=norm,
        head_stats=net_j.init_stats(), env_state=None, obs=None, key=jax.random.PRNGKey(0),
        global_step=jnp.zeros((), jnp.int32), total_samples=jnp.zeros((), jnp.int32),
        ep_return=jnp.zeros(B), last_ep_return=jnp.zeros(B), vnorm=vnorm_mod.init())


def test_a2c_update_matches_jax_full_width():
    T, B = 32, 16
    cfg_j, net_j, net_t, params, norm = _nets("deepmimic_a3c_pfpn")
    assert net_t.cfg.entropy_beta == net_j.cfg.entropy_beta == 2.5e-4
    w = cfg_j.worker
    pcfg = dict(num_envs=B, unroll_length=T, minibatch_size=T * B, lr_actor=w.lr_actor,
                lr_critic=w.lr_critic, norm_clip=w.norm_clip)
    a2c_j = A2C(None, net_j, PPOConfig(**pcfg))
    traj = _trajectory(net_j, params, norm, T, B, seed=51, lp_noise=0.3)
    state_j, metrics_j = jax.jit(a2c_j.update)(_jax_state(a2c_j, net_j, params, norm, B),
                                               {k: jnp.asarray(v) for k, v in traj.items()})

    a2c_t = TA2C(None, net_t, TPPOConfig(**pcfg))
    rec = StepRecorder(net_t, a2c_t.opt)
    losses_t = record_losses(a2c_t, "_loss")
    state_t = PPOState(net=net_t, opt=a2c_t.opt, head_stats=net_t.init_stats(),
                       env_state=None, obs=None, generator=torch.Generator().manual_seed(0))
    state_t, metrics_t = a2c_t.update(state_t, {k: torch.tensor(v) for k, v in traj.items()})

    # the one minibatch, in the port's order (its permutation of the 512 samples)
    adv = j_gae(*(jnp.asarray(traj[k]) for k in ("reward", "value", "next_value",
                                                  "terminated", "done")), 0.95, 0.95)
    flat = {k: np.asarray(traj[k]).reshape((T * B,) + traj[k].shape[2:])
            for k in ("obs", "action", "log_prob", "value")}
    flat["advantage"] = np.asarray(adv).reshape(-1)
    perm = torch.randperm(T * B, generator=torch.Generator().manual_seed(0)).numpy()
    batch = {k: jnp.asarray(v[perm]) for k, v in flat.items()}
    loss_grad = jax.jit(jax.value_and_grad(a2c_j._loss, has_aux=True))
    losses_j = hold_steps("A2C", rec.steps, losses_t, params, norm, loss_grad, [batch],
                          a2c_j.tx)
    hold_after("A2C", state_t, net_t, metrics_t, state_j, metrics_j, losses_j, 1)


@pytest.mark.parametrize("kind", ["pfpn", "gauss"])
def test_vtrace_update_matches_jax_full_width(kind):
    T, B, G = 16, 8, 4
    cfg_j, net_j, net_t, params, norm = _nets(f"deepmimic_impala_{kind}")
    w = cfg_j.worker
    vcfg = dict(num_envs=B, unroll_length=T, queue_batch=G, lr_actor=w.lr_actor,
                lr_critic=w.lr_critic, norm_clip=w.norm_clip)
    assert (w.lr_actor == w.lr_critic) == (kind == "pfpn")
    vt_j = VTrace(None, net_j, VTraceConfig(**vcfg))
    traj = _trajectory(net_j, params, norm, T, B, seed=61, lp_noise=0.5)
    state_j, metrics_j = jax.jit(vt_j.update)(_jax_state(vt_j, net_j, params, norm, B),
                                              {k: jnp.asarray(v) for k, v in traj.items()})

    vt_t = TVTrace(None, net_t, TVTraceConfig(**vcfg))
    rec = StepRecorder(net_t, vt_t.opt)
    rhos, loss0 = [], vt_t._vtrace_loss

    def rho_recording_loss(batch):
        with torch.no_grad():
            obs = batch["obs"].reshape(-1, 197)
            lp = net_t.log_prob(obs, batch["action"].reshape(obs.shape[0], -1))
            rhos.append(torch.exp(lp.reshape(T, G) - batch["log_prob"]))
        return loss0(batch)

    vt_t._vtrace_loss = rho_recording_loss
    losses_t = record_losses(vt_t, "_vtrace_loss")
    state_t = PPOState(net=net_t, opt=vt_t.opt, head_stats=net_t.init_stats(),
                       env_state=None, obs=None, generator=torch.Generator().manual_seed(0))
    state_t, metrics_t = vt_t.update(state_t, {k: torch.tensor(v) for k, v in traj.items()})
    rho = torch.cat(rhos)
    print(f"\nV-trace {kind}: rho clipped in {float((rho > 1).float().mean()):.0%} of the steps")
    assert 0.2 < float((rho > 1).float().mean()) < 0.8

    # JAX's grouping: group i is envs [i * G, (i + 1) * G), time-major
    batches = [{k: jnp.asarray(v[:, i * G:(i + 1) * G]) for k, v in traj.items()}
               for i in range(B // G)]
    loss_grad = jax.jit(jax.value_and_grad(vt_j._vtrace_loss, has_aux=True))
    losses_j = hold_steps(f"V-trace {kind}", rec.steps, losses_t, params, norm, loss_grad,
                          batches, vt_j.tx)
    hold_after(f"V-trace {kind}", state_t, net_t, metrics_t, state_j, metrics_j, losses_j,
               B // G)


def test_presets_build_and_cli_rounds_on_cpu(tmp_path, monkeypatch):
    # the presets, and what build_algo makes of them (a stub env: the
    # configuration does not depend on the env)
    monkeypatch.setattr(j_build_mod, "build_env", lambda cfg: StubEnv())
    monkeypatch.setattr(t_build_mod, "build_env", lambda cfg, device=None: StubEnv())
    for setting in PRESETS:
        for particles in (None, 8):
            cfg_j, cfg_t = j_build(setting, particles=particles), settings.build(
                setting, particles=particles)
            assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j), setting
        algo_j, algo_t = j_build_mod.build_algo(cfg_j), t_build_mod.build_algo(cfg_t)
        assert type(algo_t).__name__ == type(algo_j).__name__ == (
            "A2C" if "a3c" in setting else "VTrace")
        assert dataclasses.asdict(algo_t.cfg) == dataclasses.asdict(algo_j.cfg), setting
        if hasattr(algo_j, "vcfg"):
            assert dataclasses.asdict(algo_t.vcfg) == dataclasses.asdict(algo_j.vcfg)
        assert _net_cfg(algo_t.net.cfg) == _net_cfg(algo_j.net.cfg), setting
        print(f"\n{setting}: {type(algo_t).__name__} {dataclasses.asdict(algo_t.cfg)}", end="")
    monkeypatch.undo()

    # one tiny round through the CLI, checkpointed, and a second that resumes
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    build = settings.build

    def tiny(*args, **kwargs):
        cfg = build(*args, **kwargs)
        return dataclasses.replace(
            cfg, workers=4,
            worker=dataclasses.replace(cfg.worker, unroll_length=4,
                                       batch_size=2 if cfg.algo == "vtrace" else 4),
            network=dataclasses.replace(cfg.network, actor_shape=(32,), critic_shape=(32,)))

    monkeypatch.setattr(settings, "build", tiny)
    monkeypatch.setenv("PFPN_MEGASTEP_LINKS", "1")
    for setting, steps in (("deepmimic_a3c_pfpn", 1), ("deepmimic_impala_pfpn", 2)):
        argv = ["--env", "DeepMimicWalk-v0", "--setting", setting, "--particles", "8",
                "--seed", "5", "--train", "--device", "cpu", "--max_rounds", "1",
                "--root", str(tmp_path)]
        algo, state = cli.main(argv)
        assert type(algo).__name__ == ("A2C" if "a3c" in setting else "VTrace")
        assert (state.global_step, state.total_samples) == (steps, 16)
        cfg = tiny(setting, particles=8, env="DeepMimicWalk-v0", seed=5)
        ckpt = CheckpointManager(cfg.checkpoint_dir(str(tmp_path)))
        assert ckpt.steps() == [steps]
        fresh = t_build_mod.build_algo(cfg, "cpu")
        st = ckpt.restore_latest(fresh.init_state(torch.Generator().manual_seed(99)))
        for (k, v), v2 in zip(algo.net.state_dict().items(), fresh.net.state_dict().values()):
            assert torch.equal(v, v2), k
        sd, sd2 = algo.opt.state_dict()["state"], fresh.opt.state_dict()["state"]
        assert sd.keys() == sd2.keys() and all(
            torch.equal(sd[i]["exp_avg_sq"], sd2[i]["exp_avg_sq"]) for i in sd)
        assert st.head_stats["train_flag"] == state.head_stats["train_flag"] == steps
        algo2, state2 = cli.main(argv)
        assert (state2.global_step, state2.total_samples) == (2 * steps, 32)
        assert ckpt.steps() == [2 * steps]
