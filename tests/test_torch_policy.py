"""PyTorch port: the shipped PFPN-35 Walk policy against JAX, and the
port's guards.

* the policy npz loads into both packages (``load_jax_params`` on the
  port's side); on the same observations, made with numpy from a seed
  around the npz's normalizer statistics, the head logits and the value
  agree to 1e-5 (absolute plus relative: logits reach ~20, where 1e-5
  is five fp32 ulps of sums over 1024 terms) and the deterministic
  actions agree except in dimensions whose top two logits lie within 1e-5
  of each other;
* asking for CUDA without a card raises, and no module of ``pfpn_torch``
  imports ``jax``, ``flax``, ``optax`` or ``pfpn_tpu``.
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import pfpn_torch  # noqa: E402
from pfpn_torch.networks.actor_critic import (  # noqa: E402
    ACConfig as TACConfig, ActorCritic as TActorCritic, load_jax_params,
)
from pfpn_torch.networks.heads import ParticleHead as TParticleHead  # noqa: E402
from pfpn_tpu.networks import ACConfig, ActorCritic, ParticleHead  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "results", "policies",
                   "DeepMimicWalk-v0_deepmimic_dppo_pfpn_particle35_34114_step58608.npz")
LOGIT_TOL = 1e-5
VALUE_TOL = 1e-5
TIE_TOL = 1e-5
N_OBS = 16


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


@pytest.fixture(scope="module")
def nets():
    with np.load(NPZ) as z:
        flat = {k: z[k] for k in z.files}
    # JAX side, as tools/export_policy.py --play loads it
    params = _unflatten({k[len("params/"):]: jnp.asarray(v, jnp.float32)
                         for k, v in flat.items() if k.startswith("params/")})
    net_j = ActorCritic(ACConfig(obs_dim=197, head=ParticleHead(action_dim=36, particles=35)))
    norm = net_j.init_norm()._replace(**{k[len("norm/"):]: jnp.asarray(v, jnp.float32)
                                         for k, v in flat.items() if k.startswith("norm/")})
    # port side
    net_t = TActorCritic(TACConfig(obs_dim=197, head=TParticleHead(action_dim=36, particles=35)))
    net_t.load_state_dict(load_jax_params(flat), strict=True)
    rng = np.random.default_rng(17)
    mean, std = flat["norm/mean"], flat["norm/std"]
    obs = (mean + std * rng.standard_normal((N_OBS, 197))).astype(np.float32)
    return net_j, params, norm, net_t, obs


def test_load_jax_params_covers_the_npz(nets):
    net_t = nets[3]
    sd = net_t.state_dict()
    assert sd["head.fc_policy.weight"].shape == (1260, 512)
    assert sd["actor_trunk.layers.0.weight"].shape == (1024, 197)
    assert sd["critic.layers.2.weight"].shape == (1, 512)
    assert sd["head.particles"].shape == (36, 35)
    assert sd["norm.mean"].shape == (197,)


def test_logits_match_jax(nets):
    net_j, params, norm, net_t, obs = nets
    logits_j, loc_j, scale_j = net_j.dist(params, norm, jnp.asarray(obs))
    with torch.no_grad():
        logits_t, loc_t, scale_t = net_t.dist(torch.tensor(obs))
    print(f"\nlogits vs JAX: {np.abs(logits_t.numpy() - np.asarray(logits_j)).max():.2e}")
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_array_equal(loc_t.detach().numpy(), np.asarray(loc_j))
    np.testing.assert_allclose(scale_t.detach().numpy(), np.asarray(scale_j), rtol=1e-6, atol=0)


def test_value_matches_jax(nets):
    net_j, params, norm, net_t, obs = nets
    v_j = np.asarray(net_j.value(params, norm, jnp.asarray(obs)))
    with torch.no_grad():
        v_t = net_t.value(torch.tensor(obs)).numpy()
    assert v_t.shape == (N_OBS,)
    print(f"\nvalue vs JAX: {np.abs(v_t - v_j).max():.2e}")
    np.testing.assert_allclose(v_t, v_j, atol=VALUE_TOL, rtol=VALUE_TOL)


def test_deterministic_action_matches_jax(nets):
    net_j, params, norm, net_t, obs = nets
    a_j = np.asarray(net_j.act_deterministic(params, norm, jnp.asarray(obs)))
    with torch.no_grad():
        a_t = net_t.act_deterministic(torch.tensor(obs)).numpy()
    logits = np.asarray(net_j.dist(params, norm, jnp.asarray(obs))[0])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    near_tie = (top2[..., 1] - top2[..., 0]) < TIE_TOL
    assert a_t.shape == a_j.shape == (N_OBS, 36)
    np.testing.assert_array_equal(a_t[~near_tie], a_j[~near_tie])
    assert near_tie.mean() < 0.05


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pfpn_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        pfpn_torch.resolve_device(None)
    from pfpn_torch.envs.deepmimic import make
    with pytest.raises(RuntimeError, match="CUDA"):
        make("DeepMimicWalk-v0")


def test_port_imports_no_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "pfpn_tpu")
    pkg = os.path.dirname(pfpn_torch.__file__)
    seen = 0
    for dirpath, _, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            seen += 1
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                for name in names:
                    assert name.split(".")[0] not in banned, f"{path} imports {name}"
    assert seen >= 20
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            assert not any(n.split(".")[0] in banned for n in names)
