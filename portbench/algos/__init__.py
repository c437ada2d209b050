"""Training algorithms, one module each, chosen by a configuration file's
``algorithm`` key: ``algos/<algorithm>.py`` (``a2c``, ``ppo``).

A module owns what is specific to its algorithm, and defines:

* ``build(cfg, traffic, device)``: the port's algorithm, built through
  ``program.build_train`` and refused where it departs from the
  configuration (or from the traffic's overrides of its sizes);
* ``watch(algo, on)``: wraps the built algorithm so that, while ``on()``,
  each set-up update leaves what the reference follows; returns the dict it
  fills: ``losses`` (each optimizer step's loss), ``grad1`` (the first
  clipped gradient, from Adam's state after the first step), ``params``
  (after ``STEPS`` steps), ``before`` (one entry per update, e.g. the
  minibatch permutation) and, where the module judges each step,
  ``trail`` (``_actor_critic.watch``);
* ``reference_net(cfg, device, state=None, seed=None)``: the reference's
  network, with ``state``, the configuration's ``.npz`` by the reference's
  own loader, or (``"seeded"`` weights) the reference's initialization drawn
  on ``device`` from ``seed``;
* ``STEPS``: the optimizer steps the reference follows from the first
  weights: each one's loss and the parameters' change after the last are
  compared;
* ``ref_updates(cell, upd, device, judge_round=None, fault=None)``: the
  reference's updates from ``upd["w0"]`` on the port's rounds, as a dict
  that can stand in the port's ``upd``: ``losses`` (each step's),
  ``grad1`` (the first clipped gradients), ``params`` (after ``STEPS``
  steps), and what else the module's own numbers read (``trail``);
  ``judge_round(k, net)`` runs before round k; ``fault`` plants one of
  ``FAULTS`` in the reference;
* ``unchanged(upd)``: ``upd`` as the port's would read had each optimizer
  step returned the state unchanged (a planted fault);
* ``judge_steps(cell, upd, device)`` (optional): numbers of the module's
  own, e.g. each step of the set-up rounds judged from the port's state
  ahead of it, where following from the first weights cannot reach;
* ``LOSS_AGAINST_MEDIAN`` (optional, false by default): each loss's gap
  is taken against the reference's loss or the median loss, whichever is
  larger in magnitude (``judge.loss_gap``);
* ``update_flops(cfg, algo)``: the operations of one round's update
  (``counts/policy.py``'s passes), for ``mfu``.

``loops/train.py`` runs any algorithm whose rounds are
``train_round = rollout + update`` (PPO's machinery); one that is not
brings a loop of its own (``loops/<loop>.py``, named by its traffic).
"""

import importlib


def load(name: str):
    """``algos/<name>.py``."""
    return importlib.import_module(f"portbench.algos.{name}")
