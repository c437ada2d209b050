"""The benchmark's plain reference: a frozen copy of the port's plain paths.

Plain PyTorch and NumPy only. Nothing here imports ``pfpn_torch``, JAX or
the JAX package, and nothing here takes what the port has made: the
reference builds its own kinematic tree, motion tables, contact set and
gains from the humanoid's tables and the motion file, and loads weights
from the same ``.npz`` or seeded initialization that the harness hands the
port. The benchmark compares what the port's timed path produced with what
this code computes from the same inputs (``portbench/judge.py``).
"""
