"""LSTM and convolution building blocks.

Counterpart of ``pfpn_tpu/networks/recurrent.py``: an LSTM layer with an
explicit carried ``(c, h)`` state, one step (:func:`lstm_cell`) or a
time-major sequence with an optional reset mask (:func:`lstm_sequence`),
and an NHWC convolution with relu6 (:func:`apply_conv`). No shipped preset
uses them; ``networks/recurrent_ac.py`` builds its trunk from the LSTM.

The cell is written out as the JAX package writes it, not as ``nn.LSTM``
(whose gate order, bias layout and forget bias differ): weights ``wi``
(in, 4h) and ``wh`` (h, 4h), one bias ``b`` (4h), gates in the order i, f,
g, o, and +1 on the forget gate inside its sigmoid:

    c' = sigmoid(f + 1) c + sigmoid(i) tanh(g),   h' = sigmoid(o) tanh(c')

The convolution keeps the JAX layouts, NHWC inputs and HWIO weights, and
pads ``"SAME"`` as XLA does: at stride s the total padding of a side is
max((ceil(n / s) - 1) s + k - n, 0), its smaller half first, so at stride
2 the extra row and column go at the end.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .mlp import truncated_normal_


class LSTMState(NamedTuple):
    c: torch.Tensor
    h: torch.Tensor


class LSTM(nn.Module):
    """The parameters of one LSTM layer, in the JAX package's layout."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.wi = nn.Parameter(torch.zeros(in_dim, 4 * hidden))
        self.wh = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.zeros(4 * hidden))

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        """init_lstm (recurrent.py:26): truncated-normal weights, zero bias."""
        truncated_normal_(self.wi, generator)
        truncated_normal_(self.wh, generator)
        self.b.zero_()


def init_lstm(in_dim: int, hidden: int, generator: Optional[torch.Generator] = None,
              device=None) -> LSTM:
    lstm = LSTM(in_dim, hidden).to(device)
    lstm.init_parameters(generator)
    return lstm


def lstm_zero_state(hidden: int, batch: Tuple[int, ...] = (), device=None) -> LSTMState:
    shape = tuple(batch) + (hidden,)
    return LSTMState(c=torch.zeros(shape, device=device), h=torch.zeros(shape, device=device))


def lstm_cell(params: LSTM, state: LSTMState, x: torch.Tensor) -> Tuple[LSTMState, torch.Tensor]:
    """One step (recurrent.py:40): (new state, h)."""
    gates = x @ params.wi + state.h @ params.wh + params.b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * state.c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return LSTMState(c=c, h=h), h


def lstm_sequence(params: LSTM, state: LSTMState, xs: torch.Tensor,
                  seq_mask: Optional[torch.Tensor] = None) -> Tuple[LSTMState, torch.Tensor]:
    """Step through ``xs`` [T, ...]; where ``seq_mask`` [T, ...] is 0 the
    state and output after that step are zeroed (recurrent.py:48). Returns
    (final state, hs [T, ..., hidden])."""
    hs = []
    for t in range(xs.shape[0]):
        state, h = lstm_cell(params, state, xs[t])
        if seq_mask is not None:
            keep = seq_mask[t][..., None].to(h.dtype)
            state = LSTMState(c=state.c * keep, h=state.h * keep)
            h = h * keep
        hs.append(h)
    return state, torch.stack(hs)


class Conv(nn.Module):
    """The parameters of one convolution: ``w`` (k, k, in, out), ``b`` (out,)."""

    def __init__(self, in_ch: int, out_ch: int, ksize: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(ksize, ksize, in_ch, out_ch))
        self.b = nn.Parameter(torch.zeros(out_ch))

    @torch.no_grad()
    def init_parameters(self, generator: Optional[torch.Generator]) -> None:
        """init_conv (recurrent.py:70): truncated-normal weights, zero bias."""
        truncated_normal_(self.w, generator)
        self.b.zero_()


def init_conv(in_ch: int, out_ch: int, ksize: int,
              generator: Optional[torch.Generator] = None, device=None) -> Conv:
    conv = Conv(in_ch, out_ch, ksize).to(device)
    conv.init_parameters(generator)
    return conv


def _same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one side: (before, after)."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def apply_conv(params: Conv, x: torch.Tensor, stride: int = 1, padding: str = "SAME",
               activation: Optional[Callable] = F.relu6) -> torch.Tensor:
    """NHWC convolution (recurrent.py:77; reference ops.py:40-80)."""
    kh, kw = params.w.shape[:2]
    y = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        top, bottom = _same_padding(y.shape[2], kh, stride)
        left, right = _same_padding(y.shape[3], kw, stride)
        y = F.pad(y, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")
    y = F.conv2d(y, params.w.permute(3, 2, 0, 1), params.b, stride=stride)
    y = y.permute(0, 2, 3, 1)
    return activation(y) if activation is not None else y
