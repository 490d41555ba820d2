"""Recurrent layers (``paddle_tpu/nn/layer/rnn.py``): the SimpleRNN, LSTM
and GRU cells, ``RNN`` / ``BiRNN`` over a cell, and the multi-layer
``SimpleRNN`` / ``LSTM`` / ``GRU``.

The JAX package runs a whole sequence as one ``lax.scan``; the port runs
it as a Python loop over time of torch ops (a captured graph under
``jit.to_static``), with the input projection of every step in one GEMM
first (``x @ w_ih.T + b_ih``: the same sum, computed once). The
semantics are JAX's:

* gate order ``i, f, c, o`` for the LSTM (``c' = f c + i tanh(g)``, ``h'
  = o tanh(c')``) and ``r, z, c`` for the GRU, with ``r`` applied to ``h
  @ w_hh.T + b_hh`` (``rnn.py:93-106``) and ``h' = z h + (1 - z) h~``;
* ``sequence_length`` masking (``_mask_step``, ``:40``): past a row's
  length its states freeze and its outputs are zero, in either
  direction;
* batch-major unless ``time_major``; ``direction="bidirect"`` concatenates
  the two directions' outputs; the final states stack to ``[layers *
  directions, B, H]`` a component; ``dropout`` between layers in
  training;
* parameters ``weight_ih`` [gates H, in], ``weight_hh`` [gates H, H],
  ``bias_ih``, ``bias_hh``, all drawn from ``Uniform(-1/sqrt(H),
  1/sqrt(H))`` (``:125``), in the cells ``_cells_fw.0`` ... /
  ``_cells_bw.0`` ... of the multi-layer classes, the JAX names.

Under ``auto_cast`` a sequence casts as the JAX op ``{mode}_seq`` (a
cell's step as ``{mode}_cell``; on neither list), then computes in the
promoted type of its inputs, states and weights, as ``jnp`` promotes.
Initial states are f32 zeros, as in JAX.
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from .. import initializer as I
from .common import _amp_cast
from .container import LayerList
from .layers import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "LSTM", "GRU"]

_MODES = {"simple": (1, 1), "lstm": (4, 2), "gru": (3, 1)}   # gates, states
_ACT = {"tanh": torch.tanh, "relu": torch.relu}


def _promoted(tensors):
    """``tensors`` cast to their promoted dtype (``jnp``'s rule)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in tensors]


def _step(mode, act, xp, states, w_hh, b_hh):
    """One step from the input projection ``xp`` [B, gates H] and the
    states -> the new states (the output is the first)."""
    h = states[0]
    gh = h @ w_hh.T + b_hh
    if mode == "simple":
        return (act(xp + gh),)
    H = h.shape[-1]
    if mode == "lstm":
        g = xp + gh
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c = f * states[1] + i * torch.tanh(g[:, 2 * H:3 * H])
        return (o * torch.tanh(c), c)
    r = torch.sigmoid(xp[:, :H] + gh[:, :H])
    z = torch.sigmoid(xp[:, H:2 * H] + gh[:, H:2 * H])
    hc = torch.tanh(xp[:, 2 * H:] + r * gh[:, 2 * H:])
    return (z * h + (1 - z) * hc,)


def _zeros(cell, b, device, init_value=0.0):
    return tuple(torch.full((b, cell.hidden_size), init_value,
                            dtype=torch.float32, device=device)
                 for _ in range(cell.state_components))


class RNNCellBase(Layer):
    """The cells' base (``rnn.py:115``): ``get_initial_states`` gives
    ``state_components`` f32 tensors ``[B, hidden_size]`` of
    ``init_value``."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        zeros = _zeros(self, batch_ref.shape[batch_dim_idx],
                       batch_ref.device, init_value)
        return zeros[0] if len(zeros) == 1 else zeros


class _CellCommon(RNNCellBase):
    mode = "simple"

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        gates, n_state = _MODES[self.mode]
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.state_components = n_state
        self._activation = activation
        std = 1.0 / math.sqrt(hidden_size)
        init = I.Uniform(-std, std)
        self.weight_ih = self.create_parameter(
            (gates * hidden_size, input_size), weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            (gates * hidden_size, hidden_size), weight_hh_attr,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            (gates * hidden_size,), bias_ih_attr, is_bias=True,
            default_initializer=init)
        self.bias_hh = self.create_parameter(
            (gates * hidden_size,), bias_hh_attr, is_bias=True,
            default_initializer=init)

    def _states_tuple(self, states, batch_ref):
        if states is None:
            return _zeros(self, batch_ref.shape[0], batch_ref.device)
        return (states,) if torch.is_tensor(states) else tuple(states)

    def forward(self, inputs, states=None):
        """One step -> ``(h, h)``, or ``(h, (h, c))`` for the LSTM."""
        states = self._states_tuple(states, inputs)
        n = self.state_components
        x, *rest = _promoted(list(_amp_cast(
            f"{self.mode}_cell", inputs, *states, self.weight_ih,
            self.weight_hh, self.bias_ih, self.bias_hh)))
        states, (w_ih, w_hh, b_ih, b_hh) = rest[:n], rest[n:]
        new = _step(self.mode, _ACT[self._activation], x @ w_ih.T + b_ih,
                    states, w_hh, b_hh)
        return (new[0], new[0]) if n == 1 else (new[0], tuple(new))


class SimpleRNNCell(_CellCommon):
    mode = "simple"


class LSTMCell(_CellCommon):
    mode = "lstm"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(input_size, hidden_size, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype, generator=generator)


class GRUCell(_CellCommon):
    mode = "gru"

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(input_size, hidden_size, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype, generator=generator)


def _run_cell_sequence(cell, inputs, states, seq_lens, time_major, reverse):
    """The whole sequence through ``cell`` -> (outputs, tuple of final
    states)."""
    if states is None:
        states = _zeros(cell, inputs.shape[1 if time_major else 0],
                        inputs.device)
    elif torch.is_tensor(states):
        states = (states,)
    n = cell.state_components
    x, *rest = _promoted(list(_amp_cast(
        f"{cell.mode}_seq", inputs, *states, cell.weight_ih, cell.weight_hh,
        cell.bias_ih, cell.bias_hh)))
    states, (w_ih, w_hh, b_ih, b_hh) = tuple(rest[:n]), rest[n:]
    x_tm = x if time_major else x.transpose(0, 1)
    T = x_tm.shape[0]
    xp = x_tm @ w_ih.T + b_ih                     # every step's projection
    act = _ACT[getattr(cell, "_activation", "tanh")]
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        new = _step(cell.mode, act, xp[t], states, w_hh, b_hh)
        out = new[0]
        if seq_lens is not None:
            valid = (seq_lens > t)[:, None]
            new = tuple(torch.where(valid, a, b) for a, b in zip(new, states))
            out = torch.where(valid, out, 0.0)
        states, outs[t] = new, out
    outs = torch.stack(outs)
    return (outs if time_major else outs.transpose(0, 1)), states


class RNN(Layer):
    """A cell run over a sequence (``rnn.py:270``)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        outs, final = _run_cell_sequence(
            self.cell, inputs, initial_states, sequence_length,
            self.time_major, self.is_reverse)
        return outs, (final[0] if self.cell.state_components == 1
                      else final)


class BiRNN(Layer):
    """Two cells, forward and reversed, their outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = (None, None) if initial_states is None \
            else initial_states
        out_fw, fin_fw = _run_cell_sequence(
            self.cell_fw, inputs, st_fw, sequence_length, self.time_major,
            False)
        out_bw, fin_bw = _run_cell_sequence(
            self.cell_bw, inputs, st_bw, sequence_length, self.time_major,
            True)
        return torch.cat([out_fw, out_bw], -1), (fin_fw, fin_bw)


class _RNNBase(Layer):
    """``num_layers`` of cells a direction (``RNNBase``, ``rnn.py:327``)."""
    mode = "simple"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        if direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise ValueError(f"unknown direction {direction!r} (use "
                             "'forward' or 'bidirect')")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.state_components = _MODES[self.mode][1]
        cls = {"simple": SimpleRNNCell, "lstm": LSTMCell,
               "gru": GRUCell}[self.mode]
        kw = dict(weight_ih_attr=weight_ih_attr,
                  weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                  bias_hh_attr=bias_hh_attr, device=device, dtype=dtype,
                  generator=generator)
        if self.mode == "simple":
            kw["activation"] = activation
        fw, bw = [], []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 \
                else hidden_size * self.num_directions
            fw.append(cls(in_sz, hidden_size, **kw))
            if self.num_directions == 2:
                bw.append(cls(in_sz, hidden_size, **kw))
        self._cells_fw = LayerList(fw)
        self._cells_bw = LayerList(bw)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        D, L, n = self.num_directions, self.num_layers, self.state_components
        if initial_states is None:
            per_layer = [None] * (L * D)
        else:
            comps = (initial_states,) if torch.is_tensor(initial_states) \
                else tuple(initial_states)
            per_layer = [tuple(c[i] for c in comps) for i in range(L * D)]
        x = inputs
        finals = []
        for layer in range(L):
            out_fw, fin_fw = _run_cell_sequence(
                self._cells_fw[layer], x, per_layer[layer * D],
                sequence_length, self.time_major, False)
            if D == 2:
                out_bw, fin_bw = _run_cell_sequence(
                    self._cells_bw[layer], x, per_layer[layer * D + 1],
                    sequence_length, self.time_major, True)
                x = torch.cat([out_fw, out_bw], -1)
                finals += [fin_fw, fin_bw]
            else:
                x = out_fw
                finals.append(fin_fw)
            if self.dropout and layer < L - 1 and self.training:
                x = F.dropout(x, p=self.dropout)
        stacked = [torch.stack([f[c] for f in finals]) for c in range(n)]
        return x, (stacked[0] if n == 1 else tuple(stacked))


class SimpleRNN(_RNNBase):
    mode = "simple"


class LSTM(_RNNBase):
    mode = "lstm"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype, generator=generator)


class GRU(_RNNBase):
    mode = "gru"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         device=device, dtype=dtype, generator=generator)
