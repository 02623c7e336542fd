"""Recurrent layers — the port of ``bigdl_tpu.nn.rnn``: SimpleRNN, LSTM,
LSTMPeephole and GRU over (batch, time, features), with BiRecurrent,
TimeDistributed, RecurrentDecoder, Recurrent and MultiRNNCell.

As in the JAX package, the input projection of every time step is one
product (``x @ w_in + bias``, all steps at once), and a loop over time
then runs only the recurrence ``h @ w_rec`` and the gates.  The JAX
package leaves the loop to ``lax.scan``; here it is a Python loop of
plain PyTorch, which a captured step (``TrainStep.train_bundle``)
replays as one CUDA graph.  A 0/1 ``mask`` (batch, time) carries the
state through masked steps and zeroes their outputs.  Gate orders and
parameter names are the JAX package's (``w_in`` (in, g*h), ``w_rec``
(h, g*h), ``bias`` (g*h); LSTM gates i, f, g, o with the forget bias at
1; GRU r, z, n with the reset gate after the recurrent product;
``peep`` (3, h) rows i, f, o), and products go through
``tensor.policy`` as ``cast_compute`` does there."""

import copy
from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.nn import init as init_mod
from bigdl_tpu_torch.nn.layers import _LazyWidth, _materialize
from bigdl_tpu_torch.nn.module import Module, _takes_key
from bigdl_tpu_torch.tensor.policy import matmul_f32
from bigdl_tpu_torch.utils.convert import INLINED


class _RNNBase(_LazyWidth, Module):
    """The time loop shared by the cells; a subclass defines
    ``_step(carry, x_proj) -> (carry, h)``.  ``input_size=None`` takes
    the width from the first input."""

    n_gates = 1

    def __init__(self, input_size: Optional[int], hidden_size: int,
                 return_sequences: bool = True, go_backwards: bool = False,
                 weight_init=init_mod.xavier,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self._init = (weight_init, generator)
        if input_size is None:
            for p in self._param_names():
                setattr(self, p, nn.parameter.UninitializedParameter())
            self._defer()
        else:
            for p, t in self._draw(input_size).items():
                setattr(self, p, nn.Parameter(t))

    def _param_names(self):
        return ("w_in", "w_rec", "bias")

    def _draw(self, d: int) -> dict:
        weight_init, g = self._init
        h, gh = self.hidden_size, self.n_gates * self.hidden_size
        return {"w_in": weight_init(g, (d, gh), d, gh),
                "w_rec": weight_init(g, (h, gh), h, gh),
                "bias": torch.zeros(gh)}

    def _build(self, width: int, device) -> None:
        self.input_size = width
        for p, t in self._draw(width).items():
            _materialize(getattr(self, p), t, device)

    def redraw(self) -> None:
        """Draw fresh weights (BiRecurrent's backward copy)."""
        with torch.no_grad():
            for p, t in self._draw(self.input_size).items():
                getattr(self, p).copy_(t)

    def _project(self, x):
        """``x @ w_in + bias`` in the compute dtype, float32 sums, in
        ``x``'s dtype."""
        return (matmul_f32(x, self.w_in) + self.bias).to(x.dtype)

    def _rec(self, h):
        return matmul_f32(h, self.w_rec).to(h.dtype)

    def _step(self, carry, x_proj):
        raise NotImplementedError

    def _init_carry(self, batch: int, dtype, device):
        return torch.zeros(batch, self.hidden_size, dtype=dtype,
                           device=device)

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        """The zero carry a decode starts from."""
        return self._init_carry(batch, dtype, device)

    def _final_output(self, carry):
        return carry

    def forward(self, x, mask=None, initial_state=None):
        b, t, _ = x.shape
        x_proj = self._project(x)
        if self.go_backwards:
            x_proj = torch.flip(x_proj, (1,))
            if mask is not None:
                mask = torch.flip(mask, (1,))
        carry = (initial_state if initial_state is not None
                 else self._init_carry(b, x.dtype, x.device))
        outs = []
        for i in range(t):
            new_carry, out = self._step(carry, x_proj[:, i])
            if mask is not None:
                m = mask[:, i].bool()[:, None]
                new_carry = _tree_where(m, new_carry, carry)
                out = torch.where(m, out, torch.zeros_like(out))
            carry = new_carry
            outs.append(out)
        if not self.return_sequences:
            return self._final_output(carry)
        outs = torch.stack(outs, 1)
        return torch.flip(outs, (1,)) if self.go_backwards else outs

    def step(self, carry, x_t):
        """One decode step: ``x_t`` (b, d) -> (new carry, h (b,
        hidden)); carries keep a leading dim of batch x beam."""
        return self._step(carry, self._project(x_t))


def _tree_where(m, new, old):
    if isinstance(new, tuple):
        return tuple(_tree_where(m, n, o) for n, o in zip(new, old))
    return torch.where(m, new, old)


class SimpleRNN(_RNNBase):
    """tanh RNN: h = tanh(x w_in + b + h w_rec)."""

    n_gates = 1

    def _step(self, h, x_proj):
        new_h = torch.tanh(x_proj + self._rec(h))
        return new_h, new_h


class LSTM(_RNNBase):
    """LSTM, gates i, f, g, o; the forget gate's bias starts at 1."""

    n_gates = 4

    def _draw(self, d: int) -> dict:
        params = super()._draw(d)
        h = self.hidden_size
        params["bias"][h:2 * h] = 1.0
        return params

    def _init_carry(self, batch, dtype, device):
        z = torch.zeros(batch, self.hidden_size, dtype=dtype, device=device)
        return (z, z)

    def _step(self, carry, x_proj):
        h_prev, c_prev = carry
        i, f, g, o = torch.chunk(x_proj + self._rec(h_prev), 4, dim=-1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h

    def _final_output(self, carry):
        return carry[0]


class LSTMPeephole(LSTM):
    """LSTM with peepholes: the input and forget gates see the previous
    cell state, the output gate the new one, through per-unit weights
    ``peep`` (rows i, f, o; zeros at init)."""

    def _param_names(self):
        return super()._param_names() + ("peep",)

    def _draw(self, d: int) -> dict:
        params = super()._draw(d)
        params["peep"] = torch.zeros(3, self.hidden_size)
        return params

    def _step(self, carry, x_proj):
        h_prev, c_prev = carry
        i, f, g, o = torch.chunk(x_proj + self._rec(h_prev), 4, dim=-1)
        peep = self.peep.to(c_prev.dtype)
        i = torch.sigmoid(i + peep[0] * c_prev)
        f = torch.sigmoid(f + peep[1] * c_prev)
        c = f * c_prev + i * torch.tanh(g)
        o = torch.sigmoid(o + peep[2] * c)
        h = o * torch.tanh(c)
        return (h, c), h


class GRU(_RNNBase):
    """GRU, gates r, z, n, the reset gate applied after the recurrent
    product (``r * (h @ U)``, keras' ``reset_after=True``).
    ``recurrent_bias=True`` adds the JAX layer's optional ``bias_rec``
    (3h, zeros at init) to that product, as its stock-keras importer
    sets it."""

    n_gates = 3

    def __init__(self, input_size, hidden_size, *args,
                 recurrent_bias: bool = False, **kw):
        self.recurrent_bias = recurrent_bias
        super().__init__(input_size, hidden_size, *args, **kw)

    def _param_names(self):
        return super()._param_names() + (
            ("bias_rec",) if self.recurrent_bias else ())

    def _draw(self, d: int) -> dict:
        params = super()._draw(d)
        if self.recurrent_bias:
            params["bias_rec"] = torch.zeros(3 * self.hidden_size)
        return params

    def _step(self, h_prev, x_proj):
        rec = self._rec(h_prev)
        if self.recurrent_bias:
            rec = rec + self.bias_rec.to(rec.dtype)
        xr, xz, xn = torch.chunk(x_proj, 3, dim=-1)
        hr, hz, hn = torch.chunk(rec, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        new_h = (1 - z) * n + z * h_prev
        return new_h, new_h


# the reference's tanh cell
RnnCell = SimpleRNN


class BiRecurrent(Module):
    """Runs ``fwd`` forward and ``bwd`` (by default a copy of ``fwd``
    with fresh weights) backward in time; ``merge`` ``"concat"`` joins
    the two on features, anything else sums them."""

    def __init__(self, fwd: _RNNBase, bwd: Optional[_RNNBase] = None,
                 merge: str = "concat", name=None):
        super().__init__(name)
        self.fwd = fwd
        if bwd is None:
            bwd = copy.deepcopy(fwd)
            if bwd.input_size is not None:
                bwd.redraw()
        bwd.go_backwards = True
        self.bwd = bwd
        self.merge = merge

    def forward(self, x, mask=None):
        yf = self.fwd(x, mask=mask)
        yb = self.bwd(x, mask=mask)
        if self.merge == "concat":
            return torch.cat([yf, yb], dim=-1)
        return yf + yb


class TimeDistributed(Module):
    """Applies ``layer`` at every time step, time folded into the batch
    (one product).  Its variables are ``layer``'s own, as in the JAX
    package."""

    def __init__(self, layer: nn.Module, name=None):
        super().__init__(name)
        self.add_module(INLINED, layer)

    @property
    def layer(self) -> nn.Module:
        return getattr(self, INLINED)

    def forward(self, x, key=None):
        b, t = x.shape[:2]
        flat = x.reshape((b * t,) + tuple(x.shape[2:]))
        y = (self.layer(flat, key=key) if key is not None
             and _takes_key(self.layer) else self.layer(flat))
        return y.reshape((b, t) + tuple(y.shape[1:]))


class RecurrentDecoder(Module):
    """Feeds its own output back for ``seq_length`` steps from the first
    input ``x`` (b, d): ``cell.step`` on a zero carry, then
    ``output_layer`` (params ``out``) when given.  The cell's width must
    take its own output."""

    def __init__(self, cell: _RNNBase, seq_length: int,
                 output_layer: Optional[nn.Module] = None, name=None):
        super().__init__(name)
        self.cell = cell
        self.seq_length = seq_length
        self.out = output_layer

    def forward(self, x):
        carry = self.cell.init_carry(x.shape[0], x.dtype, x.device)
        inp, outs = x, []
        for _ in range(self.seq_length):
            carry, h = self.cell.step(carry, inp)
            inp = h if self.out is None else self.out(h)
            outs.append(inp)
        return torch.stack(outs, 1)


class Recurrent(Module):
    """The reference's container over a cell (``Recurrent().add(cell)``);
    its variables are the cell's own."""

    def __init__(self, cell: Optional[_RNNBase] = None, name=None):
        super().__init__(name)
        if cell is not None:
            self.add(cell)

    def add(self, cell: _RNNBase) -> "Recurrent":
        self.add_module(INLINED, cell)
        return self

    @property
    def cell(self) -> Optional[_RNNBase]:
        return self._modules.get(INLINED)

    def forward(self, x, mask=None):
        if self.cell is None:
            raise RuntimeError("Recurrent: add(cell) first")
        return self.cell(x, mask=mask)


class MultiRNNCell(Module):
    """Cells applied in sequence (``cell{i}``): a sequence layer, or a
    decode cell through ``step`` / ``init_carry``."""

    def __init__(self, cells, name=None):
        super().__init__(name)
        if not cells:
            raise ValueError("MultiRNNCell needs at least one cell")
        for i, cell in enumerate(cells):
            self.add_module(f"cell{i}", cell)
        self.hidden_size = cells[-1].hidden_size

    @property
    def cells(self):
        return list(self._modules.values())

    def forward(self, x, mask=None):
        for cell in self.cells:
            x = cell(x, mask=mask)
        return x

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        return tuple(c.init_carry(batch, dtype, device) for c in self.cells)

    def step(self, carry, x_t):
        new = []
        for c, cell in zip(carry, self.cells):
            c, x_t = cell.step(c, x_t)
            new.append(c)
        return tuple(new), x_t
