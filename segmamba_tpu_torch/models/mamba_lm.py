"""The Mamba language model: single-direction mixer with a decode cache,
prenorm block, backbone and tied LM head with generation, PyTorch.

Port of ``segmamba_tpu/models/mamba_lm.py`` (``MambaUni``, ``Block``,
``MixerModel``, ``MambaLMHeadModel``). Parameter names are the reference
torch model's (``backbone.embedding.weight``,
``backbone.layers.{i}.mixer.in_proj.weight``, ``.conv1d``, ``.x_proj``,
``.dt_proj``, ``.A_log``, ``.D``, ``.out_proj``, ``.norm``,
``backbone.norm_f``), so a ``state-spaces/mamba-*`` state dict loads with
``strict=True`` once its tied ``lm_head.weight`` is dropped
(``utils/hf.py``): the head is the embedding.

Serving path: ``MambaLMHeadModel.generate`` runs one parallel prefill
(``MixerModel.prefill`` -> ``MambaUni.forward_with_cache``: one
``selective_scan`` per layer with ``return_last_state``, the K6 kernel for
CUDA tensors, whose last state seeds the decode cache), then a Python loop
of ``step``s (``causal_conv1d_update`` + ``selective_state_update`` per
layer, plain torch). The full forward ``MambaLMHeadModel.__call__`` runs
``mamba_inner``, the fused K2 kernel on the card. With
``scan_impl="mxu"`` the prefill and the full forward (and their
gradients) run the ratio-form scan K7 (``scan_mxu``) instead; decoding
stays ``selective_state_update``.

Parameters are float32; compute runs in ``dtype`` by casting the weights
per call (no autocast); norms, the residual stream and the logits are
float32. Sequences are time-major (batch, L, d_model).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from segmamba_tpu_torch.models.layers import (
    torch_bias_uniform,
    torch_kaiming_uniform,
    uniform,
)
from segmamba_tpu_torch.models.mamba import (
    _a_log_init,
    _dt_bias_init,
    _Params,
)
from segmamba_tpu_torch.ops.causal_conv1d import (
    causal_conv1d,
    causal_conv1d_update,
)
from segmamba_tpu_torch.ops.fused_norm import layer_norm_fn, rms_norm_fn
from segmamba_tpu_torch.ops.mamba_inner import mamba_inner
from segmamba_tpu_torch.ops.selective_scan import selective_scan
from segmamba_tpu_torch.ops.selective_state_update import (
    selective_state_update,
)


def _generator(generator):
    return torch.Generator().manual_seed(0) if generator is None else generator


class MambaUni(nn.Module):
    """Uni-directional selective-state-space mixer with decode cache
    support. Arguments mirror the JAX ``MambaUni``; ``scan_impl`` is
    ``mamba_inner``'s / ``selective_scan``'s ``impl``."""

    def __init__(self, d_model, d_state=16, d_conv=4, expand=2, dt_rank=None,
                 dt_min=0.001, dt_max=0.1, dt_init_floor=1e-4,
                 conv_bias=True, scan_impl="auto", *, dtype=torch.float32,
                 generator=None):
        super().__init__()
        g = _generator(generator)
        self.d_model, self.d_state, self.d_conv = d_model, d_state, d_conv
        self.d_inner = E = expand * d_model
        self.dt_rank = R = dt_rank or math.ceil(d_model / 16)
        self.scan_impl, self.dtype = scan_impl, dtype
        self.in_proj = _Params(torch_kaiming_uniform((2 * E, d_model),
                                                     d_model, g))
        self.conv1d = _Params(
            torch_kaiming_uniform((E, 1, d_conv), d_conv, g),
            torch_bias_uniform((E,), d_conv, g) if conv_bias else None)
        self.x_proj = _Params(torch_kaiming_uniform((R + 2 * d_state, E), E,
                                                    g))
        self.dt_proj = _Params(
            uniform((E, R), R ** -0.5, g),
            _dt_bias_init((E,), dt_min, dt_max, dt_init_floor, g))
        self.A_log = nn.Parameter(_a_log_init(E, d_state).to(g.device))
        self.D = nn.Parameter(torch.ones(E, device=g.device))
        self.out_proj = _Params(torch_kaiming_uniform((d_model, E), E, g))

    def _weights(self):
        """conv (W, E) and bias, x_proj (E, R+2N), dt_proj (R, E) in
        ``dtype``; dt bias, A = -exp(A_log) and D in float32."""
        dt = self.dtype
        conv = self.conv1d
        return (conv.weight[:, 0, :].t().to(dt),
                None if conv.bias is None else conv.bias.to(dt),
                self.x_proj.weight.t().to(dt), self.dt_proj.weight.t().to(dt),
                self.dt_proj.bias.float(), -torch.exp(self.A_log.float()),
                self.D.float())

    def _split(self, x_db):
        R, N = self.dt_rank, self.d_state
        return x_db[..., :R], x_db[..., R:R + N], x_db[..., R + N:]

    def forward(self, hidden_states):
        """(batch, L, d_model) -> same, in ``dtype``."""
        dt = self.dtype
        xz = F.linear(hidden_states.to(dt), self.in_proj.weight.to(dt))
        y = mamba_inner(xz, *self._weights(), d_state=self.d_state,
                        impl=self.scan_impl)
        return F.linear(y, self.out_proj.weight.to(dt))

    def init_cache(self, batch):
        """Zero decode cache: conv window (batch, d_conv, d_inner) and SSM
        state (batch, d_inner, d_state), float32."""
        f32 = dict(dtype=torch.float32, device=self.A_log.device)
        return {"conv": torch.zeros(batch, self.d_conv, self.d_inner, **f32),
                "ssm": torch.zeros(batch, self.d_inner, self.d_state, **f32)}

    def forward_with_cache(self, hidden_states):
        """Parallel prefill: one full-sequence scan and the decode cache it
        ends in. Returns ((batch, L, d_model), cache)."""
        dt = self.dtype
        conv_w, conv_b, x_proj, dt_proj, dt_bias, A, D = self._weights()
        xz = F.linear(hidden_states.to(dt), self.in_proj.weight.to(dt))
        E = self.d_inner
        x, z = xz[..., :E], xz[..., E:]
        xc = causal_conv1d(x, conv_w, conv_b, activation="silu")
        dtr, B, C = self._split(xc @ x_proj)
        y, last = selective_scan(
            xc, dtr @ dt_proj, A, B, C, D=D, z=z, delta_bias=dt_bias,
            delta_softplus=True, return_last_state=True, impl=self.scan_impl)
        out = F.linear(y, self.out_proj.weight.to(dt))
        # conv cache: the last d_conv RAW x tokens, left-padded with zeros
        # for short prompts (a copy: no view keeps xz alive)
        batch, L, _ = x.shape
        n = min(L, self.d_conv)
        conv = x.new_zeros(batch, self.d_conv, E, dtype=torch.float32)
        conv[:, self.d_conv - n:] = x[:, L - n:]
        return out, {"conv": conv, "ssm": last.float()}

    def step(self, hidden_state, cache):
        """One decode token: (batch, d_model), cache -> (out, new_cache)."""
        dt = self.dtype
        conv_w, conv_b, x_proj, dt_proj, dt_bias, A, D = self._weights()
        xz = F.linear(hidden_state.to(dt), self.in_proj.weight.to(dt))
        E = self.d_inner
        x, z = xz[..., :E], xz[..., E:]
        x, conv = causal_conv1d_update(x, cache["conv"], conv_w, conv_b,
                                       activation="silu")
        dtr, B, C = self._split(x @ x_proj)
        y, ssm = selective_state_update(cache["ssm"], x, dtr @ dt_proj, A, B,
                                        C, D=D, z=z, dt_bias=dt_bias,
                                        dt_softplus=True)
        return F.linear(y, self.out_proj.weight.to(dt)), {"conv": conv,
                                                          "ssm": ssm}


class Block(nn.Module):
    """Prenorm residual block: out = mixer(norm(x + residual)), the add and
    norm fused (``ops.fused_norm``), the residual carried in float32."""

    def __init__(self, d_model, norm_eps=1e-5, rms_norm=False,
                 residual_in_fp32=True, mixer_kwargs=None, *,
                 dtype=torch.float32, generator=None):
        super().__init__()
        g = _generator(generator)
        self.norm_eps, self.rms_norm = norm_eps, rms_norm
        self.residual_in_fp32 = residual_in_fp32
        self.mixer = MambaUni(d_model, dtype=dtype, generator=g,
                              **(mixer_kwargs or {}))
        self.norm = _Params(torch.ones(d_model, device=g.device),
                            None if rms_norm else
                            torch.zeros(d_model, device=g.device))

    def _addnorm(self, x, residual):
        fn = rms_norm_fn if self.rms_norm else layer_norm_fn
        return fn(x, self.norm.weight, self.norm.bias, residual=residual,
                  prenorm=True, residual_in_fp32=self.residual_in_fp32,
                  eps=self.norm_eps)

    def forward(self, hidden_states, residual=None):
        normed, residual = self._addnorm(hidden_states, residual)
        return self.mixer(normed), residual

    def step(self, hidden_state, residual, cache):
        normed, residual = self._addnorm(hidden_state, residual)
        out, cache = self.mixer.step(normed, cache)
        return out, residual, cache

    def forward_with_cache(self, hidden_states, residual=None):
        normed, residual = self._addnorm(hidden_states, residual)
        out, cache = self.mixer.forward_with_cache(normed)
        return out, residual, cache

    def init_cache(self, batch):
        return self.mixer.init_cache(batch)


class MixerModel(nn.Module):
    """Embedding + n_layer Blocks + final norm."""

    def __init__(self, vocab_size, d_model, n_layer, rms_norm=False,
                 norm_eps=1e-5, scan_impl="auto", *, dtype=torch.float32,
                 generator=None):
        super().__init__()
        g = _generator(generator)
        self.rms_norm, self.norm_eps, self.dtype = rms_norm, norm_eps, dtype
        self.embedding = _Params(0.02 * torch.randn(
            vocab_size, d_model, generator=g, device=g.device))
        self.layers = nn.ModuleList(
            Block(d_model, norm_eps=norm_eps, rms_norm=rms_norm,
                  mixer_kwargs={"scan_impl": scan_impl}, dtype=dtype,
                  generator=g) for _ in range(n_layer))
        self.norm_f = _Params(torch.ones(d_model, device=g.device),
                              None if rms_norm else
                              torch.zeros(d_model, device=g.device))

    def _embed(self, ids):
        return F.embedding(ids, self.embedding.weight).to(self.dtype)

    def _final_norm(self, x, residual):
        fn = rms_norm_fn if self.rms_norm else layer_norm_fn
        return fn(x, self.norm_f.weight, self.norm_f.bias, residual=residual,
                  prenorm=False, eps=self.norm_eps)

    def forward(self, input_ids):
        """(batch, L) token ids -> normed hidden states (batch, L, d)."""
        h, residual = self._embed(input_ids), None
        for blk in self.layers:
            h, residual = blk(h, residual)
        return self._final_norm(h, residual)

    def step(self, token_ids, caches):
        """(batch,) token ids, caches -> (normed (batch, d), new caches)."""
        h, residual = self._embed(token_ids), None
        new_caches = []
        for blk, cache in zip(self.layers, caches):
            h, residual, cache = blk.step(h, residual, cache)
            new_caches.append(cache)
        return self._final_norm(h, residual), new_caches

    def prefill(self, input_ids):
        """Parallel-scan prefill: (batch, L) -> (normed (batch, L, d),
        caches)."""
        h, residual = self._embed(input_ids), None
        caches = []
        for blk in self.layers:
            h, residual, cache = blk.forward_with_cache(h, residual)
            caches.append(cache)
        return self._final_norm(h, residual), caches

    def init_cache(self, batch):
        return [blk.init_cache(batch) for blk in self.layers]


class MambaLMHeadModel(nn.Module):
    """MixerModel + tied LM head + generation.

    ``vocab_size`` is rounded up to a multiple of
    ``pad_vocab_size_multiple``, as the reference model does (its
    published configs pad 50277 to 50280); the logits have that width.
    """

    def __init__(self, vocab_size, d_model, n_layer, rms_norm=False,
                 scan_impl="auto", pad_vocab_size_multiple=1, *,
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        vocab_size = -(-vocab_size // pad_vocab_size_multiple) * (
            pad_vocab_size_multiple)
        self.vocab_size, self.d_model, self.n_layer = (vocab_size, d_model,
                                                       n_layer)
        self.backbone = MixerModel(vocab_size, d_model, n_layer,
                                   rms_norm=rms_norm, scan_impl=scan_impl,
                                   dtype=dtype, generator=generator)
        if device is not None:
            self.to(device)

    def _logits(self, h):
        """Tied head: float32 logits against the embedding."""
        return F.linear(h.float(), self.backbone.embedding.weight.float())

    def forward(self, input_ids):
        """(batch, L) -> float32 logits (batch, L, vocab)."""
        return self._logits(self.backbone(input_ids))

    def generate(self, input_ids, max_new_tokens, temperature=0.0,
                 generator=None):
        """One parallel prefill, then a Python loop of ``step``s: greedy
        at temperature 0, else sampling from softmax(logits / temperature)
        with ``generator`` (on the model's device). Returns the prompt
        followed by the new tokens, (batch, L + max_new_tokens)."""
        with torch.inference_mode():
            h, caches = self.backbone.prefill(input_ids)
            logits = self._logits(h[:, -1])
            toks = []
            for i in range(max_new_tokens):
                if temperature <= 0.0:
                    tok = logits.argmax(-1)
                else:
                    probs = torch.softmax(logits / temperature, -1)
                    tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
                toks.append(tok)
                if i + 1 < max_new_tokens:   # the last token needs no step
                    h, caches = self.backbone.step(tok, caches)
                    logits = self._logits(h)
            new = (torch.stack(toks, 1) if toks
                   else input_ids.new_zeros(input_ids.shape[0], 0))
            return torch.cat([input_ids, new.to(input_ids.dtype)], 1)
