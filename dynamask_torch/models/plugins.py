"""Backbone block plugins (port of ``dynamask_tpu/models/plugins.py``):
GCNet's ``ContextBlock`` and ``GeneralizedAttention``, the modules the
gcnet and empirical_attention configs put into a ResNet's bottlenecks
through ``backbone.plugins`` (``models/resnet.py`` places them).

Each computes the JAX module's function, under mmcv's parameter names:

* ``ContextBlock`` (JAX ``:37-63``): one context vector per image, pooled
  by a softmax over the positions of the ``conv_mask`` logits
  (``pooling_type='att'``) or by the mean (``'avg'``), through
  ``channel_add_conv`` (1x1 conv, LayerNorm at flax's epsilon 1e-6, ReLU,
  1x1 conv, the last zero at init) and added at every position.
* ``GeneralizedAttention`` (JAX ``:66-179``): attention over the map with
  the energy terms ``attention_type`` switches on (content x content,
  content x relative position, a learned bias x content, a learned bias x
  relative position), the position terms factored per axis,
  ``spatial_range`` masking keys outside a square neighbourhood, keys and
  values at ``kv_stride``, queries at ``q_stride`` and the output brought
  back by JAX's nearest resize. The energy and the attention are fp32 in
  any input type, as JAX takes them. Where JAX parts from mmcv (the
  position embedding's width and frequencies, no ``gamma`` and no
  ``proj_conv`` bias) the port computes JAX's function (ROADMAP.md queue
  3, 3an).
"""

from __future__ import annotations

import inspect
import math
from typing import Sequence

import torch
import torch.nn as nn


class ContextBlock(nn.Module):
    """GCNet's global-context block; mmcv's ``_abbr_`` names it."""

    abbr = 'context_block'

    def __init__(self, in_channels: int, ratio: float = 1.0 / 16,
                 pooling_type: str = 'att',
                 fusion_types: Sequence[str] = ('channel_add',)):
        super().__init__()
        if pooling_type not in ('att', 'avg') or tuple(fusion_types) != (
                'channel_add',):
            raise NotImplementedError(
                f'ContextBlock pooling_type={pooling_type!r}, fusion_types='
                f'{fusion_types}: the JAX package computes att or avg pooling'
                ' and channel_add (ROADMAP.md queue 3, 3w)')
        c, planes = in_channels, max(int(in_channels * ratio), 1)
        self.pooling_type = pooling_type
        if pooling_type == 'att':
            self.conv_mask = nn.Conv2d(c, 1, 1)
        ln = nn.LayerNorm([planes, 1, 1], eps=1e-6)
        ln.init_fill = {'weight': 1.0, 'bias': 0.0}
        self.channel_add_conv = nn.Sequential(
            nn.Conv2d(c, planes, 1), ln, nn.ReLU(), nn.Conv2d(planes, c, 1))
        # flax's Dense defaults (LeCun normal), the last zero (JAX :58-62)
        self.channel_add_conv[0].init_rule = 'lecun'
        self.channel_add_conv[3].init_rule = 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        if self.pooling_type == 'att':
            attn = torch.softmax(self.conv_mask(x).reshape(n, -1), dim=1)
            context = torch.einsum('ncp,np->nc', x.reshape(n, c, -1), attn)
        else:
            context = x.mean((2, 3))
        return x + self.channel_add_conv(context[:, :, None, None])


def jax_nearest_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(..., 'nearest')`` of an NCHW map: output i reads
    input ``floor((i + 0.5) * in / out)`` on each axis, in fp32."""
    def index(n_in: int, n_out: int) -> torch.Tensor:
        pos = (torch.arange(n_out, dtype=torch.float32, device=x.device) +
               0.5) * n_in / n_out
        return pos.floor().long()
    return x[:, :, index(x.shape[2], h)][:, :, :, index(x.shape[3], w)]


class GeneralizedAttention(nn.Module):
    """The empirical-attention block; mmcv's ``_abbr_`` names it."""

    abbr = 'gen_attention_block'

    def __init__(self, in_channels: int, spatial_range: int = -1,
                 num_heads: int = 9, position_embedding_dim: int = -1,
                 position_magnitude: int = 1, kv_stride: int = 2,
                 q_stride: int = 1, attention_type: str = '1111'):
        super().__init__()
        c = in_channels
        self.at = [t == '1' for t in attention_type]
        self.heads, self.spatial_range = num_heads, spatial_range
        self.kv_stride, self.q_stride = kv_stride, q_stride
        self.magnitude = float(position_magnitude)
        self.qk_dim = self.v_dim = c // num_heads
        self.pe_dim = (position_embedding_dim if position_embedding_dim > 0
                       else c)
        out_c = self.qk_dim * num_heads
        at = self.at
        # flax's defaults (LeCun normal) for every conv and dense layer
        lecun = []
        if at[0] or at[1]:
            self.query_conv = nn.Conv2d(c, out_c, 1, bias=False)
            lecun.append(self.query_conv)
        if at[0] or at[2]:
            self.key_conv = nn.Conv2d(c, out_c, 1, bias=False)
            lecun.append(self.key_conv)
        self.value_conv = nn.Conv2d(c, self.v_dim * num_heads, 1, bias=False)
        if at[1] or at[3]:
            width = 2 * (self.pe_dim // 2)
            self.appr_geom_fc_x = nn.Linear(width, out_c, bias=False)
            self.appr_geom_fc_y = nn.Linear(width, out_c, bias=False)
            lecun += [self.appr_geom_fc_x, self.appr_geom_fc_y]
        # the learned biases, (heads, qk_dim) in JAX, flat in mmcv
        self.init_std = {}
        if at[2]:
            self.appr_bias = nn.Parameter(torch.empty(out_c))
            self.init_std['appr_bias'] = 0.01
        if at[3]:
            self.geom_bias = nn.Parameter(torch.empty(out_c))
            self.init_std['geom_bias'] = 0.01
        self.proj_conv = nn.Conv2d(self.v_dim * num_heads, c, 1, bias=False)
        for m in lecun + [self.value_conv, self.proj_conv]:
            m.init_rule = 'lecun'

    def _rel_embed(self, nq: int, nk: int, fc: nn.Linear,
                   device) -> torch.Tensor:
        """(nq, nk, heads, qk_dim): the projected sinusoid embedding of
        each query-key offset along one axis (JAX ``rel_embed``)."""
        qs = torch.arange(nq, dtype=torch.float32,
                          device=device) * self.q_stride
        ks = torch.arange(nk, dtype=torch.float32,
                          device=device) * self.kv_stride
        rel = (qs[:, None] - ks[None, :]) * self.magnitude
        dim = torch.arange(self.pe_dim // 2, dtype=torch.float32,
                           device=device)
        div = 1000.0 ** ((2.0 / self.pe_dim) * dim)
        ang = rel[..., None] / div
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        return fc(emb.to(fc.weight.dtype)).reshape(nq, nk, self.heads,
                                                   self.qk_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        at, heads, d = self.at, self.heads, self.qk_dim
        n, c, h, w = x.shape
        qs, ks = self.q_stride, self.kv_stride
        xq, xkv = x[:, :, ::qs, ::qs], x[:, :, ::ks, ::ks]
        hq, wq = xq.shape[2:]
        hk, wk = xkv.shape[2:]
        scale = 1.0 / math.sqrt(2.0 * d if at[0] and at[1] else d)

        def split(t: torch.Tensor, dim: int) -> torch.Tensor:
            # (n, heads * dim, y, x) -> (n, y, x, heads, dim)
            return t.permute(0, 2, 3, 1).reshape(n, t.shape[2], t.shape[3],
                                                 heads, dim)

        q = split(self.query_conv(xq), d) * scale if at[0] or at[1] else None
        k = split(self.key_conv(xkv), d) if at[0] or at[2] else None
        v = split(self.value_conv(xkv), self.v_dim)
        energy = x.new_zeros((n, heads, hq, wq, hk, wk), dtype=torch.float32)
        if at[0]:
            energy = energy + torch.einsum('nabhd,nyxhd->nhabyx', q.float(),
                                           k.float())
        if at[2]:
            bias = self.appr_bias.reshape(heads, d) * scale
            energy = energy + torch.einsum('hd,nyxhd->nhyx', bias.float(),
                                           k.float())[:, :, None, None]
        if at[1] or at[3]:
            pos_y = self._rel_embed(hq, hk, self.appr_geom_fc_y, x.device)
            pos_x = self._rel_embed(wq, wk, self.appr_geom_fc_x, x.device)
            if at[1]:
                e_y = torch.einsum('nabhd,ayhd->nhaby', q.float(),
                                   pos_y.float())
                e_x = torch.einsum('nabhd,bxhd->nhabx', q.float(),
                                   pos_x.float())
                energy = energy + e_y[..., :, None] + e_x[..., None, :]
            if at[3]:
                bias = (self.geom_bias.reshape(heads, d) * scale).float()
                g_y = torch.einsum('hd,ayhd->hay', bias, pos_y.float())
                g_x = torch.einsum('hd,bxhd->hbx', bias, pos_x.float())
                energy = (energy + g_y[None, :, :, None, :, None] +
                          g_x[None, :, None, :, None, :])
        if self.spatial_range >= 0:
            dev = x.device
            yq = torch.arange(hq, device=dev)[:, None, None, None] * qs
            xq_i = torch.arange(wq, device=dev)[None, :, None, None] * qs
            yk = torch.arange(hk, device=dev)[None, None, :, None] * ks
            xk_i = torch.arange(wk, device=dev)[None, None, None, :] * ks
            near = (((yq - yk).abs() <= self.spatial_range) &
                    ((xq_i - xk_i).abs() <= self.spatial_range))
            energy = torch.where(near, energy, energy.new_tensor(-1e18))
        attn = torch.softmax(energy.reshape(n, heads, hq, wq, hk * wk),
                             dim=-1).reshape(energy.shape)
        out = torch.einsum('nhabyx,nyxhd->nabhd', attn, v.float())
        out = out.reshape(n, hq, wq, heads * self.v_dim).to(x.dtype)
        out = self.proj_conv(out.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
        if qs > 1:
            out = jax_nearest_resize(out, h, w)
        return x + out


PLUGINS = {'ContextBlock': ContextBlock,
           'GeneralizedAttention': GeneralizedAttention}


def build_plugin(cfg: dict, in_channels: int) -> nn.Module:
    """The plugin of ``cfg`` (``type`` and the module's keys) over
    ``in_channels``; a key the JAX module has no field for is refused
    (ROADMAP.md queue 3, 3w)."""
    cfg = dict(cfg)
    t = cfg.pop('type')
    if t not in PLUGINS:
        raise NotImplementedError(f'backbone plugin {t} is not ported (the '
                                  'JAX package has ContextBlock and '
                                  'GeneralizedAttention)')
    fields = set(inspect.signature(PLUGINS[t]).parameters) - {'in_channels'}
    extra = sorted(set(cfg) - fields)
    if extra:
        raise NotImplementedError(f'{t} keys {extra} are not ported '
                                  '(ROADMAP.md queue 3, 3w: the JAX package '
                                  'has no field for them)')
    return PLUGINS[t](in_channels, **cfg)
