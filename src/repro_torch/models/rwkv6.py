"""RWKV6 "Finch" block: data-dependent per-channel decay.

Counterpart of ``repro.models.rwkv6``.  Time mixing (per head, K = V = head
dim):

    wkv_t = S_{t-1} + diag(u) k_t v_t^T          (bonus on the current token)
    out_t = r_t . wkv_t
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T        (w_t = exp(-exp(wlog_t)))

with w_t data-dependent via a low-rank projection (Finch).  Channel mixing is
the standard RWKV squared-relu MLP.  Token shift (mixing with the previous
token) is a causal roll.

The recurrence of more than one token goes through the port's chunked WKV
kernel (``kernels.wkv``), with the per-head bonus and the state carried in
(zeros in a forward or on an empty cache).  The JAX RWKV6-1.6B config scans
stepwise (``rwkv_chunk = 0``); the chunked kernel computes the same
recurrence in another order.  One token (a decode step) takes the one-step
recurrence.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.wkv import wkv
from ..kernels.wkv.kernel import CHUNKS
from ..obs.trace import MIXER_RANGE, span
from .layers import layernorm, rmsnorm
from .params import ParamDef
from .shardctx import constrain, is_dtensor, kernel_placements, merge_heads, on_mesh, shard_local, unflatten

DECAY_LORA = 64
# S is padded to a multiple of the shortest compiled chunk, the one
# select_chunk picks, with r = k = v = 0 and wlog = 0: decay 1 and nothing
# injected, so the output rows kept and the final state are exact
WKV_PAD = min(CHUNKS)


def rwkv6_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "tm": {
            "mu_r": ParamDef((d,), (None,), "zeros"),
            "mu_k": ParamDef((d,), (None,), "zeros"),
            "mu_v": ParamDef((d,), (None,), "zeros"),
            "mu_g": ParamDef((d,), (None,), "zeros"),
            "mu_w": ParamDef((d,), (None,), "zeros"),
            "wr": ParamDef((d, d), ("fsdp", "tp")),
            "wk": ParamDef((d, d), ("fsdp", "tp")),
            "wv": ParamDef((d, d), ("fsdp", "tp")),
            "wg": ParamDef((d, d), ("fsdp", "tp")),
            "wo": ParamDef((d, d), ("tp", "fsdp")),
            "w_lora_a": ParamDef((d, DECAY_LORA), ("fsdp", None)),
            "w_lora_b": ParamDef((DECAY_LORA, d), (None, "tp")),
            "w_base": ParamDef((d,), ("tp",), "zeros"),
            # nonzero bonus init: keeps the first-token wkv output away from zero
            "u_bonus": ParamDef((d,), ("tp",), "normal", 8.0),
            "ln_scale": ParamDef((d,), (None,), "ones"),
        },
        "cm": {
            "mu_k": ParamDef((d,), (None,), "zeros"),
            "w_in": ParamDef((d, cfg.d_ff), ("fsdp", "tp")),
            "w_out": ParamDef((cfg.d_ff, d), ("tp", "fsdp")),
        },
        "ln1": ParamDef((d,), (None,), "ones"),
        "ln2": ParamDef((d,), (None,), "ones"),
    }


def _token_shift(x, prev=None):
    """x_{t-1} per position; ``prev`` (B, 1, d) carries across decode steps."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv_heads(r, k, v, wlog, u, s0):
    """r, k, v, wlog: (B, S, H, K) f32; u: (H, K); s0: (B, H, K, K).

    Returns (out (B, S, H, K), s_final (B, H, K, K)).  S > 1 runs the
    chunked kernel on rows ``b H + h`` with S padded to a multiple of
    ``WKV_PAD``; S = 1 is one step of the recurrence.

    DTensors go to the kernel as their local shards, split before the
    (B, H) rows are flattened: the batch over the dp axes and the heads
    over tp, each where it divides."""
    if is_dtensor(r):
        B, _, H, _ = r.shape
        mesh = r.device_mesh
        x4 = kernel_placements(mesh, 4, (0, B), (H,), 2)  # (B, S, H, K), and s (B, H, K, K)
        st = kernel_placements(mesh, 4, (0, B), (H,), 1)
        hu = kernel_placements(mesh, 2, None, (H,), 0)  # u (H, K)
        return shard_local(_wkv_heads, (r, k, v, wlog, u, s0), (x4, x4, x4, x4, hu, st), (x4, st))
    return _wkv_heads(r, k, v, wlog, u, s0)


def _wkv_heads(r, k, v, wlog, u, s0):
    B, S, H, K = r.shape
    if S == 1:
        r_t, k_t, v_t, w_t = (a[:, 0] for a in (r, k, v, wlog))  # (B, H, K)
        kv = k_t[..., :, None] * v_t[..., None, :]
        out = torch.einsum("bhk,bhkv->bhv", r_t, s0 + u[None, :, :, None] * kv)
        return out[:, None], torch.exp(w_t)[..., None] * s0 + kv
    pad = -S % WKV_PAD

    def rows(a):  # (B, S, H, K) -> (B H, S + pad, K), zeros after S
        return F.pad(a.permute(0, 2, 1, 3), (0, 0, 0, pad)).reshape(B * H, S + pad, K).contiguous()

    out, s = wkv(rows(r), rows(k), rows(v), rows(wlog), u.contiguous(),
                 s0=s0.reshape(B * H, K, K).contiguous())
    return out.reshape(B, H, S + pad, K)[:, :, :S].permute(0, 2, 1, 3), s.reshape(B, H, K, K)


def rwkv6_block(cfg: ArchConfig, p: Mapping, x, state: Optional[dict] = None):
    """x: (B,S,d). state: {"shift_tm","shift_cm": (B,1,d), "s": (B,H,K,K)}.

    Returns (out, new_state)."""
    B, S, d = x.shape
    K = cfg.rwkv_head_dim
    H = d // K
    cdt = x.dtype
    tm, cm = p["tm"], p["cm"]

    with span("model.mix"):
        xa = layernorm(x, p["ln1"])
        prev_tm = state["shift_tm"] if state is not None else None
        xs = _token_shift(xa, prev_tm)

        def mix(mu):
            return xa + (xs - xa) * mu.to(cdt)[None, None, :]

        r = unflatten(mix(tm["mu_r"]) @ tm["wr"].to(cdt), -1, (H, K))
        k = unflatten(mix(tm["mu_k"]) @ tm["wk"].to(cdt), -1, (H, K))
        v = unflatten(mix(tm["mu_v"]) @ tm["wv"].to(cdt), -1, (H, K))
        g = F.silu(mix(tm["mu_g"]) @ tm["wg"].to(cdt))
        wx = mix(tm["mu_w"]).float()
        # on a mesh, the LoRA's output laid out as the activations before w_base
        # joins it (a partial sum there cannot meet w_base's split on every
        # PyTorch version's DTensor)
        wlora = constrain(torch.tanh(wx @ tm["w_lora_a"].float()) @ tm["w_lora_b"].float(), ("dp", None, "tp"))
        # data-dependent decay: w = exp(-exp(w_base + lora)), clamped for stability
        wlog = -torch.exp(torch.clamp(tm["w_base"].float() + wlora, -8.0, 4.0))
        wlog = unflatten(wlog, -1, (H, K))
        u = unflatten(tm["u_bonus"].float(), -1, (H, K))
        s0 = (
            state["s"].float()
            if state is not None
            else on_mesh(torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device), x)
        )
        r, k, v = r.float(), k.float(), v.float()
        with span(MIXER_RANGE + "wkv"):
            out, s_final = wkv_heads(r, k, v, wlog, u, s0)
        out = merge_heads(out)
        out = rmsnorm(out.to(cdt), tm["ln_scale"]) * g
        y_tm = out @ tm["wo"].to(cdt)

        x2 = x + y_tm
    with span("model.ffn"):
        xb = layernorm(x2, p["ln2"])
        prev_cm = state["shift_cm"] if state is not None else None
        xs2 = _token_shift(xb, prev_cm)
        xk = xb + (xs2 - xb) * cm["mu_k"].to(cdt)[None, None, :]
        h = torch.square(F.relu(xk @ cm["w_in"].to(cdt)))
        y_cm = h @ cm["w_out"].to(cdt)
        new_state = {
            "shift_tm": xa[:, -1:, :],
            "shift_cm": xb[:, -1:, :],
            "s": s_final,
        }
        out = y_tm + y_cm
    return out, new_state
