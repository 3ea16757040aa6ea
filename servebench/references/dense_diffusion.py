"""Plain reference of a dense bidirectional diffusion transformer served by
Refresh and Reuse steps, in float32 PyTorch. It imports nothing of the
program and takes from it nothing but the tokens it served.

The model (Llama-style, bidirectional, a mask-predict head): token
embedding; per layer ``x += Wo·attn(RoPE(Wq·n1(x)), RoPE(Wk·n1(x)),
Wv·n1(x))`` and ``x += W_down·(silu(W_gate·n2(x)) * W_up·n2(x))``, with
RMSNorm ``n(x) = x / rms(x) · (1 + scale)``, half-split RoPE, an optional
QKV bias and grouped KV heads (query head ``h`` reads KV head ``h // G``);
a final RMSNorm and an untied head.

How a request is served, step by step (block ``b`` of ``Sb`` tokens,
``steps_per_block`` steps a block, one Refresh every ``refresh_interval``
steps from the block's first):

* **Refresh** runs the whole sequence (prompt, committed blocks, the
  active block and the masked blocks after it) with full bidirectional
  attention. Its logits at the active block's rows decide that step. At
  every layer it keeps, for each KV head, the ``retain`` positions outside
  the active block that score highest under eq. 6 of the paper: a key's
  score is the largest dot product of any of its group's query rows of the
  active block with it, max-pooled over ``kernel_size`` neighbours (ties:
  the lower position). Where no more than ``retain`` positions lie
  outside the block, all of them are kept.
* **Reuse** runs only the active block: at every layer its rows attend to
  that layer's keys and values which the block's last Refresh kept, and
  to the block's own.

:func:`hidden_at` replays the steps the program took from the sequences
it served and returns the reference's final-normed rows at the positions
asked for (every position still masked before each step), and
:class:`Head` their logits.

A control computes every linear layer and the head from inputs rounded to
a lower precision (``precision``): bfloat16, or float8 e4m3 with a scale a
row of activations and a column of weights; attention and the norms stay
float32.

The harness also reads two declarations of the family from here:
:func:`layout`, every leaf the reference reads with the law it is drawn
by, and :func:`token_params`, what one Refresh or Reuse token multiplies.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def layout(model: dict) -> List[Tuple[str, tuple, float]]:
    """(path, shape, std) of every leaf, in draw order: ``embed/table [V,
    D]``, ``embed/lm_head [D, V]``, ``final_norm [D]`` and under
    ``stack/``: ``attn_norm``, ``mlp_norm [L, D]``; ``wq [L, D, H, dh]``;
    ``wk``, ``wv [L, D, K, dh]``; ``wo [L, H, dh, D]``; ``bq [L, H, dh]``,
    ``bk``, ``bv [L, K, dh]`` with a QKV bias; ``w_gate``, ``w_up [L, D,
    F]``; ``w_down [L, F, D]``. Matrices and biases are N(0, 0.02); norm
    scales (the ``1 + scale`` convention) are drawn too, N(0, 0.05), so
    the check sees every leaf."""
    L, D, F, V = (model["n_layers"], model["d_model"], model["d_ff"],
                  model["vocab_size"])
    H, K = model["n_heads"], model["n_kv_heads"]
    dh = model.get("head_dim") or D // H
    out = [("embed/table", (V, D), 0.02),
           ("embed/lm_head", (D, V), 0.02),
           ("final_norm", (D,), 0.05),
           ("stack/attn_norm", (L, D), 0.05),
           ("stack/mlp_norm", (L, D), 0.05),
           ("stack/wq", (L, D, H, dh), 0.02),
           ("stack/wk", (L, D, K, dh), 0.02),
           ("stack/wv", (L, D, K, dh), 0.02),
           ("stack/wo", (L, H, dh, D), 0.02)]
    if model.get("qkv_bias"):
        out += [("stack/bq", (L, H, dh), 0.02),
                ("stack/bk", (L, K, dh), 0.02),
                ("stack/bv", (L, K, dh), 0.02)]
    out += [("stack/w_gate", (L, D, F), 0.02),
            ("stack/w_up", (L, D, F), 0.02),
            ("stack/w_down", (L, F, D), 0.02)]
    return out


def token_params(model: dict) -> int:
    """Parameters a token's pass through the layer stack multiplies: the
    attention projections (and their biases), the gated MLP and the two
    norms of every layer, and the final norm. The embedding lookup is no
    product and the head is counted apart (``flops.logit_flops``)."""
    L, D, F = model["n_layers"], model["d_model"], model["d_ff"]
    H, K = model["n_heads"], model["n_kv_heads"]
    dh = model.get("head_dim") or D // H
    attn = D * H * dh + 2 * D * K * dh + H * dh * D
    if model.get("qkv_bias"):
        attn += H * dh + 2 * K * dh
    return L * (attn + 3 * D * F + 2 * D) + D


@dataclass
class Steps:
    """The steps of one served request that the reference replays.

    ``tokens[i]`` is the whole sequence before step ``i`` (length
    ``prompt + gen``, masks where nothing is committed yet);
    ``block_start[i]`` the active block's first position; ``refresh[i]``
    whether step ``i`` is a Refresh; ``cache_of[i]`` the step whose
    Refresh a Reuse step reads; ``rows`` the (step, position) pairs whose
    rows are returned."""
    tokens: np.ndarray          # [n, L] int64
    block_start: np.ndarray     # [n]
    refresh: np.ndarray         # [n] bool
    cache_of: np.ndarray        # [n]
    rows: List[tuple]


def _round(t: torch.Tensor, dim: int, precision: str) -> torch.Tensor:
    """``t`` rounded to ``precision`` and back to float32."""
    if precision == "float32":
        return t
    if precision == "bfloat16":
        return t.to(torch.bfloat16).float()
    if precision == "float8_e4m3fn":
        s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
        return (t / s).to(torch.float8_e4m3fn).float() * s
    raise ValueError(precision)


class _Linear:
    def __init__(self, precision: str, rows: int = 8192):
        self.precision = precision
        self.rows = rows

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """[in, out] float32, each column rounded in the control."""
        return _round(w.float(), 0, self.precision)

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        out = torch.cat([_round(x[i: i + self.rows], -1, self.precision) @ w
                         for i in range(0, x.shape[0], self.rows)])
        return out.reshape(shape[:-1] + (w.shape[1],))


def _norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def _rope_tables(pos: torch.Tensor, dh: int, theta: float):
    half = dh // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                        device=pos.device) / half))
    ang = pos.double()[..., None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rope(x, cos, sin):
    """x [..., S, heads, dh]; cos/sin [..., S, half]."""
    half = x.shape[-1] // 2
    c, s = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _layer(stack: Dict[str, torch.Tensor], l: int, lin: _Linear, m: dict):
    D = m["d_model"]
    w = {n: stack[n][l] for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                  "w_down")}
    out = {n: lin.weight(t.reshape(D, -1) if n in ("wq", "wk", "wv")
                         else t.reshape(-1, D) if n == "wo" else t)
           for n, t in w.items()}
    out["attn_norm"] = stack["attn_norm"][l]
    out["mlp_norm"] = stack["mlp_norm"][l]
    for b in ("bq", "bk", "bv"):
        if b in stack:
            out[b] = stack[b][l].float().reshape(-1)
    return out


def _qkv(x, w, lin, m, cos, sin):
    H, K = m["n_heads"], m["n_kv_heads"]
    dh = m.get("head_dim") or m["d_model"] // H
    h = _norm(x, w["attn_norm"], m["rms_eps"])
    q, k, v = lin(h, w["wq"]), lin(h, w["wk"]), lin(h, w["wv"])
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = q.reshape(x.shape[:-1] + (H, dh))
    k = k.reshape(x.shape[:-1] + (K, dh))
    v = v.reshape(x.shape[:-1] + (K, dh))
    return _rope(q, cos, sin), _rope(k, cos, sin), v


def _mlp_out(x, attn, w, lin, m):
    x = x + lin(attn.flatten(-2), w["wo"])
    h = _norm(x, w["mlp_norm"], m["rms_eps"])
    return x + lin(F.silu(lin(h, w["w_gate"])) * lin(h, w["w_up"]),
                   w["w_down"])


def _full_attention(q, k, v, chunk: int = 2):
    """Bidirectional attention over whole sequences. q [R, L, H, dh];
    k/v [R, L, K, dh]."""
    R, L, H, dh = q.shape
    K = k.shape[2]
    out = []
    for r in range(0, R, chunk):
        qg = q[r: r + chunk].reshape(-1, L, K, H // K, dh)
        z = torch.einsum("rqkgd,rlkd->rkgql", qg, k[r: r + chunk]) * dh ** -0.5
        p = torch.softmax(z, dim=-1)
        out.append(torch.einsum("rkgql,rlkd->rqkgd", p, v[r: r + chunk])
                   .reshape(-1, L, H, dh))
    return torch.cat(out)


def _kept(q, k, block_start, Sb: int, retain: int, kernel: int):
    """[R, K, L] bool: the positions each KV head keeps (eq. 6)."""
    R, L, H, dh = q.shape
    K = k.shape[2]
    ar = torch.arange(L, device=q.device)
    bs = torch.as_tensor(block_start, device=q.device)[:, None]
    in_block = (ar[None] >= bs) & (ar[None] < bs + Sb)              # [R, L]
    if L - Sb <= retain:
        return (~in_block)[:, None, :].expand(R, K, L).clone()
    rows = bs + torch.arange(Sb, device=q.device)[None]              # [R, Sb]
    qb = torch.gather(q, 1, rows[:, :, None, None].expand(R, Sb, H, dh))
    qg = qb.reshape(R, Sb, K, H // K, dh)
    raw = torch.einsum("rskgd,rlkd->rkgsl", qg, k).amax(dim=(2, 3))
    pooled = F.max_pool1d(raw, kernel, stride=1, padding=kernel // 2)
    score = pooled.masked_fill(in_block[:, None, :], float("-inf"))
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    keep = torch.zeros((R, K, L), dtype=torch.bool, device=q.device)
    return keep.scatter_(2, order[..., :retain], True)


def _reuse_attention(qb, kb, vb, k, v, keep, ci, chunk: int = 16):
    """The block's rows against [kept cache ; block]. qb [U, Sb, H, dh];
    kb/vb [U, Sb, K, dh]; k/v [R, L, K, dh] and keep [R, K, L] of the
    Refresh steps; ``ci`` [U] the Refresh each Reuse step reads."""
    U, Sb, H, dh = qb.shape
    K = kb.shape[2]
    Lc = k.shape[1]
    out = []
    for u in range(0, U, chunk):
        c = ci[u: u + chunk]
        qg = qb[u: u + chunk].reshape(-1, Sb, K, H // K, dh)
        zc = torch.einsum("uskgd,ulkd->ukgsl", qg, k[c])
        zc = zc.masked_fill(~keep[c][:, :, None, None, :], float("-inf"))
        zb = torch.einsum("uskgd,utkd->ukgst", qg, kb[u: u + chunk])
        p = torch.softmax(torch.cat([zc, zb], dim=-1) * dh ** -0.5, dim=-1)
        o = torch.einsum("ukgsl,ulkd->uskgd", p[..., :Lc], v[c]) \
            + torch.einsum("ukgst,utkd->uskgd", p[..., Lc:], vb[u: u + chunk])
        out.append(o.reshape(-1, Sb, H, dh))
    return torch.cat(out)


def _replay(W, m: dict, geom: dict, st: Steps, lin: _Linear, dev):
    """The final-normed hidden rows [len(st.rows), D] of one request."""
    Sb = geom["block_size"]
    H = m["n_heads"]
    dh = m.get("head_dim") or m["d_model"] // H
    table = W["embed"]["table"]
    tok = torch.as_tensor(st.tokens, device=dev)
    ref = np.nonzero(st.refresh)[0]
    reu = np.nonzero(~st.refresh)[0]
    slot = {int(s): j for j, s in enumerate(ref)}
    L = tok.shape[1]
    x = table[tok[torch.as_tensor(ref, device=dev)]].float()         # [R, L, D]
    cos, sin = _rope_tables(torch.arange(L, device=dev), dh, m["rope_theta"])
    bpos = torch.as_tensor(st.block_start[reu], device=dev)[:, None] + \
        torch.arange(Sb, device=dev)[None]                           # [U, Sb]
    xb = table[torch.gather(tok[torch.as_tensor(reu, device=dev)], 1,
                            bpos)].float()                       # [U, Sb, D]
    bcos, bsin = _rope_tables(bpos, dh, m["rope_theta"])
    ci = torch.as_tensor([slot[int(st.cache_of[s])] for s in reu],
                         dtype=torch.long, device=dev)
    for l in range(m["n_layers"]):
        w = _layer(W["stack"], l, lin, m)
        q, k, v = _qkv(x, w, lin, m, cos, sin)
        keep = _kept(q, k, st.block_start[ref], Sb, geom["retain"],
                     geom["kernel_size"])
        x = _mlp_out(x, _full_attention(q, k, v), w, lin, m)
        if len(reu):
            qb, kb, vb = _qkv(xb, w, lin, m, bcos, bsin)
            xb = _mlp_out(xb, _reuse_attention(qb, kb, vb, k, v, keep, ci),
                          w, lin, m)
        del q, k, v, keep
    fn = W["final_norm"]
    rows = []
    for step, p in st.rows:
        if st.refresh[step]:
            rows.append(x[slot[step], p])
        else:
            j = int(np.searchsorted(reu, step))
            rows.append(xb[j, p - int(st.block_start[step])])
    return _norm(torch.stack(rows), fn, m["rms_eps"])


@contextmanager
def exact():
    """float32 matmuls as float32 (TF32 off), no autograd."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]


def hidden_at(W, model: dict, geom: dict, requests: List[Steps],
              precision: str = "float32") -> torch.Tensor:
    """The reference's final-normed rows [Σ rows, D], float32, at every
    (step, position) of every request's ``rows``, in order. ``geom``
    holds ``block_size``, ``retain`` and ``kernel_size``."""
    with exact():
        dev = W["embed"]["table"].device
        lin = _Linear(precision)
        return torch.cat([_replay(W, model, geom, st, lin, dev)
                          for st in requests])


class Head:
    """The head at ``precision``: logits [n, V], float32, of final-normed
    rows."""

    def __init__(self, W, precision: str = "float32"):
        self.lin = _Linear(precision)
        with exact():
            self.w = self.lin.weight(W["embed"]["lm_head"])

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        with exact():
            return self.lin(h, self.w)
