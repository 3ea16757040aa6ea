"""Segment-reset Mamba2 SSD scan over a token-packed stream.

Replaces ``repro/kernels/ssm_scan.py::ssm_segment_scan_call`` (Pallas). One
ragged ``[T]`` stream carries every Refresh request of an iteration;
``reset`` marks each request's first token and zeroes the recurrent state
there, so requests packed back to back never leak state into each other.
For every head h and channel p the state ``h_t[h, p, :]`` follows

    h_t = a_t · h_{t-1} + xdt[t, h, p] · B[t, :],   a_t = exp(dA[t, h])
    y[t, h, p] = C[t, :] · h_t

with ``a_t = 0`` at a reset. Request r's state is captured after flat row
``cap_rows[r]`` (``-1``: a zero state); no per-token ``[T, H, P, N]`` state
is ever stored. Returns ``(y [T, H, P], captured [R, H, P, N], final state
[H, P, N])``, all float32.

The plain version is the Pallas kernel's chunked SSD math on whole tensors
(intra-chunk quadratic term under the reset-count mask ``cnt[i] ==
cnt[j]``, chunk-to-chunk state carry, in-chunk captures); ``chunk`` is a
tiling choice that y and the captures do not depend on. The CUDA kernel
(``csrc/ssm_scan.cu``) computes the same chunked form on the tensor cores
(3xTF32) in its own chunks of 64 tokens, a ragged last one included, and
ignores ``chunk``: four launches (each chunk's C·Bᵀ, its end states, a pass
that carries the state over the chunks, each chunk's output and captures)
that count as one call.
The wrapper runs the plain version only for CPU tensors; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

SCAN = build.counter("ssm_segment_scan")
STATE_DIMS = (16, 32, 64, 128)     # state sizes the kernel takes
KERNEL_CHUNK = 64                  # tokens a chunk of csrc/ssm_scan.cu


def ssm_segment_scan_plain(xdt, dA, Bm, Cm, reset, cap_rows, chunk: int = 64):
    """xdt [T, H, P]; dA [T, H]; Bm/Cm [T, N]; reset [T] (1.0 at segment
    starts); cap_rows [R] int -> (y, captured, final state), float32."""
    T, H, P = xdt.shape
    N, R = Bm.shape[1], cap_rows.shape[0]
    if T % chunk:
        raise ValueError(f"chunk {chunk} does not divide T={T}")
    dev, f32 = xdt.device, torch.float32
    xdt, dA, Bm, Cm, reset = (t.to(f32) for t in (xdt, dA, Bm, Cm, reset))
    cap_rows = cap_rows.to(torch.int64)
    state = torch.zeros((H, P, N), dtype=f32, device=dev)
    cap = torch.zeros((R, H, P, N), dtype=f32, device=dev)
    y = torch.empty((T, H, P), dtype=f32, device=dev)
    ar = torch.arange(chunk, device=dev)
    tri = ar[:, None] >= ar[None, :]
    for i0 in range(0, T, chunk):
        x, a = xdt[i0: i0 + chunk], dA[i0: i0 + chunk]
        b, c = Bm[i0: i0 + chunk], Cm[i0: i0 + chunk]
        cs = torch.cumsum(a, 0)                                  # [c, H]
        cnt = torch.cumsum(reset[i0: i0 + chunk], 0)             # [c]
        # 1) intra-chunk term: (j -> i) decays exp(cs_i - cs_j), masked out
        # when a reset falls in (j, i]; the masked lanes may be inf before
        # the select, never after it
        run_ok = tri & (cnt[:, None] == cnt[None, :])
        dec = torch.where(run_ok[..., None],
                          torch.exp(cs[:, None, :] - cs[None, :, :]), 0.0)
        y_diag = torch.einsum("ij,ijh,jhp->ihp", c @ b.t(), dec, x)
        # 2) incoming state: token i sees it iff no reset falls in [0, i]
        csx = torch.where((cnt == 0)[:, None], torch.exp(cs), 0.0)
        y[i0: i0 + chunk] = y_diag + torch.einsum(
            "in,hpn->ihp", c, state) * csx[..., None]
        # 3) captures whose row lies in this chunk
        loc = cap_rows - i0
        in_ch = (loc >= 0) & (loc < chunk)
        loc_c = loc.clamp(0, chunk - 1)
        cs_at, cnt_at = cs[loc_c], cnt[loc_c]                    # [R, H], [R]
        wmask = (ar[None, :] <= loc_c[:, None]) & in_ch[:, None] \
            & (cnt[None, :] == cnt_at[:, None])
        w = torch.where(wmask[..., None],
                        torch.exp(cs_at[:, None, :] - cs[None, :, :]), 0.0)
        base = torch.where((in_ch & (cnt_at == 0))[:, None],
                           torch.exp(cs_at), 0.0)                # [R, H]
        cap += torch.einsum("rjh,jhp,jn->rhpn", w, x, b) \
            + base[..., None, None] * state[None]
        # 4) chunk-end state for the next chunk
        end = torch.where((cnt == cnt[-1])[:, None],
                          torch.exp(cs[-1][None, :] - cs), 0.0)  # [c, H]
        keep = torch.where(cnt[-1] == 0, torch.exp(cs[-1]), 0.0)
        state = state * keep[:, None, None] + torch.einsum(
            "jh,jhp,jn->hpn", end, x, b)
    return y, cap, state


def ssm_segment_scan_call(xdt, dA, Bm, Cm, reset, cap_rows, *,
                          chunk: int = 64):
    """The segment-reset scan (replaces the Pallas
    ``ssm_segment_scan_call``). float32 xdt [T, H, P], dA [T, H], Bm/Cm
    [T, N], reset [T]; int32 cap_rows [R]."""
    if xdt.device.type == "cpu":
        SCAN.plain_calls += 1
        return ssm_segment_scan_plain(xdt, dA, Bm, Cm, reset, cap_rows, chunk)
    name = SCAN.name
    build.require_cuda(name, xdt, dA, Bm, Cm, reset, cap_rows)
    T, H, P = xdt.shape
    N, R = Bm.shape[1], cap_rows.shape[0]
    if any(t.dtype != torch.float32 for t in (xdt, dA, Bm, Cm, reset)):
        raise TypeError(f"{name}: xdt/dA/B/C/reset must be float32")
    if cap_rows.dtype != torch.int32:
        raise TypeError(f"{name}: cap_rows must be int32")
    if dA.shape != (T, H) or Bm.shape != (T, N) or Cm.shape != (T, N) or \
            reset.shape != (T,) or cap_rows.dim() != 1 or T == 0:
        raise ValueError(f"{name}: bad shapes xdt{tuple(xdt.shape)} "
                         f"dA{tuple(dA.shape)} B{tuple(Bm.shape)} "
                         f"C{tuple(Cm.shape)} reset{tuple(reset.shape)}")
    if N not in STATE_DIMS or P % 8:
        raise ValueError(f"{name}: state size {N} not in {STATE_DIMS} or "
                         f"head dim {P} not a multiple of 8")
    if any(t.data_ptr() % 16 for t in (xdt, Bm, Cm)):
        raise ValueError(f"{name}: xdt, B and C must be 16-byte aligned "
                         f"(the kernel copies them 16 bytes at a time)")
    dev = xdt.device
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((T, H, P), **f32)
    cap = torch.empty((R, H, P, N), **f32)
    final = torch.empty((H, P, N), **f32)
    n_chunks = -(-T // KERNEL_CHUNK)
    # the kernel's scratch: chunk-end then incoming states, carries, C·B^T
    states = torch.empty((n_chunks, H, P, N), **f32)
    carry = torch.empty((n_chunks, H), **f32)
    gram = torch.empty((n_chunks, KERNEL_CHUNK, KERNEL_CHUNK), **f32)
    code = build.library().repro_ssm_segment_scan(
        xdt.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        reset.data_ptr(), cap_rows.data_ptr(), y.data_ptr(), cap.data_ptr(),
        final.data_ptr(), states.data_ptr(), carry.data_ptr(), gram.data_ptr(),
        T, H, P, N, R,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, name)
    SCAN.launches += 1
    return y, cap, final
