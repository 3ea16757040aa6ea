"""Block-wise masked-diffusion decoding logic (LLaDA-style, §2.2-2.3).

The generation region starts fully masked. Tokens are decoded block by block
(semi-autoregressive); within a block the engine runs ``steps_per_block``
denoising steps, each committing the highest-confidence predictions among the
still-masked positions (low-confidence remasking). Host-side numpy, verbatim
from ``repro.core.diffusion`` so both packages commit the same positions.
"""
from __future__ import annotations

import numpy as np


def mask_token_id(vocab_size: int) -> int:
    """Reserve the last vocab id as [MASK]."""
    return vocab_size - 1


def commit_count(n_masked: int, steps_remaining: int) -> int:
    """Linear unmasking schedule: finish the block by the last step."""
    if steps_remaining <= 1:
        return n_masked
    return max(1, int(np.ceil(n_masked / steps_remaining)))


def commit_tokens(
    block_tokens: np.ndarray,   # [Sb] current block (mask_id on undecided)
    ids: np.ndarray,            # [Sb] predicted ids
    conf: np.ndarray,           # [Sb] prediction confidence
    n_commit: int,
    mask_id: int,
) -> np.ndarray:
    """Commit the n highest-confidence predictions at masked positions."""
    out = block_tokens.copy()
    masked = np.where(out == mask_id)[0]
    if masked.size == 0:
        return out
    n = min(n_commit, masked.size)
    order = masked[np.argsort(-conf[masked])][:n]
    out[order] = ids[order]
    # a model may legitimately predict [MASK]; fall back to id 0 so the
    # unmasking schedule always terminates.
    out[order] = np.where(out[order] == mask_id, 0, out[order])
    return out


def build_sequence(prompt: np.ndarray, gen_len: int, max_seq_len: int,
                   mask_id: int, pad_id: int = 0) -> np.ndarray:
    """[prompt | MASK*gen_len | pad] padded to max_seq_len."""
    total = len(prompt) + gen_len
    assert total <= max_seq_len, (total, max_seq_len)
    seq = np.full(max_seq_len, pad_id, np.int32)
    seq[: len(prompt)] = prompt
    seq[len(prompt): total] = mask_id
    return seq
